"""The flat op namespace (``paddle_tpu_torch.tensor``, and the package's
top level): the creation, math, manipulation and logic ops and the
``linalg`` module, as the reference's ``paddle_tpu/ops/__init__.py``
gathers them. The kernel wrappers (``flash_attention``,
``paged_attention``, ...) and ``fused`` are modules of this package
beside them."""
from . import creation, inplace, linalg, logic, manipulation, math
from .creation import *  # noqa: F401,F403
from .inplace import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403

__all__ = (creation.__all__ + math.__all__ + manipulation.__all__
           + logic.__all__ + inplace.__all__ + ["linalg"])
