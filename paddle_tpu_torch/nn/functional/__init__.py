"""``paddle.nn.functional`` (port of ``paddle_tpu/nn/functional/``): the
activation, common (linear, convolution, pooling, dropout, resizing,
attention, ...), norm, loss and extras modules, flat."""
from . import activation, common, extras, loss, norm
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .common import _chunked_bwd, _chunked_fwd  # noqa: F401
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
