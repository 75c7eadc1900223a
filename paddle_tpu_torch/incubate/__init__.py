"""``paddle.incubate`` (port of ``paddle_tpu/incubate/``). Ported so far:
``distributed.models.moe``, the mixture-of-experts layer and its GShard
dispatch. The fused layers, ``asp``, ``autograd`` and ``optimizer`` are
not ported yet."""
from . import distributed  # noqa: F401
