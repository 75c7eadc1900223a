"""``paddle.incubate.distributed``: the MoE models (``models.moe``)."""
from . import models  # noqa: F401
