"""``paddle.vision`` (port of ``paddle_tpu/vision/``): ``models``. The
reference's datasets, transforms and ops are not ported yet."""
from . import models  # noqa: F401
