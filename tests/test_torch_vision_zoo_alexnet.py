"""AlexNet (``paddle_tpu_torch/vision/models/extras.py``) whole against
the reference's at 64 x 64, the smallest its strides leave a pixel of:
``hold_step`` of ``test_torch_vision_zoo.py`` (training mode, dropout
off, the output and every gradient within 1e-5 of each tensor's largest
magnitude). A file of its own: the reference's eager ops take ~23 s to
compile for it."""
import pytest

from test_torch_vision_zoo import hold_step
from torch_vision_common import port_on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")


@pytest.mark.parametrize("name,size,channels,kw", [
    ("alexnet", 64, 3, dict(num_classes=10))])
def test_whole_model_train_step(name, size, channels, kw):
    hold_step(name, size, channels, **kw)
