"""Every model of the port's vision zoo whole against the reference's, at
its smallest input, on the reference's weights, in eval mode: the
logits within 1e-5 of their largest magnitude, and the parameter names
in the reference's order; GoogLeNet also in training mode with its two
auxiliary heads (``(logits, out1, out2)``, dropout off; within
``E2E_TOL``). Marked
``slow``: the reference's eager ops compile one by one, 10-40 s to
build each model and ~60 s for DenseNet-121's forward (``pytest -m slow
tests/test_torch_vision_zoo_full.py``, ~15 min on one core). The tier's
own tests hold the same models by their blocks
(``test_torch_vision_blocks.py``, ``test_torch_inception_blocks.py``)
and LeNet, AlexNet and VGG-11 whole (``test_torch_vision_zoo.py``)."""
import pytest

from test_torch_vision_zoo import hold_step
from torch_vision_common import port_on_cpu  # noqa: F401

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("port_on_cpu")]

#: PR 18's bound for deep BatchNorm nets end to end
#: (``tests/test_torch_resnet.py``)
E2E_TOL = 2e-3

#: (constructor, input size, keyword arguments)
MODELS = [
    ("LeNet", 28, {}), ("vgg11", 32, {}), ("vgg13", 32, {}),
    ("vgg16", 32, dict(batch_norm=True)), ("vgg19", 32, {}),
    ("mobilenet_v1", 32, {}), ("mobilenet_v2", 32, {}),
    ("mobilenet_v3_small", 32, {}), ("mobilenet_v3_large", 32, {}),
    ("alexnet", 64, {}), ("squeezenet1_0", 32, {}),
    ("squeezenet1_1", 32, {}), ("shufflenet_v2_x1_0", 32, {}),
    ("densenet121", 32, {}), ("googlenet", 64, {}),
    ("inception_v3", 75, {})]


@pytest.mark.parametrize("name,size,kw", MODELS, ids=[m[0] for m in MODELS])
def test_whole_model_eval_forward(name, size, kw):
    hold_step(name, size, 1 if name == "LeNet" else 3, train=False,
              grads=False, num_classes=10, **kw)


def test_googlenet_train_aux_heads():
    """Training mode: BatchNorm normalizes the last stages' 2 x 2 maps
    over a batch of two, so the three heads are held end to end to PR
    18's ``E2E_TOL`` for deep BatchNorm nets (measured 1.8e-4)."""
    _, tm = hold_step("googlenet", 64, train=True, grads=False,
                      tol=E2E_TOL, num_classes=10)
    assert tm.training
