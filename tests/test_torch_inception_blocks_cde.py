"""InceptionV3's ``_InceptionC``, ``_InceptionD`` and ``_InceptionE``
against the reference's on shared weights, forward in training mode:
the output and BatchNorm's running statistics within 1e-5, as
``test_torch_inception_blocks.py`` holds A and B."""
import pytest

from test_torch_vision_blocks import hold_block
from torch_vision_common import port_on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")

#: (module, block, constructor arguments, input channels, map size)
FORWARD_BLOCKS = [
    ("inception", "_InceptionC", (8, 4), 8, 3),
    ("inception", "_InceptionD", (8,), 8, 5),
    ("inception", "_InceptionE", (8,), 8, 3),
]


@pytest.mark.parametrize("module,name,args,cin,size", FORWARD_BLOCKS,
                         ids=[b[1] for b in FORWARD_BLOCKS])
def test_inception_v3_block_train_forward(module, name, args, cin, size):
    hold_block(module, name, args, cin, size, grads=False)
