"""InceptionV3's blocks (``vision/models/inception.py`` ``_InceptionA``
and ``_InceptionB``; C to E are ``test_torch_inception_blocks_cde.py``'s)
against the reference's on shared weights, in
training mode on a seeded batch of two small maps: the output and
BatchNorm's running statistics within 1e-5 (``hold_block`` of
``test_torch_vision_blocks.py``). Forward only: their channel counts
are fixed and wide, and each one's backward in the reference compiles
for ~10 s; the gradients through the same layers and concatenations
are held in GoogLeNet's ``_Inception`` there."""
import pytest

from test_torch_vision_blocks import hold_block
from torch_vision_common import port_on_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_on_cpu")

#: (module, block, constructor arguments, input channels, map size)
FORWARD_BLOCKS = [
    ("inception", "_InceptionA", (8, 4), 8, 5),
    ("inception", "_InceptionB", (8,), 8, 5),
]


@pytest.mark.parametrize("module,name,args,cin,size", FORWARD_BLOCKS,
                         ids=[b[1] for b in FORWARD_BLOCKS])
def test_inception_v3_block_train_forward(module, name, args, cin, size):
    hold_block(module, name, args, cin, size, grads=False)
