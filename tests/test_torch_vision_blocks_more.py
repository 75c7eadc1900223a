"""ShuffleNetV2's, DenseNet's and GoogLeNet's building blocks and the
squeeze-excite (``vision/models/{extras,inception}.py``) against the
reference's on shared weights, by ``hold_block`` of
``test_torch_vision_blocks.py`` (training mode: the output, BatchNorm's
running statistics and every gradient, C42's rule where a gradient
cancels)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import extras as jextras

from paddle_tpu_torch.vision.models import extras as textras

from test_torch_vision_blocks import hold_block
from torch_vision_common import (TOL, err, model_pair, npy,  # noqa: F401
                                 port_on_cpu)

pytestmark = pytest.mark.usefixtures("port_on_cpu")

#: (module, block, constructor arguments, input channels, map size)
BLOCKS = [
    ("extras", "_ShuffleUnit", (8, 8, 1), 8, 6),
    ("extras", "_ShuffleUnit", (8, 16, 2), 8, 6),
    ("extras", "_DenseLayer", (8, 4, 2), 8, 5),
    ("inception", "_Inception", (8, 4, 4, 6, 2, 4, 4), 8, 5),
]


@pytest.mark.parametrize("module,name,args,cin,size", BLOCKS,
                         ids=[f"{b[1]}{b[2]}" for b in BLOCKS])
def test_block_train_forward_and_grads(module, name, args, cin, size):
    hold_block(module, name, args, cin, size, grads=True)


def test_squeeze_excite():
    jb, tb = model_pair(lambda: jextras._SE(16), lambda: textras._SE(16))
    x = np.random.default_rng(0).standard_normal((2, 16, 4, 4)).astype(
        np.float32)
    assert err(npy(tb(torch.from_numpy(x))),
               npy(jb(paddle.to_tensor(x)))) <= TOL
