"""The port's vision zoo block by block against the reference's: each
building block of MobileNet V2 / V3, SqueezeNet, ShuffleNetV2,
DenseNet, GoogLeNet and InceptionV3 (``vision/models/{mobilenet,extras,
inception}.py``) on shared weights, in training mode on a seeded batch
of two small maps: the output, BatchNorm's running statistics and the
gradients of the input and of every parameter for ``sum(out * cot)``,
within 1e-5 of each tensor's largest magnitude. A BatchNorm whose
output feeds another through a linear op has a cancelling weight and
bias gradient (measured: 1e-3 and 1e-6 of the block's largest gradient,
the packages 2.5e-3 and 0.76 of it apart): those are held by ROADMAP
C42, the port's distance from an fp64 run at most 8 times the
reference's. A running mean is held to 1e-5 of its layer's running
standard deviation too: the mean of a BatchNorm fed by a bias-free 1 x 1
conv of a BatchNorm is zero by construction and carries roundoff alone
(measured ~1e-9 on both sides). Here MobileNet V2 / V3's and
SqueezeNet's blocks; ShuffleNetV2's, DenseNet's, GoogLeNet's and the
squeeze-excite are ``test_torch_vision_blocks_more.py``'s, InceptionV3's
``test_torch_inception_blocks.py``'s and
``test_torch_inception_blocks_cde.py``'s, the whole models
``test_torch_vision_zoo_full.py``'s (marked ``slow``: the reference's
eager ops compile one by one)."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import extras as jextras
from paddle_tpu.vision.models import inception as jinception
from paddle_tpu.vision.models import mobilenet as jmobilenet

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision.models import extras as textras
from paddle_tpu_torch.vision.models import inception as tinception
from paddle_tpu_torch.vision.models import mobilenet as tmobilenet

from torch_vision_common import (TOL, check_grads, err, grads_of,  # noqa: F401
                                 model_pair, npy, port_on_cpu)

pytestmark = pytest.mark.usefixtures("port_on_cpu")

#: (module, block, constructor arguments, input channels, map size)
BLOCKS = [
    ("mobilenet", "_InvertedResidual", (8, 8, 1, 6), 8, 6),
    ("mobilenet", "_InvertedResidual", (8, 16, 2, 1), 8, 6),
    ("extras", "_Fire", (8, 4, 6, 6), 8, 5),
    ("extras", "_InvertedResidualV3", (8, 24, 8, 5, 1, True, "hs"), 8, 6),
    ("extras", "_InvertedResidualV3", (8, 8, 16, 3, 2, False, "relu"), 8, 6),
]
MODULES = {"mobilenet": (jmobilenet, tmobilenet),
           "extras": (jextras, textras),
           "inception": (jinception, tinception)}


def hold_block(module, name, args, cin, size, grads):
    """The block in training mode on both packages: output, running
    statistics and, with ``grads``, the input's and every parameter's
    gradient of ``sum(out * cot)``."""
    jmod, tmod = MODULES[module]
    jb, tb = model_pair(lambda: getattr(jmod, name)(*args),
                        lambda: getattr(tmod, name)(*args))
    t64 = copy.deepcopy(tb).double()
    rng = np.random.default_rng(size + cin)
    x = rng.standard_normal((2, cin, size, size)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=not grads)
    tx = torch.from_numpy(x).requires_grad_(grads)
    jout, tout = jb(jx), tb(tx)
    assert err(npy(tout), npy(jout)) <= TOL
    if grads:
        cot = rng.standard_normal(tuple(tout.shape)).astype(np.float32)
        (jout * paddle.to_tensor(cot)).sum().backward()
        (tout * torch.from_numpy(cot)).sum().backward()
        (t64(torch.from_numpy(x).double())
         * torch.from_numpy(cot).double()).sum().backward()
        assert err(npy(tx.grad), npy(jx.grad)) <= TOL
        check_grads(jb, tb, exact=grads_of(t64))
    jstate = {k: np.asarray(v.numpy()) for k, v in jb.state_dict().items()}
    tstate = pt.jax_layout(tb)
    assert list(tstate) == list(jstate)
    for k in jstate:
        want = jstate[k]
        if k.endswith("._mean"):
            # a mean that is zero by construction (a BatchNorm after a
            # bias-free 1 x 1 conv of a BatchNorm) carries roundoff
            # alone: held relative to its layer's standard deviation
            want = np.stack([want, np.sqrt(jstate[k[:-5] + "_variance"])])
            assert np.abs(tstate[k] - jstate[k]).max() <= \
                TOL * np.abs(want).max(), k
        else:
            assert err(tstate[k], want) <= TOL, k


@pytest.mark.parametrize("module,name,args,cin,size", BLOCKS,
                         ids=[f"{b[1]}{b[2]}" for b in BLOCKS])
def test_block_train_forward_and_grads(module, name, args, cin, size):
    hold_block(module, name, args, cin, size, grads=True)

