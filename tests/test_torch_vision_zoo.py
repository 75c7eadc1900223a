"""The port's vision zoo (``paddle_tpu_torch/vision/models/{lenet,vgg,
extras}.py``) against the reference's: whole models at their smallest
inputs, the reference's weights carried in, in training mode, dropout
off (``p=0``) so both packages compute one function: the output and
every gradient of ``sum(out * cot)`` (seeded cotangents), within 1e-5
of each tensor's largest magnitude (none of these has a BatchNorm).
LeNet at 1 x 28 x 28, VGG-11's features at 32 x 32 (its five pools
leave 1 x 1, the adaptive pool spreads that to 7 x 7); AlexNet is
``test_torch_vision_zoo_alexnet.py``'s.

The reference's eager ops compile one by one: 10-40 s to build a model,
up to ~240 s for DenseNet-121's step. So the other models are held
block by block in ``test_torch_vision_blocks.py``, and every model
whole by ``test_torch_vision_zoo_full.py`` (marked ``slow``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch.vision import models as tmodels

from torch_vision_common import (TOL, check_grads, err, flat,  # noqa: F401
                                 model_pair, npy, port_on_cpu)

pytestmark = pytest.mark.usefixtures("port_on_cpu")


def no_dropout(m):
    for layer in m.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0


def hold_step(name, size, channels=3, tol=TOL, train=True, grads=True,
              **kw):
    """``name(**kw)`` in both packages on the same seeded batch of two:
    every output, and with ``grads`` every parameter's gradient of
    ``sum(out * cot)``. Returns the pair."""
    jm, tm = model_pair(lambda: getattr(jmodels, name)(**kw),
                        lambda: getattr(tmodels, name)(**kw))
    for m in (jm, tm):
        no_dropout(m)
        m.train() if train else m.eval()
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, channels, size, size)).astype(np.float32)
    jouts = flat(jm(paddle.to_tensor(x)))
    touts = flat(tm(torch.from_numpy(x)))
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert err(npy(t), npy(j)) <= tol
    if grads:
        cots = [rng.standard_normal(tuple(t.shape)).astype(np.float32)
                for t in touts]
        sum((j * paddle.to_tensor(c)).sum()
            for j, c in zip(jouts, cots)).backward()
        sum((t * torch.from_numpy(c)).sum()
            for t, c in zip(touts, cots)).backward()
        check_grads(jm, tm, tol)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    return jm, tm


@pytest.mark.parametrize("name,size,channels,kw", [
    ("LeNet", 28, 1, dict(num_classes=10)),
    ("vgg11", 32, 3, dict(num_classes=0))])
def test_whole_model_train_step(name, size, channels, kw):
    hold_step(name, size, channels, **kw)
