"""The port's remaining layers (``paddle_tpu_torch/nn/layers/extras.py``)
against the reference's (``paddle_tpu/nn/layers/extras.py``): each layer
on the same seeded inputs, its weights carried in where it has any, the
output and the gradients of the float inputs (and parameters) of
``sum(out * cot)`` within 1e-5 of each tensor's largest magnitude; the
indices of ``return_mask`` pooling equal. And the reference's ``nn``
exports: every name of ``paddle_tpu/nn/__init__.py`` is in the port's
``nn``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import nn as tnn

from torch_vision_common import (check_grads, model_pair,  # noqa: F401
                                 port_on_cpu, run_both)

pytestmark = pytest.mark.usefixtures("port_on_cpu")


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    x3 = _f(rng, 2, 3, 6, 6, 6)
    x1 = _f(rng, 2, 3, 8)
    x2 = _f(rng, 2, 3, 6, 6)
    _, idx1 = JF.max_pool1d(paddle.to_tensor(x1), 2, return_mask=True)
    _, idx2 = JF.max_pool2d(paddle.to_tensor(x2), 2, return_mask=True)
    _, idx3 = JF.max_pool3d(paddle.to_tensor(x3), 2, return_mask=True)
    p1 = _f(rng, 2, 3, 4)
    p2 = _f(rng, 2, 3, 3, 3)
    p3 = _f(rng, 2, 3, 3, 3, 3)
    a, b, c = _f(rng, 4, 5), _f(rng, 4, 5), _f(rng, 4, 5)
    logits = _f(rng, 4, 6)
    t, batch, classes = 12, 2, 5
    return [
        # name, constructor args, inputs (dict), differentiable inputs
        ("MaxPool3D", (2,), {"x": x3}, ("x",)),
        ("MaxPool3D", (3, 2, 1, True), {"x": x3}, ("x",)),
        ("AvgPool3D", (3, 2, 1), {"x": x3}, ("x",)),
        ("AvgPool3D", (2, None, 0, False, False), {"x": x3}, ("x",)),
        ("AdaptiveAvgPool3D", (3,), {"x": x3}, ("x",)),
        ("AdaptiveMaxPool1D", (4,), {"x": x1}, ("x",)),
        ("AdaptiveMaxPool1D", (2, True), {"x": x1}, ("x",)),
        ("MaxUnPool1D", (2,), {"x": p1, "i": idx1.numpy()}, ("x",)),
        ("MaxUnPool2D", (2,), {"x": p2, "i": idx2.numpy()}, ("x",)),
        ("MaxUnPool3D", (2,), {"x": p3, "i": idx3.numpy()}, ("x",)),
        ("Unflatten", (1, [3, 1]), {"x": x2}, ("x",)),
        ("Fold", ([4, 5], 2), {"x": _f(rng, 2, 12, 12)}, ("x",)),
        ("PixelUnshuffle", (2,), {"x": x2}, ("x",)),
        ("PairwiseDistance", (), {"x": a, "y": b}, ("x", "y")),
        ("PairwiseDistance", (1.0, 1e-6, True), {"x": a, "y": b},
         ("x", "y")),
        ("SiLU", (), {"x": x2}, ("x",)),
        ("Softmax2D", (), {"x": x2}, ("x",)),
        ("SoftMarginLoss", (), {"x": a, "y": np.sign(b)}, ("x",)),
        ("PoissonNLLLoss", (), {"x": a, "y": np.abs(b)}, ("x",)),
        ("PoissonNLLLoss", (False, True, 1e-8, "sum"),
         {"x": np.abs(a) + 0.1, "y": np.abs(b) * 3}, ("x",)),
        ("MultiLabelSoftMarginLoss", (),
         {"x": a, "y": (b > 0).astype(np.float32)}, ("x",)),
        ("MultiMarginLoss", (2, 0.5),
         {"x": logits, "y": rng.integers(0, 6, 4).astype(np.int64)},
         ("x",)),
        ("TripletMarginWithDistanceLoss", (None, 1.0, True),
         {"x": a, "p": b, "n": c}, ("x", "p", "n")),
        ("CTCLoss", (0, "mean"),
         {"lp": _f(rng, t, batch, classes),
          "lab": rng.integers(1, classes, (batch, 4)).astype(np.int64),
          "il": np.asarray([12, 9], np.int64),
          "ll": np.asarray([4, 3], np.int64)}, ("lp",)),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,args,inputs,diff", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_layer_matches_reference(name, args, inputs, diff):
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    keys = list(inputs)
    out = run_both(lambda **kw: jl(*[kw[k] for k in keys]),
                   lambda **kw: tl(*[kw[k] for k in keys]), inputs, diff)
    if name == "AdaptiveMaxPool1D" and len(args) > 1:
        assert out[1].dtype in (torch.int32, torch.int64)


@pytest.mark.parametrize("name,args,shape", [
    ("Conv1DTranspose", (3, 4, 3, 2, 1, 1), (2, 3, 7)),
    ("Conv3DTranspose", (3, 4, 2, 2, 0, 0, 1), (1, 3, 3, 4, 3)),
    ("HSigmoidLoss", (6, 5), None)])
def test_layer_with_weights(name, args, shape):
    jl, tl = model_pair(lambda: getattr(jnn, name)(*args),
                        lambda: getattr(tnn, name)(*args))
    rng = np.random.default_rng(1)
    if shape is None:
        inputs = {"x": _f(rng, 4, 6),
                  "y": rng.integers(0, 5, (4, 1)).astype(np.int64)}
    else:
        inputs = {"x": _f(rng, *shape)}
    keys = list(inputs)
    run_both(lambda **kw: jl(*[kw[k] for k in keys]),
             lambda **kw: tl(*[kw[k] for k in keys]), inputs, ("x",))
    check_grads(jl, tl)


def test_reference_nn_exports_are_ported():
    import paddle_tpu.nn as ref
    names = [n for n in dir(ref) if not n.startswith("_")
             and isinstance(getattr(ref, n), type)]
    missing = [n for n in names if not hasattr(tnn, n)]
    assert not missing, missing
