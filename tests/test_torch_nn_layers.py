"""Every class the reference's ``nn`` exports from ``layers/{activation,
common,conv,loss,norm,pooling}.py`` against the port's: the layer built
with the same arguments in both packages, the reference's ``state_dict``
carried into the port (``load_jax_state``: Linear weights transposed,
the rest as they are), the same seeded inputs. Forward outputs within
``FWD_TOL`` of the reference's largest magnitude; for layers with
parameters, every parameter's gradient of ``sum(out * cot)`` within
``GRAD_TOL`` of the reference gradient's largest magnitude; for the
BatchNorms, the running statistics after two training steps within
``FWD_TOL``. ``test_every_layer_class_has_a_case`` is the coverage
gate."""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn.layers import (activation, common, conv, loss, norm,
                                  pooling)

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import core as tcore

#: max |port - reference| / max(|reference|, 1)
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def f32(*shape, scale=1.0):
    return lambda r: (r.randn(*shape) * scale).astype(np.float32)


def uni(lo, hi, *shape):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def ints(lo, hi, *shape):
    return lambda r: r.randint(lo, hi, shape).astype(np.int64)


def const(a):
    return lambda r: np.asarray(a)


IMG = f32(2, 4, 6, 6)
VEC = f32(3, 6)


def L(cls, args=(), kw=None, inputs=(IMG,), tag="", train=False):
    """A case: ``cls(*args, **kw)`` called on ``inputs`` (in training mode
    when ``train``, else in eval mode)."""
    return (cls, tuple(args), kw or {}, tuple(inputs), tag, train)


ACTS = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
        "Hardswish", "Hardsigmoid", "Hardtanh", "ELU", "CELU", "SELU", "Mish",
        "Softshrink", "Hardshrink", "Softsign", "Tanhshrink", "LogSigmoid",
        "Softmax", "LogSoftmax", "GLU"]

CASES = [L(n) for n in ACTS] + [
    L("LeakyReLU", kw=dict(negative_slope=0.2)),
    L("Softplus", kw=dict(beta=2.0, threshold=3.0)),
    L("Maxout", kw=dict(groups=2)),
    L("PReLU", (4, 0.3)),
    L("RReLU"),
    L("Linear", (6, 5), inputs=(VEC,)),
    L("Linear", (6, 5), dict(bias_attr=False), (VEC,), "nobias"),
    L("Embedding", (10, 4), dict(padding_idx=2), (ints(0, 10, 3, 5),)),
    L("Dropout", (0.3,)),
    L("Dropout2D", (0.3,)),
    L("Dropout3D", (0.3,), inputs=(f32(2, 3, 2, 2, 2),)),
    L("AlphaDropout", (0.3,)),
    L("Flatten"),
    L("Identity"),
    L("Upsample", kw=dict(scale_factor=2, mode="bilinear")),
    L("UpsamplingNearest2D", kw=dict(size=(9, 4))),
    L("UpsamplingBilinear2D", kw=dict(size=(7, 8))),
    L("PixelShuffle", (2,)),
    L("ChannelShuffle", (2,)),
    L("Pad1D", ([1, 2],), dict(mode="replicate"), (f32(2, 3, 5),)),
    L("Pad2D", ([1, 0, 2, 1],), dict(value=0.5)),
    L("Pad3D", ([1, 1, 0, 1, 2, 0],), inputs=(f32(1, 2, 3, 3, 3),)),
    L("ZeroPad2D", ([1, 2, 0, 1],)),
    L("Bilinear", (3, 4, 5), inputs=(f32(2, 3), f32(2, 4))),
    L("CosineSimilarity", kw=dict(axis=1), inputs=(VEC, VEC)),
    L("Unfold", ([2, 3],), dict(strides=2, paddings=1)),
    L("Conv1D", (4, 5, 3), dict(stride=2, padding=1),
      (f32(2, 4, 9),)),
    L("Conv2D", (4, 6, 3), dict(padding=1, groups=2)),
    L("Conv2D", (4, 3, 3), dict(stride=2, bias_attr=False), tag="nobias"),
    L("Conv3D", (2, 3, 3), dict(padding=1), (f32(1, 2, 4, 4, 4),)),
    L("Conv2DTranspose", (4, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1)),
    L("BatchNorm", (4,), train=True),
    L("BatchNorm", (4,), dict(act="relu"), tag="act_eval"),
    L("BatchNorm1D", (6,), inputs=(VEC,), train=True),
    L("BatchNorm2D", (4,), train=True),
    L("BatchNorm2D", (4,), tag="eval"),
    L("BatchNorm3D", (2,), inputs=(f32(2, 2, 3, 3, 3),), train=True),
    L("SyncBatchNorm", (4,), train=True),
    L("LayerNorm", ([6, 6],)),
    L("RMSNorm", (6,)),
    L("GroupNorm", (2, 4)),
    L("InstanceNorm1D", (4,), inputs=(f32(2, 4, 7),), train=True),
    L("InstanceNorm2D", (4,), train=True),
    L("InstanceNorm3D", (2,), inputs=(f32(2, 2, 3, 3, 3),)),
    L("LocalResponseNorm", (3,)),
    L("MaxPool1D", (3, 2, 1), inputs=(f32(2, 3, 9),)),
    L("MaxPool2D", (3, 2, 1)),
    L("AvgPool1D", (3, 2, 1), dict(exclusive=False), (f32(2, 3, 9),)),
    L("AvgPool2D", (3, 2, 1), dict(ceil_mode=True)),
    L("AdaptiveAvgPool1D", (3,), inputs=(f32(2, 3, 9),)),
    L("AdaptiveAvgPool2D", ((4, 5),)),
    L("AdaptiveMaxPool2D", (3,)),
    L("CrossEntropyLoss", inputs=(f32(5, 4), ints(0, 4, 5))),
    L("CrossEntropyLoss", kw=dict(label_smoothing=0.1, reduction="sum"),
      inputs=(f32(5, 4), ints(0, 4, 5)), tag="smooth"),
    L("MSELoss", inputs=(VEC, VEC)),
    L("L1Loss", inputs=(VEC, VEC)),
    L("SmoothL1Loss", kw=dict(delta=0.5), inputs=(VEC, VEC)),
    L("HuberLoss", kw=dict(delta=0.5), inputs=(VEC, VEC)),
    L("NLLLoss", inputs=(f32(5, 4), ints(0, 4, 5))),
    L("BCELoss", inputs=(uni(0.05, 0.95, 3, 6), uni(0, 1, 3, 6))),
    L("BCEWithLogitsLoss", inputs=(VEC, uni(0, 1, 3, 6))),
    L("KLDivLoss", ("sum",), inputs=(VEC, uni(0.1, 1, 3, 6))),
    L("MarginRankingLoss", (0.1,), inputs=(f32(5), f32(5),
                                           const(np.array([1, -1, 1, -1, 1],
                                                          np.float32)))),
    L("CosineEmbeddingLoss", inputs=(VEC, VEC, const([1, -1, 1]))),
    L("TripletMarginLoss", inputs=(VEC, VEC, VEC)),
    L("HingeEmbeddingLoss", inputs=(f32(5), const(
        np.array([1, -1, 1, -1, 1], np.float32)))),
    L("GaussianNLLLoss", inputs=(VEC, VEC, uni(0.2, 2, 3, 6))),
    L("AdaptiveLogSoftmaxWithLoss", (8, 10, [4, 7]),
      dict(head_bias=True), (f32(5, 8), const([0, 5, 9, 3, 7]))),
]

#: the reference raises on construction (``layers/norm.py:190``)
RAISES = {"SpectralNorm"}


def _cls_name(case):
    return case[0] + (f"[{case[4]}]" if case[4] else "")


def _exported():
    """The classes the reference's ``nn`` exports from the six files."""
    files = (activation, common, conv, loss, norm, pooling)
    out = set()
    for name, obj in vars(jnn).items():
        if isinstance(obj, type) and obj.__module__ in {
                f.__name__ for f in files}:
            out.add(name)
    return out


def test_every_layer_class_has_a_case():
    ref = _exported()
    assert len(ref) == 86
    assert sorted(ref - {c[0] for c in CASES} - RAISES) == []
    assert sorted(n for n in ref if not isinstance(getattr(tnn, n, None),
                                                   type)) == []
    assert all(issubclass(getattr(tnn, n), tnn.Layer) for n in ref)


def test_spectral_norm_layer_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        jnn.SpectralNorm([3, 3])
    with pytest.raises(NotImplementedError):
        tnn.SpectralNorm([3, 3])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy(), np.float32)


def _err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1.0)) if want.size else 0.0


def _flat(out):
    return ([o for x in out for o in _flat(x)]
            if isinstance(out, (list, tuple)) else [out])


@pytest.mark.parametrize("case", CASES, ids=_cls_name)
def test_layer_matches_reference(case):
    name, args, kw, inputs, tag, train = case
    seed = zlib.crc32(_cls_name(case).encode())
    rng = np.random.RandomState(seed)
    arrays = [np.asarray(make(rng)) for make in inputs]
    paddle.seed(seed)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    pt.load_jax_state(tl, {k: np.asarray(v.numpy())
                           for k, v in jl.state_dict().items()})
    for layer in (jl, tl):
        layer.train() if train else layer.eval()
    steps = 2 if train else 1
    for step in range(steps):
        jout = _flat(jl(*[paddle.to_tensor(a) for a in arrays]))
        tout = _flat(tl(*[torch.from_numpy(a.copy()) for a in arrays]))
        for i, (j, t) in enumerate(zip(jout, tout, strict=True)):
            assert tuple(t.shape) == tuple(j.shape), f"out {i} step {step}"
            err = _err(_np(t), _np(j))
            assert err <= FWD_TOL, f"out {i} step {step}: error {err:.3e}"
    jstate = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tstate = pt.jax_layout(tl)
    assert list(tstate) == list(jstate)
    for k in jstate:
        err = _err(tstate[k], jstate[k])
        assert err <= FWD_TOL, f"{k} after {steps} steps: error {err:.3e}"
    if not jl.parameters():
        return
    cot_rng = np.random.RandomState(seed + 1)
    cots = [np.asarray(cot_rng.randn(*tuple(j.shape)), np.float32)
            for j in jout]
    jloss = sum((j * paddle.to_tensor(c)).sum()
                for j, c in zip(jout, cots))
    tloss = sum((t * torch.from_numpy(c)).sum()
                for t, c in zip(tout, cots))
    jloss.backward()
    tloss.backward()
    tgrads = pt.jax_layout(tl, {n: p.grad if p.grad is not None
                                else torch.zeros_like(p)
                                for n, p in tl.named_parameters()})
    for n, p in jl.named_parameters():
        want = (np.zeros(p.shape, np.float32) if p.grad is None
                else _np(p.grad))
        err = _err(tgrads[n], want)
        assert err <= GRAD_TOL, f"grad of {n}: error {err:.3e}"
