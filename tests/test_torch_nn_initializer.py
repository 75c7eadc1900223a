"""The port's initializers against ``paddle_tpu.nn.initializer``: the
fans, gains, bounds and standard deviations equal the reference's
exactly; the deterministic initializers give its values bit for bit;
the random ones (their draws are not the reference's JAX streams,
ROADMAP C2) are held statistically against those numbers, against the
reference's own draws, and to reproduce within the port. Each
statistical tolerance is stated beside its check."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as J

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.nn import initializer as T

SHAPES = [(), (5,), (3, 4), (8, 3, 3, 3), (4, 2, 5), (6, 4, 2, 3, 3)]
BIG = (256, 96, 3, 3)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fans_equal_reference(shape):
    assert T._fans(shape) == J._fans(shape)


@pytest.mark.parametrize("name,param", [
    ("sigmoid", None), ("tanh", None), ("relu", None), ("selu", None),
    ("conv2d", None), ("linear", None), ("leaky_relu", None),
    ("leaky_relu", 0.2), ("unknown", None)])
def test_calculate_gain_equals_reference(name, param):
    assert T.calculate_gain(name, param) == J.calculate_gain(name, param)


def _ref_scale(init_cls, shape, **kw):
    """The reference's bound or std, from its own ``_fans`` and the
    formulas of ``paddle_tpu/nn/initializer/__init__.py``."""
    fin, fout = J._fans(shape)
    fin = kw.get("fan_in") or fin
    fout = kw.get("fan_out") or fout
    gain = kw.get("gain", 1.0)
    slope = kw.get("negative_slope", 0.0)
    kgain = math.sqrt(2.0 / (1 + slope ** 2))
    return {"XavierUniform": gain * math.sqrt(6.0 / (fin + fout)),
            "XavierNormal": gain * math.sqrt(2.0 / (fin + fout)),
            "KaimingUniform": kgain * math.sqrt(3.0 / fin),
            "KaimingNormal": kgain / math.sqrt(fin)}[init_cls]


@pytest.mark.parametrize("cls,kw", [
    ("XavierUniform", {}), ("XavierUniform", dict(gain=2.0, fan_in=7)),
    ("XavierNormal", {}), ("XavierNormal", dict(fan_out=11)),
    ("KaimingUniform", {}), ("KaimingUniform", dict(negative_slope=0.2)),
    ("KaimingNormal", {}), ("KaimingNormal", dict(fan_in=50))])
@pytest.mark.parametrize("shape", [(3, 4), (8, 3, 3, 3), (4, 2, 5)], ids=str)
def test_bounds_and_stds_equal_reference(cls, kw, shape):
    init = getattr(T, cls)(**kw)
    got = init.limit(shape) if cls.endswith("Uniform") else init.std(shape)
    assert got == _ref_scale(cls, shape, **kw)


def _draw_stats(a):
    a = np.asarray(a, np.float64).ravel()
    return a.mean(), a.std(), a.min(), a.max()


@pytest.mark.parametrize("cls,kw", [
    ("XavierUniform", {}), ("XavierNormal", {}), ("KaimingUniform", {}),
    ("KaimingNormal", {}), ("Uniform", dict(low=-0.3, high=0.7)),
    ("Normal", dict(mean=0.5, std=2.0)),
    ("TruncatedNormal", dict(mean=0.1, std=0.5, a=-1.5, b=2.0))])
def test_random_draws_match_reference_statistics(cls, kw):
    """On a 221,184-element draw: the mean within 5 standard errors of the
    law's, the std within 1 %, the range within the law's and within 1 %
    of the reference draw's range (these bounds hold with overwhelming
    probability for a correct sampler)."""
    paddle.seed(1)
    pt.seed(1)
    want = np.asarray(getattr(J, cls)(**kw)(BIG))
    got = getattr(T, cls)(**kw)(BIG).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    gm, gs, gmin, gmax = _draw_stats(got)
    wm, ws, wmin, wmax = _draw_stats(want)
    n = got.size
    assert abs(gm - wm) <= 5 * ws / math.sqrt(n / 2)
    assert abs(gs - ws) <= 0.01 * ws
    if cls.endswith("Uniform") or cls == "Uniform" or "Truncated" in cls:
        assert abs(gmin - wmin) <= 0.01 * (wmax - wmin)
        assert abs(gmax - wmax) <= 0.01 * (wmax - wmin)
    if cls == "TruncatedNormal":
        assert gmin >= 0.1 - 1.5 * 0.5 - 1e-6 and gmax <= 0.1 + 2.0 * 0.5 + 1e-6


def test_random_draws_reproduce_under_seed():
    def draw():
        return [T.Normal()((64, 64)), T.XavierUniform()((32, 16)),
                T.TruncatedNormal()((100,)), T.Orthogonal()((8, 5))]
    pt.seed(7)
    a = draw()
    pt.seed(7)
    b = draw()
    pt.seed(8)
    c = draw()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("shape,gain", [((8, 5), 1.0), ((5, 8), 2.0),
                                        ((6, 2, 3), 0.5)], ids=str)
def test_orthogonal(shape, gain):
    """The reference's construction: rows (or columns) orthonormal,
    times ``gain``; both packages' draws satisfy it."""
    for w in (np.asarray(J.Orthogonal(gain)(shape)),
              T.Orthogonal(gain)(shape).numpy()):
        m = w.reshape(shape[0], -1).astype(np.float64)
        g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g, gain ** 2 * np.eye(g.shape[0]),
                                   atol=1e-5)


@pytest.mark.parametrize("name,init,shape", [
    ("constant", lambda M: M.Constant(0.3), (3, 4)),
    ("assign_list", lambda M: M.Assign([[1.0, 2.0], [3.0, 4.0]]), (2, 2)),
    ("assign_reshape", lambda M: M.Assign(np.arange(6.0)), (2, 3)),
    ("dirac", lambda M: M.Dirac(), (4, 3, 3, 3)),
    ("dirac_groups", lambda M: M.Dirac(groups=2), (6, 2, 3, 5)),
    ("bilinear", lambda M: M.Bilinear(), (2, 3, 4, 4)),
    ("bilinear_odd", lambda M: M.Bilinear(), (1, 1, 3, 5))])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_deterministic_are_bit_equal(name, init, shape, dtype):
    want = np.asarray(init(J)(shape, dtype))
    got = init(T)(shape, dtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_meta_device_draws_nothing():
    with torch.device("meta"):
        w = T.XavierUniform()((3, 4))
        c = T.Constant(2.0)((3,))
    assert w.device.type == "meta" and c.device.type == "meta"


def test_set_global_initializer_is_recorded():
    w, b = T.Normal(), T.Constant(0.0)
    T.set_global_initializer(w, b)
    try:
        assert (T._global_weight_init, T._global_bias_init) == (w, b)
    finally:
        T.set_global_initializer(None, None)


def test_layer_defaults_use_the_references_initializers():
    """Conv weights and biases from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``,
    Linear weights ``XavierUniform`` on ``[in, out]`` (stored
    transposed), biases and BN's shift 0, norm scales 1, Embedding
    ``N(0, 1)`` with the padding row 0."""
    conv = tnn.Conv2D(16, 32, 3)
    bound = 1 / math.sqrt(16 * 9)
    for p in (conv.weight, conv.bias):
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.9 * bound or p is conv.bias
    lin = tnn.Linear(300, 200)
    assert tuple(lin.weight.shape) == (200, 300)
    lim = math.sqrt(6 / 500)
    assert 0.99 * lim < float(lin.weight.abs().max()) <= lim
    assert float(lin.bias.abs().max()) == 0
    bn = tnn.BatchNorm2D(8)
    assert torch.equal(bn.weight, torch.ones(8))
    assert torch.equal(bn.bias, torch.zeros(8))
    assert torch.equal(bn._variance, torch.ones(8))
    emb = tnn.Embedding(50, 400, padding_idx=3)
    assert float(emb.weight[3].abs().max()) == 0
    assert abs(float(emb.weight.std()) - 1) < 0.02
    attr = pt.ParamAttr(initializer=T.KaimingNormal(fan_in=9))
    w = tnn.Linear(10, 8, weight_attr=attr).weight
    assert tuple(w.shape) == (8, 10)
