"""The port's ``geometric`` (``paddle_tpu_torch/geometric.py``) against
the reference's (``paddle_tpu/geometric.py``) on the CPU, on inputs
drawn from a numpy seed: every segment pool and every message op under every
reduction, empty segments, integer data, ties under max and min (their
gradients split as JAX splits them), gradients through the gather and
the scatter, ``out_size`` read without a host sync, and the cases of
``tests/test_geometric.py``.

The rule: fp32 values and gradients within ``rtol = 1e-5`` (``atol =
1e-6``) of the reference's; integer results equal."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import geometric as JG

from paddle_tpu_torch import geometric as TG
from paddle_tpu_torch import jit as tjit
from torch_vision_common import port_on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
REDUCES = ["sum", "mean", "max", "min"]
MESSAGES = ["add", "sub", "mul", "div"]


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def jt(a, grad=False):
    t = paddle.to_tensor(np.asarray(a))
    t.stop_gradient = not grad
    return t


def tt(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def close(got, want, what):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL, err_msg=what)


def graph(seed, nodes=7, edges=19, feat=3, empty=(5,)):
    """A random graph whose ``empty`` nodes receive no edge."""
    rng = np.random.default_rng(seed)
    dst = rng.choice([n for n in range(nodes) if n not in empty], edges)
    src = rng.integers(0, nodes, edges)
    x = rng.standard_normal((nodes, feat)).astype(np.float32)
    e = rng.standard_normal((edges, feat)).astype(np.float32)
    # keep the divisors away from zero
    e = np.where(np.abs(e) < 0.3, 0.3, e).astype(np.float32)
    w = rng.standard_normal((nodes, feat)).astype(np.float32)
    return x, e, src.astype(np.int64), dst.astype(np.int64), w


def segment_data(seed, integer=False):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice([0, 1, 3, 4, 6], 11)).astype(np.int64)
    if integer:
        data = rng.integers(-9, 9, (11, 3)).astype(np.int32)
    else:
        data = rng.standard_normal((11, 3)).astype(np.float32)
    return data, ids


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("num", [None, 9])
def test_segment_pools_and_gradients(reduce, num):
    """Segment 2 and 5 (and 7, 8 with ``num_segments=9``) are empty: 0
    under every reduction, as the reference's count mask gives."""
    data, ids = segment_data(1)
    w = np.random.default_rng(2).standard_normal((num or 7, 3)).astype(
        np.float32)
    jd, td = jt(data, True), tt(data, True)
    jout = getattr(JG, f"segment_{reduce}")(jd, jt(ids), num_segments=num)
    tout = getattr(TG, f"segment_{reduce}")(td, tt(ids), num_segments=num)
    close(tout, jout, f"segment_{reduce}")
    assert np.all(npy(tout)[[2, 5]] == 0)
    (jout * jt(w)).sum().backward()
    (tout * tt(w)).sum().backward()
    close(td.grad, jd.grad, f"segment_{reduce} gradient")


@pytest.mark.parametrize("reduce", REDUCES)
def test_segment_pools_on_integers(reduce):
    data, ids = segment_data(3, integer=True)
    jout = getattr(JG, f"segment_{reduce}")(jt(data), jt(ids))
    tout = getattr(TG, f"segment_{reduce}")(tt(data), tt(ids))
    got, want = npy(tout), npy(jout)
    # the reference narrows to 32 bits (C26); mean divides into fp32 in
    # both
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if reduce == "mean":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_ties_split_the_gradient_as_the_reference(reduce):
    """Three messages tie for segment 0's max (and min) in column 0: JAX
    gives each a third of the cotangent; the port's ``scatter_reduce``
    the same."""
    data = np.array([[2., 1.], [2., 5.], [2., 5.], [-1., 0.], [7., 7.]],
                    np.float32)
    ids = np.array([0, 0, 0, 0, 2])
    w = np.array([[3., 5.], [1., 1.], [4., 2.]], np.float32)
    if reduce == "min":
        data = -data
    jd, td = jt(data, True), tt(data, True)
    jout = getattr(JG, f"segment_{reduce}")(jd, jt(ids))
    tout = getattr(TG, f"segment_{reduce}")(td, tt(ids))
    close(tout, jout, reduce)
    (jout * jt(w)).sum().backward()
    (tout * tt(w)).sum().backward()
    close(td.grad, jd.grad, f"{reduce} gradient with ties")
    np.testing.assert_allclose(npy(td.grad)[:3, 0], [1., 1., 1.])


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("out_size", [None, 9])
def test_send_u_recv(reduce, out_size):
    x, _, src, dst, _ = graph(4)
    w = np.random.default_rng(5).standard_normal(
        (out_size or 7, 3)).astype(np.float32)
    jx, tx = jt(x, True), tt(x, True)
    jout = JG.send_u_recv(jx, jt(src), jt(dst), reduce_op=reduce,
                          out_size=out_size)
    tout = TG.send_u_recv(tx, tt(src), tt(dst), reduce_op=reduce,
                          out_size=out_size)
    close(tout, jout, f"send_u_recv {reduce}")
    assert np.all(npy(tout)[5] == 0)
    (jout * jt(w)).sum().backward()
    (tout * tt(w)).sum().backward()
    close(tx.grad, jx.grad, f"send_u_recv {reduce} gradient")


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("message", MESSAGES)
def test_send_ue_recv(message, reduce):
    x, e, src, dst, w = graph(6)
    jx, je, tx, te = jt(x, True), jt(e, True), tt(x, True), tt(e, True)
    jout = JG.send_ue_recv(jx, je, jt(src), jt(dst), message_op=message,
                           reduce_op=reduce)
    tout = TG.send_ue_recv(tx, te, tt(src), tt(dst), message_op=message,
                           reduce_op=reduce)
    close(tout, jout, f"send_ue_recv {message} {reduce}")
    (jout * jt(w)).sum().backward()
    (tout * tt(w)).sum().backward()
    close(tx.grad, jx.grad, f"send_ue_recv {message} {reduce} d x")
    close(te.grad, je.grad, f"send_ue_recv {message} {reduce} d e")


@pytest.mark.parametrize("message", MESSAGES)
def test_send_uv(message):
    x, e, src, dst, _ = graph(7)
    y = np.where(np.abs(x) < 0.3, 0.3, x).astype(np.float32)[::-1].copy()
    w = np.random.default_rng(8).standard_normal(e.shape).astype(np.float32)
    jx, jy, tx, ty = jt(x, True), jt(y, True), tt(x, True), tt(y, True)
    jout = JG.send_uv(jx, jy, jt(src), jt(dst), message_op=message)
    tout = TG.send_uv(tx, ty, tt(src), tt(dst), message_op=message)
    close(tout, jout, f"send_uv {message}")
    (jout * jt(w)).sum().backward()
    (tout * tt(w)).sum().backward()
    close(tx.grad, jx.grad, f"send_uv {message} d x")
    close(ty.grad, jy.grad, f"send_uv {message} d y")


def test_unknown_ops_raise():
    x, e, src, dst, _ = graph(9)
    with pytest.raises(ValueError):
        TG.send_u_recv(tt(x), tt(src), tt(dst), reduce_op="prod")
    with pytest.raises(ValueError):
        TG.send_uv(tt(x), tt(x), tt(src), tt(dst), message_op="pow")


def test_ids_as_numpy_and_lists_follow_the_data():
    x, _, src, dst, _ = graph(10)
    want = TG.send_u_recv(tt(x), tt(src), tt(dst))
    got = TG.send_u_recv(tt(x), src, list(dst))
    assert got.device == want.device
    np.testing.assert_array_equal(npy(got), npy(want))
    data, ids = segment_data(11)
    close(TG.segment_sum(tt(data), ids), JG.segment_sum(jt(data), jt(ids)),
          "segment_sum of numpy ids")


def test_sizes_given_read_nothing_on_the_host(monkeypatch):
    """With ``num_segments`` / ``out_size`` given no op reads the ids back
    (``max``, ``item``, ``tolist``, ``int()`` on a tensor), so a CUDA call
    never waits for the device."""
    data, ids = segment_data(12)
    x, e, src, dst, _ = graph(13)
    args = tt(data), tt(ids), tt(x), tt(e), tt(src), tt(dst)

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor")

    for name in ("max", "item", "tolist", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    d, i, xx, ee, s, t = args
    for r in REDUCES:
        getattr(TG, f"segment_{r}")(d, i, num_segments=7)
        TG.send_u_recv(xx, s, t, reduce_op=r, out_size=7)
        TG.send_ue_recv(xx, ee, s, t, reduce_op=r, out_size=7)
    TG.send_uv(xx, xx, s, t)
    monkeypatch.undo()
    with pytest.raises(AssertionError):
        monkeypatch.setattr(torch.Tensor, "max", refuse)
        TG.segment_sum(d, i)


def test_reference_cases():
    """``tests/test_geometric.py``'s cases: sums and means against numpy,
    node 1's gradient of 2, and ``send_ue_recv`` mul / max with an
    empty node."""
    rng = np.random.RandomState(0)
    data = rng.randn(6, 3).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 1, 3], np.int64)
    want = np.zeros((4, 3), np.float32)
    for i, s in enumerate(ids):
        want[s] += data[i]
    np.testing.assert_allclose(npy(TG.segment_sum(tt(data), tt(ids))), want,
                               rtol=1e-6)
    gm = npy(TG.segment_mean(tt(data), tt(ids)))
    np.testing.assert_allclose(gm[0], data[:2].mean(0), rtol=1e-6)
    np.testing.assert_allclose(gm[2], 0.0)
    x = rng.randn(4, 2).astype(np.float32)
    src = np.array([0, 1, 2, 3, 1], np.int64)
    dst = np.array([1, 2, 1, 0, 0], np.int64)
    xt = tt(x, True)
    TG.send_u_recv(xt, tt(src), tt(dst), out_size=4).sum().backward()
    np.testing.assert_allclose(npy(xt.grad)[:, 0], [1, 2, 1, 1])
    x = rng.randn(3, 2).astype(np.float32)
    e = rng.randn(4, 2).astype(np.float32)
    src = np.array([0, 1, 2, 0], np.int64)
    dst = np.array([1, 0, 0, 2], np.int64)
    out = npy(TG.send_ue_recv(tt(x), tt(e), tt(src), tt(dst),
                              message_op="mul", reduce_op="max"))
    msgs = x[src] * e
    want = np.full((3, 2), -np.inf, np.float32)
    for i, d in enumerate(dst):
        want[d] = np.maximum(want[d], msgs[i])
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_to_static_with_num_segments():
    x = np.random.default_rng(14).standard_normal((5, 2)).astype(np.float32)
    ids = tt(np.array([0, 1, 1, 2, 2]))

    def fn(a):
        return TG.segment_sum(a, ids, num_segments=3)

    static = tjit.to_static(fn, backend="eager")
    np.testing.assert_array_equal(npy(static(tt(x))), npy(fn(tt(x))))
