"""The port's ``ops/linalg.py`` against the reference's OpCases of that
module (``tests/test_torch_ops_harness.py`` says how), and its exempt
ops against the reference: factorisations by what they reconstruct."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_torch_ops_harness import (_port_on_cpu, assert_same, cases_of,  # noqa: F401
                                    to_numpy)
from test_torch_ops_harness import run_case

import paddle_tpu_torch as pt

RNG = np.random.RandomState(13)


def _spd(n):
    a = RNG.randn(n, n).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("case", cases_of("linalg"), ids=lambda c: c.name)
def test_linalg_case_matches_reference(case):
    run_case(case)


def test_lu_family():
    """lu's 0-based pivots and packed factor equal the reference's;
    lu_unpack reconstructs A; lu_solve solves A x = b and A^T x = b."""
    a = RNG.randn(5, 5).astype(np.float32)
    jlu, jpiv = paddle.linalg.lu(paddle.to_tensor(a))
    lu_, piv = pt.linalg.lu(torch.from_numpy(a))
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv.numpy()))
    np.testing.assert_allclose(lu_.numpy(), np.asarray(jlu.numpy()),
                               rtol=1e-4, atol=1e-5)
    p, l_, u = pt.linalg.lu_unpack(lu_, piv)
    jp, jl, ju = paddle.linalg.lu_unpack(jlu, jpiv)
    np.testing.assert_allclose((p @ l_ @ u).numpy(), a, atol=1e-5)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp.numpy()))
    b = RNG.randn(5, 2).astype(np.float32)
    for trans in ("N", "T"):
        got = pt.linalg.lu_solve(torch.from_numpy(b), lu_, piv, trans=trans)
        want = paddle.linalg.lu_solve(paddle.to_tensor(b), jlu, jpiv,
                                      trans=trans)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError):
        pt.linalg.lu_solve(torch.from_numpy(b), lu_, piv, trans="X")


def test_linalg_extras():
    spd = _spd(4)
    c = np.linalg.cholesky(spd).astype(np.float32)
    for upper, f in ((False, c), (True, c.T.copy())):
        got = pt.linalg.cholesky_inverse(torch.from_numpy(f), upper=upper)
        want = paddle.linalg.cholesky_inverse(paddle.to_tensor(f),
                                              upper=upper)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=2e-3, atol=1e-4)
    x = RNG.randn(2, 3, 4).astype(np.float32)
    got = pt.linalg.matrix_transpose(torch.from_numpy(x))
    want = paddle.linalg.matrix_transpose(paddle.to_tensor(x))
    assert_same(to_numpy(got), np.asarray(want.numpy()), 0, 0, "transpose")


def test_eig_and_eigvals():
    """Eigenvalues as sets; each eigenpair satisfies A v = w v."""
    a = RNG.randn(4, 4).astype(np.float32)
    w, v = pt.linalg.eig(torch.from_numpy(a))
    jw, _ = paddle.linalg.eig(paddle.to_tensor(a))
    assert w.dtype == torch.complex64
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(w.numpy(), key=key),
                               sorted(np.asarray(jw.numpy()), key=key),
                               rtol=1e-4, atol=1e-4)
    an = a.astype(np.complex64)
    np.testing.assert_allclose(an @ v.numpy(), v.numpy() * w.numpy(),
                               atol=1e-4)
    ev = pt.linalg.eigvals(torch.from_numpy(a)).numpy()
    jev = np.asarray(paddle.linalg.eigvals(paddle.to_tensor(a)).numpy())
    np.testing.assert_allclose(sorted(ev, key=key), sorted(jev, key=key),
                               rtol=1e-4, atol=1e-4)


def test_low_rank():
    """pca_lowrank equals the reference's (a full SVD there too) up to
    the singular vectors' signs; svd_lowrank's draw is the port's own, so
    it is held to the exact SVD of a low-rank matrix."""
    x = RNG.randn(8, 5).astype(np.float32)
    u, s, v = pt.linalg.pca_lowrank(torch.from_numpy(x), q=3)
    ju, js, jv = paddle.linalg.pca_lowrank(paddle.to_tensor(x), q=3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js.numpy()), rtol=1e-4)
    np.testing.assert_allclose(np.abs(u.numpy()), np.abs(ju.numpy()),
                               atol=1e-4)
    np.testing.assert_allclose(np.abs(v.numpy()), np.abs(jv.numpy()),
                               atol=1e-4)
    low = (RNG.randn(10, 3) @ RNG.randn(3, 6)).astype(np.float32)
    pt.seed(0)
    u, s, v = pt.linalg.svd_lowrank(torch.from_numpy(low), q=3)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(low)[1][:3],
                               rtol=1e-3)
    np.testing.assert_allclose((u * s @ v.T).numpy(), low, atol=1e-3)


def test_norm_aliases():
    """paddle.norm, dist, inverse and the rest at the top level are the
    linalg ops; norm's axis and p spellings give the reference's values."""
    x = RNG.randn(3, 4).astype(np.float32)
    for kw in (dict(), dict(p=1, axis=1), dict(p="fro", axis=[0, 1]),
               dict(p=np.inf, axis=0, keepdim=True), dict(p="nuc",
                                                          axis=[0, 1])):
        got = pt.norm(torch.from_numpy(x), **kw)
        want = paddle.norm(paddle.to_tensor(x), **kw)
        assert_same(to_numpy(got), np.asarray(want.numpy()), 1e-5, 1e-5,
                    str(kw))
    y = RNG.randn(3, 4).astype(np.float32)
    for p in (2.0, 1.0, 0.0, np.inf):
        got = pt.dist(torch.from_numpy(x), torch.from_numpy(y), p)
        want = paddle.dist(paddle.to_tensor(x), paddle.to_tensor(y), p)
        assert_same(to_numpy(got), np.asarray(want.numpy()), 1e-5, 1e-5,
                    f"dist {p}")
    assert pt.inverse is pt.linalg.inv and pt.norm is pt.linalg.norm
    assert pt.matrix_power is pt.linalg.matrix_power
    assert pt.bitwise_invert is pt.bitwise_not
