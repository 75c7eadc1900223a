"""The port's ``sparse`` (``paddle_tpu_torch/sparse/__init__.py``) against
the reference's (``paddle_tpu/sparse/__init__.py``) on the CPU: the COO
and CSR tensors, the elementwise, binary and reduction ops, and the
cases of ``tests/test_sparse_quant.py`` (``:18-74``). The structure
ops, the products, ``softmax`` and ``sparse.nn`` are in
``tests/test_torch_sparse_nn.py``.

The rule: fp32 values within ``rtol = 1e-5`` (``atol = 1e-6``) of the
reference's; indices and integer results equal. Where the reference's
BCOO result carries padding (ROADMAP C49: entries whose index equals the
dimension's size, value 0, up to a fixed ``nse``), the port's entries
are the reference's real ones, in the same order, and the test states
both counts."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import sparse as JS

from paddle_tpu_torch import sparse as TS
from torch_vision_common import port_on_cpu  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def close(got, want, what):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL, err_msg=what)


def real_entries(ref):
    """The reference's entries without BCOO's padding (an index equal to
    its dimension's size)."""
    idx, vals = npy(ref.indices()), npy(ref.values())
    idx = idx.reshape(idx.shape[0], -1)
    vals = vals.reshape(-1)
    keep = np.all(idx < np.array(ref.shape)[:, None], axis=0)
    return idx[:, keep], vals[keep], int((~keep).sum())


def same_coo(got, want, what, padding=None):
    """Port COO == the reference's real entries (indices equal, values
    within TOL); ``padding``, where given, is the reference's count of
    padded entries (C49)."""
    assert isinstance(got, TS.SparseCooTensor), (what, type(got))
    assert type(want).__name__ == "SparseCooTensor", what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    idx, vals, pad = real_entries(want)
    np.testing.assert_array_equal(npy(got.indices()), idx, err_msg=what)
    assert got.nnz == want.nnz - pad, (what, got.nnz, want.nnz, pad)
    if padding is not None:
        assert pad == padding, (what, pad, padding)
    if vals.dtype == np.bool_:
        # the reference's to_dense sums with add, which refuses bool
        np.testing.assert_array_equal(npy(got.values()), vals, err_msg=what)
        want_dense = np.zeros(want.shape, bool)
        want_dense[tuple(idx)] = vals
        np.testing.assert_array_equal(npy(got.to_dense()), want_dense)
        return
    np.testing.assert_allclose(npy(got.values()), vals, **TOL, err_msg=what)
    close(got.to_dense(), want.to_dense(), f"{what} dense")


def same_csr(got, want, what):
    assert isinstance(got, TS.SparseCsrTensor), (what, type(got))
    assert type(want).__name__ == "SparseCsrTensor", what
    assert got.shape == want.shape
    np.testing.assert_array_equal(npy(got.crows()), npy(want.crows()))
    np.testing.assert_array_equal(npy(got.cols()), npy(want.cols()))
    close(got.values(), want.values(), what)
    close(got.to_dense(), want.to_dense(), f"{what} dense")


def draw(seed, shape=(5, 6), nnz=9, dup=False, positive=False):
    """A COO pair (reference, port) of ``nnz`` random coordinates
    (distinct unless ``dup``) and its numpy parts."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(int(np.prod(shape)), nnz, replace=dup)
    idx = np.stack(np.unravel_index(flat, shape)).astype(np.int64)
    vals = rng.standard_normal(nnz).astype(np.float32)
    if positive:
        vals = np.abs(vals) + 0.1
    return (JS.sparse_coo_tensor(idx, vals, list(shape)),
            TS.sparse_coo_tensor(idx, vals, list(shape)), idx, vals)


def draw_csr(seed, shape=(5, 6), nnz=9, positive=False):
    j, t, idx, vals = draw(seed, shape, nnz, positive=positive)
    jc = JS.sparse_coo_tensor(idx, vals, list(shape)).coalesce()
    jcsr = jc.to_sparse_csr()
    return (jcsr, TS.sparse_csr_tensor(npy(jcsr.crows()), npy(jcsr.cols()),
                                       npy(jcsr.values()), list(shape)))


def dense(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the cases of tests/test_sparse_quant.py ---------------------------------

def test_coo_roundtrip():
    idx = [[0, 1, 2], [1, 2, 0]]
    vals = [1.0, 2.0, 3.0]
    st = TS.sparse_coo_tensor(idx, vals, shape=[3, 3])
    assert st.is_sparse_coo() and st.nnz == 3
    ref = np.zeros((3, 3), np.float32)
    ref[0, 1], ref[1, 2], ref[2, 0] = 1, 2, 3
    np.testing.assert_array_equal(npy(st.to_dense()), ref)
    assert st.values().dtype == torch.float32
    assert list(st.indices().shape) == [2, 3]
    same_coo(st, JS.sparse_coo_tensor(idx, vals, shape=[3, 3]), "coo")
    # the shape, when not given, from the largest index
    assert TS.sparse_coo_tensor(idx, vals).shape == [3, 3]


def test_csr_roundtrip_and_convert():
    args = ([0, 1, 2, 3], [1, 2, 0], [1.0, 2.0, 3.0])
    st = TS.sparse_csr_tensor(*args, shape=[3, 3])
    js = JS.sparse_csr_tensor(*args, shape=[3, 3])
    assert st.is_sparse_csr() and st.nnz == 3
    same_csr(st, js, "csr")
    assert st.crows().dtype == st.cols().dtype == torch.int32
    same_coo(st.to_sparse_coo(), js.to_sparse_coo(), "csr -> coo")
    same_csr(st.to_sparse_coo().to_sparse_csr(), js, "csr -> coo -> csr")


def test_add_multiply_relu_cases():
    a = [[[0, 1], [0, 1]], [1.0, -2.0], [2, 2]]
    b = [[[0, 1], [0, 0]], [5.0, 1.0], [2, 2]]
    s = TS.add(TS.sparse_coo_tensor(*a), TS.sparse_coo_tensor(*b))
    np.testing.assert_array_equal(npy(s.to_dense()), [[6., 0.], [1., -2.]])
    same_coo(s, JS.add(JS.sparse_coo_tensor(*a), JS.sparse_coo_tensor(*b)),
             "add", padding=1)
    r = TS.relu(TS.sparse_coo_tensor(*a))
    np.testing.assert_array_equal(npy(r.to_dense()), [[1., 0.], [0., 0.]])


def test_matmul_gradient_case():
    idx, vals = [[0, 0, 1], [0, 1, 1]], [1.0, 2.0, 3.0]
    x = torch.eye(2, requires_grad=True)
    out = TS.matmul(TS.sparse_coo_tensor(idx, vals, [2, 2]), x)
    np.testing.assert_array_equal(npy(out), [[1., 2.], [0., 3.]])
    out.sum().backward()
    np.testing.assert_array_equal(npy(x.grad), [[1., 1.], [5., 5.]])


def test_masked_matmul_case():
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    y = np.ones((2, 2), np.float32)
    mask = [[[0, 1], [1, 0]], [1.0, 1.0], [2, 2]]
    got = TS.masked_matmul(torch.tensor(x), torch.tensor(y),
                           TS.sparse_coo_tensor(*mask))
    same_coo(got, JS.masked_matmul(paddle.to_tensor(x), paddle.to_tensor(y),
                                   JS.sparse_coo_tensor(*mask)),
             "masked_matmul")


# -- BCOO padding, decided op by op (C49) ------------------------------------

def test_add_keeps_cancellations_and_pads_nothing():
    """Coordinates that cancel stay with value 0 in both; the reference
    pads to ``x.nse + y.nse``."""
    j1, t1, idx, vals = draw(1)
    j2 = JS.sparse_coo_tensor(idx[:, :5], -vals[:5], [5, 6])
    t2 = TS.sparse_coo_tensor(idx[:, :5], -vals[:5], [5, 6])
    got, want = TS.add(t1, t2), JS.add(j1, j2)
    same_coo(got, want, "add with cancellations", padding=5)
    assert int((npy(got.values()) == 0).sum()) == 5
    assert want.nnz == 14 and got.nnz == 9


def test_multiply_by_dense_drops_exact_zeros():
    """The reference multiplies densely and rebuilds with ``nse = x.nse``:
    a product that is exactly 0 is dropped, and padding fills its
    place."""
    j, t, idx, vals = draw(2)
    d = dense(3, (5, 6))
    d[tuple(idx[:, :3])] = 0.0
    got, want = TS.multiply(t, torch.tensor(d)), JS.multiply(
        j, paddle.to_tensor(d))
    same_coo(got, want, "sparse * dense", padding=3)
    assert got.nnz == 6


def test_multiply_sparse_by_sparse_keeps_the_intersection():
    j1, t1, idx, vals = draw(4)
    j2 = JS.sparse_coo_tensor(idx[:, 2:7], np.r_[0., vals[3:7]].astype(
        np.float32), [5, 6])
    t2 = TS.sparse_coo_tensor(idx[:, 2:7], np.r_[0., vals[3:7]].astype(
        np.float32), [5, 6])
    got = TS.multiply(t1, t2)
    same_coo(got, JS.multiply(j1, j2), "sparse * sparse")
    assert got.nnz == 5          # the zero product stays, as there
    same_coo(TS.multiply(t2, t1), JS.multiply(j2, j1), "sparse * sparse, "
             "swapped")


@pytest.mark.parametrize("axis,keepdim", [(0, False), (1, False), (1, True),
                                          (-1, False), (None, False),
                                          (None, True)])
def test_sum(axis, keepdim):
    """A row that cancels exactly is dropped in both; an all-zero result
    is one padded entry there and none here."""
    idx = np.array([[0, 1, 1, 2, 3], [0, 0, 1, 4, 2]])
    vals = np.array([1.5, 2.0, -2.0, 3.0, 0.25], np.float32)
    got = TS.sum(TS.sparse_coo_tensor(idx, vals, [4, 5]), axis=axis,
                 keepdim=keepdim)
    want = JS.sum(JS.sparse_coo_tensor(idx, vals, [4, 5]), axis=axis,
                  keepdim=keepdim)
    if axis is None:
        close(got, want, "sum over everything")
        return
    same_coo(got, want, f"sum axis {axis}")


def test_sum_to_nothing_and_dtype():
    idx = np.array([[0, 0], [1, 3]])
    vals = np.array([2.0, -2.0], np.float32)
    got = TS.sum(TS.sparse_coo_tensor(idx, vals, [2, 4]), axis=1)
    want = JS.sum(JS.sparse_coo_tensor(idx, vals, [2, 4]), axis=1)
    same_coo(got, want, "sum to zero", padding=1)
    assert got.nnz == 0
    # float64 stays float64 in the port; the reference narrows (C26)
    got = TS.sum(TS.sparse_coo_tensor(idx, vals, [2, 4]), axis=0,
                 dtype="float64")
    assert got.dtype == torch.float64
    assert JS.sum(JS.sparse_coo_tensor(idx, vals, [2, 4]), axis=0,
                  dtype="float64").dtype == np.float32


@pytest.mark.parametrize("axes,starts,ends", [([0], [1], [4]),
                                              ([1], [-3], [5]),
                                              ([0, 1], [2, 1], [9, 3])])
def test_slice(axes, starts, ends):
    j, t, idx, vals = draw(5, dup=True, nnz=12)
    same_coo(TS.slice(t, axes, starts, ends), JS.slice(j, axes, starts, ends),
             f"slice {axes} {starts} {ends}")


def test_empty_slice():
    """``[-1, 5)`` of a dimension of 6 is empty: the port returns a ``[5,
    0]`` tensor without entries; the reference's ``bcoo_fromdense``
    raises on it (C49)."""
    j, t, idx, vals = draw(5, dup=True, nnz=12)
    got = TS.slice(t, [1], [-1], [5])
    assert got.shape == [5, 0] and got.nnz == 0
    assert tuple(got.to_dense().shape) == (5, 0)
    with pytest.raises(TypeError):
        JS.slice(j, [1], [-1], [5])


def test_duplicates_until_coalesce():
    """Duplicates stay stored (the reference's ``nse`` counts them) until
    ``coalesce``, which sums them in row-major order."""
    idx, vals = [[0, 0, 1], [1, 1, 0]], [1.0, 2.0, 3.0]
    t, j = TS.sparse_coo_tensor(idx, vals, [2, 2]), JS.sparse_coo_tensor(
        idx, vals, [2, 2])
    assert t.nnz == j.nnz == 3
    close(t.to_dense(), j.to_dense(), "duplicates to dense")
    same_coo(TS.coalesce(t), JS.coalesce(j), "coalesce")
    same_coo(TS.relu(t), JS.relu(j), "relu keeps duplicates")


# -- the value ops ----------------------------------------------------------

UNARY = ["sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
         "sqrt", "square", "abs", "neg", "expm1", "log1p", "rad2deg",
         "deg2rad", "isnan", "relu"]
#: unary ops defined only on (0, 1) or [0, inf)
UNIT = {"asin", "atanh", "sqrt", "log1p"}


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("name", UNARY)
def test_unary(name, fmt):
    if fmt == "coo":
        j, t, idx, vals = draw(6, positive=name in UNIT)
        if name in UNIT:
            j = JS.sparse_coo_tensor(idx, vals / 5, [5, 6])
            t = TS.sparse_coo_tensor(idx, vals / 5, [5, 6])
    else:
        j, t = draw_csr(6, positive=name in UNIT)
        if name in UNIT:
            j, t = JS.multiply(j, paddle.to_tensor(np.float32(0.2))), None
            j = j.to_sparse_csr()
            t = TS.sparse_csr_tensor(npy(j.crows()), npy(j.cols()),
                                     npy(j.values()), j.shape)
    got = getattr(TS, name)(t)
    want = getattr(JS, name)(j)
    if (name, fmt) == ("isnan", "csr"):
        # the reference's to_dense sums with add, which refuses bool
        assert isinstance(got, TS.SparseCsrTensor)
        for part in ("crows", "cols", "values"):
            np.testing.assert_array_equal(npy(getattr(got, part)()),
                                          npy(getattr(want, part)()))
        assert not npy(got.to_dense()).any()
        return
    if type(want).__name__ == "SparseCsrTensor":
        same_csr(got, want, f"{name} csr")
    else:
        same_coo(got, want, f"{name} {fmt}")


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_pow_and_cast(fmt):
    j, t = (draw(7)[:2] if fmt == "coo" else draw_csr(7))
    check = same_coo if fmt == "coo" else same_csr
    check(TS.pow(t, 3), JS.pow(j, 3), "pow")
    got = TS.cast(t, "int32", "float64")
    want = JS.cast(j, "int32", "float64")
    # float64 stays float64 in the port; the reference narrows (C26)
    assert got.dtype == torch.float64 and want.dtype == np.float32
    idx = got.indices() if fmt == "coo" else got.cols()
    assert idx.dtype == torch.int32
    check(TS.cast(got, value_dtype="float32"), want, "cast")


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_subtract_and_divide(fmt):
    j1, t1 = (draw(8)[:2] if fmt == "coo" else draw_csr(8))
    j2, t2 = (draw(9)[:2] if fmt == "coo" else draw_csr(9))
    same_coo(TS.subtract(t1, t2), JS.subtract(j1, j2), "sparse - sparse")
    d = dense(10, (5, 6))
    close(TS.subtract(t1, torch.tensor(d)),
          JS.subtract(j1, paddle.to_tensor(d)), "sparse - dense")
    dd = np.where(np.abs(d) < 0.2, 0.2, d).astype(np.float32)
    got = TS.divide(t1, torch.tensor(dd))
    want = JS.divide(j1, paddle.to_tensor(dd))
    (same_coo if fmt == "coo" else same_csr)(got, want, "sparse / dense")
    got = TS.divide(t1, TS.abs(t1))
    want = JS.divide(j1, JS.abs(j1))
    (same_coo if fmt == "coo" else same_csr)(got, want, "sparse / sparse")
    with pytest.raises(ValueError):
        TS.divide(t1, t2)
    with pytest.raises(ValueError):
        JS.divide(j1, j2)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_add_mixed_and_same_shape(fmt):
    j, t = (draw(11)[:2] if fmt == "coo" else draw_csr(11))
    d = dense(12, (5, 6))
    close(TS.add(t, torch.tensor(d)), JS.add(j, paddle.to_tensor(d)),
          "sparse + dense")
    close(TS.add(torch.tensor(d), t), JS.add(paddle.to_tensor(d), j),
          "dense + sparse")
    assert TS.is_same_shape(t, torch.tensor(d))
    assert not TS.is_same_shape(t, torch.zeros(6, 5))
    assert TS.is_sparse(t) and not TS.is_sparse(torch.tensor(d))
