"""The port's ``sparse`` (``paddle_tpu_torch/sparse/__init__.py``) against
the reference's (``paddle_tpu/sparse/__init__.py``) on the CPU: the
structure ops (``transpose``, ``reshape``, ``mask_as``), the products
(``matmul`` on either side with its gradients, ``mv``, ``addmm``,
``masked_matmul``), ``softmax``, the values' gradients, the
constructors' device, ``nn.functional.attention`` against the reference
and SDPA's boolean mask, and the sparse convolutions with weights
carried by ``convert``. The rule and the helpers are
``tests/test_torch_sparse.py``'s."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import sparse as JS

import paddle_tpu_torch as pt
from paddle_tpu_torch import sparse as TS
from test_torch_sparse import (close, dense, draw, draw_csr, npy, same_coo,
                               same_csr)
from torch_vision_common import port_on_cpu  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def test_transpose_keeps_the_order():
    j, t, idx, vals = draw(13, shape=(3, 4, 5), nnz=10, dup=True)
    for perm in ([1, 0, 2], [2, 0, 1]):
        same_coo(TS.transpose(t, perm), JS.transpose(j, perm),
                 f"transpose {perm}")
    jc, tc = draw_csr(14)
    same_csr(TS.transpose(tc, [1, 0]), JS.transpose(jc, [1, 0]),
             "transpose csr")


def test_reshape():
    """The reference's ``bcoo_reshape`` returns batched BCOO layouts for
    some shapes (indices ``[nnz, 1, 1]``); the port's COO is plain. The
    dense results agree, and the indices of a 1-D result are equal."""
    j, t, idx, vals = draw(15, nnz=10)
    got, want = TS.reshape(t, [30]), JS.reshape(j, [30])
    same_coo(got, want, "reshape to 1-D")
    for shape in ([3, -1], [2, 3, 5], [1, -1]):
        got, want = TS.reshape(t, shape), JS.reshape(j, shape)
        assert got.shape == want.shape
        close(got.to_dense(), want.to_dense(), f"reshape {shape}")
        assert got.nnz == 10


def test_mask_as_mv_addmm():
    j, t, idx, vals = draw(16)
    jc, tc = draw_csr(16)
    d = dense(17, (5, 6))
    same_coo(TS.mask_as(torch.tensor(d), t),
             JS.mask_as(paddle.to_tensor(d), j), "mask_as coo")
    same_csr(TS.mask_as(torch.tensor(d), tc),
             JS.mask_as(paddle.to_tensor(d), jc), "mask_as csr")
    v = dense(18, (6,))
    close(TS.mv(t, torch.tensor(v)), JS.mv(j, paddle.to_tensor(v)), "mv")
    close(TS.mv(tc, torch.tensor(v)), JS.mv(jc, paddle.to_tensor(v)),
          "mv csr")
    y, base = dense(19, (6, 4)), dense(20, (5, 4))
    close(TS.addmm(torch.tensor(base), t, torch.tensor(y), 0.5, 2.0),
          JS.addmm(paddle.to_tensor(base), j, paddle.to_tensor(y), 0.5, 2.0),
          "addmm")


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_matmul_both_sides_and_gradients(fmt):
    j, t = (draw(21)[:2] if fmt == "coo" else draw_csr(21))
    y = dense(22, (6, 3))
    jy = paddle.to_tensor(y)
    jy.stop_gradient = False
    ty = torch.tensor(y, requires_grad=True)
    w = dense(23, (5, 3))
    jout, tout = JS.matmul(j, jy), TS.matmul(t, ty)
    close(tout, jout, "sparse @ dense")
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.tensor(w)).sum().backward()
    close(ty.grad, jy.grad, "sparse @ dense, d dense")
    x = dense(24, (2, 4, 5))
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    tx = torch.tensor(x, requires_grad=True)
    w = dense(25, (2, 4, 6))
    jout, tout = JS.matmul(jx, j), TS.matmul(tx, t)
    close(tout, jout, "dense @ sparse")
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.tensor(w)).sum().backward()
    close(tx.grad, jx.grad, "dense @ sparse, d dense")
    d1, d2 = dense(26, (3, 4)), dense(27, (4, 2))
    close(TS.matmul(torch.tensor(d1), torch.tensor(d2)),
          JS.matmul(paddle.to_tensor(d1), paddle.to_tensor(d2)),
          "dense @ dense")


def test_masked_matmul_and_softmax():
    j, t, idx, vals = draw(28, shape=(5, 7), nnz=14, dup=True)
    x, y = dense(29, (5, 3)), dense(30, (3, 7))
    same_coo(TS.masked_matmul(torch.tensor(x), torch.tensor(y), t),
             JS.masked_matmul(paddle.to_tensor(x), paddle.to_tensor(y), j),
             "masked_matmul with duplicates")
    same_coo(TS.softmax(t), JS.softmax(j), "softmax with duplicates")
    jc, tc = draw_csr(31, shape=(5, 7), nnz=14)
    same_csr(TS.softmax(tc), JS.softmax(jc), "softmax csr")
    with pytest.raises(NotImplementedError):
        TS.softmax(t, axis=0)


def test_values_are_differentiable():
    idx = [[0, 1, 1], [0, 0, 2]]
    v = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    t = TS.sparse_coo_tensor(idx, v, [2, 3])
    (TS.tanh(t).values().sum() + TS.sum(TS.relu(t))).backward()
    want = (1 - np.tanh(npy(v)) ** 2) + (npy(v) > 0)
    np.testing.assert_allclose(npy(v.grad), want, rtol=1e-6)


def test_constructors_follow_the_current_device():
    """Values given as lists land on the current device (the CPU here,
    after ``set_device("cpu")``); without CUDA, the default device
    refuses them rather than run on the CPU."""
    t = TS.sparse_coo_tensor([[0], [1]], [1.0], [2, 2])
    assert t.values().device.type == "cpu"
    assert t.indices().dtype == torch.int64
    if not torch.cuda.is_available():
        prev = pt.get_device()
        pt.set_device("gpu")
        try:
            with pytest.raises(RuntimeError):
                TS.sparse_coo_tensor([[0], [1]], [1.0], [2, 2])
            with pytest.raises(RuntimeError):
                TS.sparse_csr_tensor([0, 1], [0], [1.0], [1, 2])
        finally:
            pt.set_device(prev)


# -- nn ---------------------------------------------------------------------

def bigbird_mask(seed, b, h, s, block, n_rand):
    """A boolean ``[b, h, s, s]`` BigBird-style pattern: sliding blocks,
    the first block global both ways, ``n_rand`` random blocks a row."""
    rng = np.random.default_rng(seed)
    nb = s // block
    m = np.zeros((b, h, nb, nb), bool)
    for i in range(nb):
        m[:, :, i, max(0, i - 1):i + 2] = True
        m[:, :, i, rng.choice(nb, n_rand)] = True
    m[:, :, 0, :] = m[:, :, :, 0] = True
    return np.kron(m, np.ones((block, block), bool)).astype(bool)


def test_attention():
    b, h, s, d = 2, 3, 32, 8
    q, k, v = (dense(32 + i, (b, h, s, d)) for i in range(3))
    m = bigbird_mask(35, b, h, s, 4, 1)
    idx = np.stack(np.nonzero(m.reshape(b * h, s, s)))
    ones = np.ones(idx.shape[1], np.float32)
    jm = JS.sparse_coo_tensor(idx, ones, [b * h, s, s])
    tm = TS.sparse_coo_tensor(idx, ones, [b * h, s, s])
    got = TS.nn.functional.attention(*(torch.tensor(a) for a in (q, k, v)),
                                     tm)
    want = JS.nn.functional.attention(*(paddle.to_tensor(a)
                                        for a in (q, k, v)), jm)
    close(got, want, "sparse attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(torch.tensor(a) for a in (q, k, v)), attn_mask=torch.tensor(m))
    close(got, sdpa, "sparse attention against SDPA's boolean mask")
    close(TS.nn.functional.attention(*(torch.tensor(a) for a in (q, k, v)),
                                     None),
          JS.nn.functional.attention(*(paddle.to_tensor(a)
                                       for a in (q, k, v)), None),
          "attention without a mask")


#: a submanifold conv keeps the grid: stride 1, padding 1 at kernel 3
@pytest.mark.parametrize("subm,stride,padding", [
    (True, 1, 1), (False, 1, 1), (False, 2, 1), (False, 1, 0)])
def test_sparse_conv3d(subm, stride, padding):
    rng = np.random.default_rng(36)
    shape = [2, 6, 7, 5, 4]
    flat = rng.choice(2 * 6 * 7 * 5, 12, replace=False)
    vox = np.stack(np.unravel_index(flat, shape[:4]))
    feats = rng.standard_normal((12, 4)).astype(np.float32)
    idx = np.concatenate([np.repeat(vox, 4, 1), np.tile(np.arange(4), 12)[
        None]], 0)
    vals = feats.reshape(-1)
    vals[5] = 0.0                     # a zero channel is not an entry
    jx = JS.sparse_coo_tensor(idx, vals, shape)
    tx = TS.sparse_coo_tensor(idx, vals, shape)
    cls = "SubmConv3D" if subm else "Conv3D"
    paddle.seed(3)
    jconv = getattr(JS.nn, cls)(4, 16, 3, stride=stride, padding=padding)
    tconv = getattr(TS.nn, cls)(4, 16, 3, stride=stride, padding=padding)
    assert tuple(tconv.weight.shape) == (16, 4, 3, 3, 3)
    w = np.asarray(jconv.weight.numpy())
    assert w.shape == (3, 3, 3, 4, 16)
    pt.load_jax_state(tconv, {"weight": w})
    np.testing.assert_array_equal(pt.jax_layout(tconv)["weight"], w)
    got, want = tconv(tx), jconv(jx)
    same_coo(got, want, f"{cls} stride {stride} padding {padding}")
    if subm:
        active = np.unique(npy(got.indices())[:4], axis=1)
        np.testing.assert_array_equal(active, np.unique(vox, axis=1))


def test_conv_weight_init_and_carry_errors():
    """The port draws its weight from the reference's XavierUniform limit
    for the DHWIO shape; a mis-shaped weight is refused."""
    conv = TS.nn.SubmConv3D(4, 16, 3)
    dhwio = (3, 3, 3, 4, 16)
    lim = math.sqrt(6.0 / (dhwio[1] * 3 * 4 * 16 + dhwio[0] * 3 * 4 * 16))
    w = npy(conv.weight)
    assert np.abs(w).max() <= lim and np.abs(w).max() > 0.9 * lim
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    with pytest.raises(ValueError):
        pt.load_jax_state(conv, {"weight": np.zeros((3, 3, 3, 16, 4),
                                                     np.float32)})
    relu = TS.nn.ReLU()
    t = TS.sparse_coo_tensor([[0, 1]], [-1.0, 2.0], [3])
    np.testing.assert_array_equal(npy(relu(t).values()), [0., 2.])
    assert TS.nn.functional.relu is TS.relu
