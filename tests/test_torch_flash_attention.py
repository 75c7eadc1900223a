"""Parity of the port's flash attention, forward and backward, with the
JAX reference.

The same seeded numpy inputs go through ``paddle_tpu``'s Pallas kernels in
interpret mode (``flash_attention`` / ``flash_attention_with_lse`` with
``interpret=True``, the reference's default 128 x 128 blocks; gradients by
``jax.vjp`` through its custom VJP) and through ``paddle_tpu_torch``'s
plain versions of the CUDA kernels, which is what a CPU tensor runs.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.framework.core import Tensor

from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops import flash_attention as tfa

# the package re-exports functions of the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: plain version vs the interpret-mode kernel: the same fp32 recurrence
#: over the same tiles; only the dots' summation order differs (XLA vs
#: PyTorch CPU matmul), worth a few ulp of values of order 1-10
TOL = dict(rtol=1e-5, atol=1e-5)

# (b, hq, hk, sq, sk, d, causal, q_offset, kv_offset)
CASES = {
    "causal_mha": (2, 2, 2, 128, 128, 64, True, 0, 0),
    # 200 rows: two q-blocks of 128, the second padded
    "causal_gqa_ragged": (1, 4, 2, 200, 200, 32, True, 0, 0),
    "noncausal_gqa": (2, 4, 1, 96, 150, 32, False, 0, 0),
    # a prefill chunk after 170 cached tokens: bottom-right alignment
    "chunk_offset": (1, 2, 1, 130, 300, 64, True, 170, 0),
    # shorter than the minimum block of 8: padded keys and queries
    "short": (1, 2, 2, 5, 5, 16, True, 0, 0),
    # rows 0..39 see no key; their q-block's only tile still runs
    "dead_rows": (1, 2, 1, 64, 100, 32, True, 0, 40),
    # rows 0..149 see no key: block 0 runs no tile, block 1 runs tile 0
    "dead_rows_two_blocks": (1, 2, 2, 200, 300, 16, True, 0, 150),
}


def _inputs(b, hq, hk, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hk, sk, d).astype(np.float32),
            rng.randn(b, hk, sk, d).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_interpret_kernel(name):
    b, hq, hk, sq, sk, d, causal, qo, ko = CASES[name]
    q, k, v = _inputs(b, hq, hk, sq, sk, d, len(name))
    want, want_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=qo, kv_offset=ko, interpret=True)
    got, got_lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=qo, kv_offset=ko)
    assert got.dtype == torch.float32 and got_lse.dtype == torch.float32
    assert got.shape == (b, hq, sq, d) and got_lse.shape == (b, hq, sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_public_layout_matches_interpret_kernel():
    """``[b, s, h, d]`` in and out, as SDPA calls it."""
    q, k, v = _inputs(2, 4, 2, 160, 160, 64, 3)
    qs, ks, vs = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    want = jfa.flash_attention(jnp.asarray(qs), jnp.asarray(ks),
                               jnp.asarray(vs), causal=True, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(qs), torch.from_numpy(ks),
                              torch.from_numpy(vs), causal=True)
    assert got.shape == qs.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["causal_gqa_ragged", "chunk_offset",
                                  "dead_rows"])
def test_mha_reference_matches_jax(name):
    b, hq, hk, sq, sk, d, causal, qo, ko = CASES[name]
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 7)
    want, want_lse = jfa.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=qo, kv_offset=ko, with_lse=True)
    got, got_lse = tfa.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=qo, kv_offset=ko, with_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_dead_rows_follow_the_kernel_not_the_dense_reference():
    """A row with no valid key: the Pallas kernel returns the mean of V
    over the keys of its q-block's tiles that run (each masked key weighs
    exp(-1e30 - -1e30) = 1), while ``mha_reference`` returns zeros. The
    port follows the kernel. Rows with a valid key agree with both."""
    b, hq, hk, sq, sk, d, causal, qo, ko = CASES["dead_rows"]
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 11)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal, None, qo, ko)
    ref = tfa.mha_reference(tq, tk, tv, causal, None, qo, ko)
    dead = slice(0, ko - qo)
    # the only tile (100 keys, block_k = 100) runs for q-block 0
    mean_v = tv.mean(dim=2, keepdim=True).repeat_interleave(hq // hk, 1)
    np.testing.assert_allclose(out[:, :, dead].numpy(),
                               mean_v.expand(-1, -1, ko - qo, -1).numpy(),
                               **TOL)
    assert float(ref[:, :, dead].abs().max()) == 0.0
    assert bool((lse[:, :, dead] == tfa.NEG_INF).all())
    np.testing.assert_allclose(out[:, :, ko - qo:].numpy(),
                               ref[:, :, ko - qo:].numpy(), **TOL)


@pytest.mark.parametrize("sq,sk", [(128, 128), (128, 200), (160, 160)])
def test_sdpa_takes_flash_route_and_matches_jax(sq, sk, monkeypatch):
    """At ``seq_q >= 128`` and ``head_dim % 64 == 0`` the port's SDPA runs
    flash attention with ``q_offset = seq_k - seq_q`` (the JAX package
    takes its plain path on the CPU; both compute the same function)."""
    rng = np.random.RandomState(sq + sk)
    q = rng.randn(1, sq, 4, 64).astype(np.float32)
    k = rng.randn(1, sk, 2, 64).astype(np.float32)
    v = rng.randn(1, sk, 2, 64).astype(np.float32)
    calls = []
    real = tfa.flash_attention_plain

    def spy(*args, **kw):
        calls.append(args[5] if len(args) > 5 else kw.get("q_offset"))
        return real(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", spy)
    want = np.asarray(JF.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), is_causal=True, training=False)._data)
    got = scaled_dot_product_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), is_causal=True)
    assert calls == [sk - sq]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gradient_request_raises():
    """First-order gradients flow through the flash backward; a
    second-order request raises, as the backward is not itself
    differentiable (the reference's custom VJP has no rule for it)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 128, 128, 64, 0))
    q.requires_grad_(True)
    out = tfa.flash_attention(q, k, v, kernel_layout=True)
    (g,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    assert g.shape == q.shape and bool(torch.isfinite(g).all())
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), q)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, kernel_layout=True).shape \
            == q.shape


# ---------------------------------------------------------------------------
# backward: the port's gradients (plain version on CPU) against jax.vjp of
# the interpret-mode Pallas kernels (_bwd_dq_kernel, _bwd_dkv_kernel)
# ---------------------------------------------------------------------------

#: gradients relative to each one's max: the same fp32 recurrences, the
#: dots and the GQA sums taken in other orders by XLA and PyTorch
GRAD_RTOL = 1e-5

# (b, hq, hk, sq, sk, d, causal, q_offset, kv_offset)
BWD_CASES = {
    "causal_mha": (1, 2, 2, 128, 128, 64, True, 0, 0),
    "causal_gqa": (1, 4, 2, 128, 128, 64, True, 0, 0),
    "noncausal_gqa": (1, 4, 2, 128, 128, 64, False, 0, 0),
    # 200 rows and 333 keys: both padded to whole reference tiles
    "noncausal_ragged": (1, 4, 2, 200, 333, 64, False, 0, 0),
    # bottom-right alignment, as SDPA calls it
    "causal_ragged": (1, 4, 2, 200, 333, 64, True, 133, 0),
    # rows 0..39 see no key; their forward is the mean of V
    "dead_rows": (1, 4, 2, 64, 100, 64, True, 0, 40),
}


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _torch_grads(q, k, v, dout, case, g_lse=None):
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    if g_lse is None:
        out = tfa.flash_attention(tq, tk, tv, causal, None, qo, ko,
                                  kernel_layout=True)
        outs, cots = [out], [torch.from_numpy(dout)]
    else:
        out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal, None,
                                                qo, ko)
        outs, cots = [out, lse], [torch.from_numpy(dout),
                                  torch.from_numpy(g_lse)]
    return torch.autograd.grad(outs, (tq, tk, tv), cots)


def _jax_grads(q, k, v, dout, case, g_lse=None):
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    args = [jnp.asarray(x) for x in (q, k, v)]
    if g_lse is None:
        def f(q_, k_, v_):
            return jfa.flash_attention(q_, k_, v_, causal=causal,
                                       q_offset=qo, kv_offset=ko,
                                       interpret=True, kernel_layout=True)
        _, vjp = jax.vjp(f, *args)
        return vjp(jnp.asarray(dout))

    def f(q_, k_, v_):
        return jfa.flash_attention_with_lse(q_, k_, v_, causal=causal,
                                            q_offset=qo, kv_offset=ko,
                                            interpret=True)
    _, vjp = jax.vjp(f, *args)
    return vjp((jnp.asarray(dout), jnp.asarray(g_lse)))


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_matches_interpret_kernel_vjp(name):
    case = BWD_CASES[name]
    b, hq, hk, sq, sk, d = case[:6]
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 100 + len(name))
    dout = np.random.RandomState(len(name)).randn(b, hq, sq, d).astype(
        np.float32)
    got = _torch_grads(q, k, v, dout, case)
    want = _jax_grads(q, k, v, dout, case)
    for which, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, which
        assert _rel_err(g, w) <= GRAD_RTOL, (which, _rel_err(g, w))


@pytest.mark.parametrize("name", ["causal_ragged", "dead_rows"])
def test_backward_with_lse_cotangent_matches_interpret_kernel_vjp(name):
    """``flash_attention_with_lse`` differentiated through both outputs:
    the lse cotangent folds into delta (``_bwd``, ``:337-341``)."""
    case = BWD_CASES[name]
    b, hq, hk, sq, sk, d = case[:6]
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 200 + len(name))
    rng = np.random.RandomState(300 + len(name))
    dout = rng.randn(b, hq, sq, d).astype(np.float32)
    g_lse = rng.randn(b, hq, sq).astype(np.float32)
    got = _torch_grads(q, k, v, dout, case, g_lse)
    want = _jax_grads(q, k, v, dout, case, g_lse)
    without = _torch_grads(q, k, v, dout, case)
    for which, g, w, g0 in zip("qkv", got, want, without):
        assert _rel_err(g, w) <= GRAD_RTOL, (which, _rel_err(g, w))
        if which != "v":      # dlse/dv = 0: only q and k feel g_lse
            assert _rel_err(g0, w) > 1e-2, which


def test_public_layout_backward_matches_kernel_layout():
    """``[b, s, h, d]`` views, as SDPA passes them: the same gradients
    as the kernel layout, returned in the public layout."""
    case = BWD_CASES["causal_ragged"]
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 5)
    dout = np.random.RandomState(6).randn(b, hq, sq, d).astype(np.float32)
    want = _torch_grads(q, k, v, dout, case)
    ts = [torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).requires_grad_(True)
          for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal, q_offset=qo, kv_offset=ko)
    got = torch.autograd.grad(
        out, ts, torch.from_numpy(dout.transpose(0, 2, 1, 3).copy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.transpose(1, 2).numpy(), w.numpy())


def test_dead_rows_backward_follows_the_kernel_not_autograd():
    """A row with no valid key returns the mean of V in the forward, but
    the reference's backward gives it p = 0 on every key: zero dq, and
    nothing into dk or dv. Autograd through the plain forward would send
    its cotangent into V (the mean's gradient); the port's backward does
    not, and matches the interpret-mode kernel's VJP."""
    case = BWD_CASES["dead_rows"]
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    dead = ko - qo
    q, k, v = _inputs(b, hq, hk, sq, sk, d, 17)
    dout = np.zeros((b, hq, sq, d), np.float32)
    dout[:, :, :dead] = np.random.RandomState(18).randn(b, hq, dead, d)
    got = _torch_grads(q, k, v, dout, case)
    want = _jax_grads(q, k, v, dout, case)
    for g, w in zip(got, want):
        assert float(g.abs().max()) == 0.0
        assert float(np.abs(np.asarray(w)).max()) == 0.0
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, _ = tfa.flash_attention_plain(tq, tk, tv, causal, None, qo, ko)
    (dv_autograd,) = torch.autograd.grad(out, tv, torch.from_numpy(dout))
    assert float(dv_autograd.abs().max()) > 1e-2


def test_backward_plain_pieces_compose():
    """``flash_attention_bwd_plain`` is delta, then the dQ and dK/dV
    plain versions (what the CUDA wrappers check their kernels against),
    and the device-generic ``flash_attention_bwd`` gives the same on
    CPU tensors."""
    case = BWD_CASES["causal_ragged"]
    b, hq, hk, sq, sk, d, causal, qo, ko = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, hq, hk, sq, sk, d, 9))
    dout = torch.randn(b, hq, sq, d, generator=torch.Generator().manual_seed(0))
    out, lse = tfa.flash_attention_plain(q, k, v, causal, None, qo, ko)
    full = tfa.flash_attention_bwd_plain(q, k, v, out, lse, dout, None,
                                         causal, None, qo, ko)
    delta = tfa.bwd_delta(out, dout)
    assert delta.shape == (b, hq, sq) and delta.dtype == torch.float32
    dq = tfa.flash_bwd_dq(q, k, v, dout, lse, delta, causal, None, qo, ko)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, None, qo,
                               ko)
    generic = tfa.flash_attention_bwd(q, k, v, out, lse, dout, None, causal,
                                      None, qo, ko)
    for a, b_, c in zip(full, (dq, dk, dv), generic):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())
