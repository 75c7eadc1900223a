"""Parity of the port's flash attention forward with the JAX reference.

The same seeded numpy inputs go through ``paddle_tpu``'s Pallas kernel in
interpret mode (``flash_attention`` / ``flash_attention_with_lse`` with
``interpret=True``, the reference's default 128 x 128 blocks) and through
``paddle_tpu_torch``'s plain version of the CUDA kernel, which is what a
CPU tensor runs.
"""
import importlib

import numpy as np
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
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 128, 128, 64, 0))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tfa.flash_attention(q, k, v, kernel_layout=True)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, kernel_layout=True).shape \
            == q.shape
