"""The port's blockwise ring attention (``paddle_tpu_torch/ops/
ring_attention.py``) against the JAX package's
(``paddle_tpu/ops/pallas/ring_attention.py``): the schedule of B1 partials
merged block by block, through the reference's interpret-mode kernel and
its XLA tier, at the reference's own 2e-5 (``tests/test_sep_prefill.py:
54``); rows with no valid key in a block or in every block (ROADMAP C10);
the merge itself and its order; a 16-bit q over fp32 blocks."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import ring_attention as jra

from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import ring_attention as tra

#: the reference's tolerance for blockwise against dense attention
TOL = dict(rtol=2e-5, atol=2e-5)

#: the reference's tiers: its interpret-mode Pallas kernel and its XLA
#: reference, picked by ``PADDLE_SEP_RING_IMPL``
IMPLS = ("kernel", "xla")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, h=4, hk=2, sq=8, skv=32, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, h, sq, d)).astype(np.float32),
            rng.standard_normal((1, hk, skv, d)).astype(np.float32),
            rng.standard_normal((1, hk, skv, d)).astype(np.float32))


def _blocks(k, v, offsets, width, lib):
    """``(k, v, kv_offset)`` triples of ``width`` keys at each offset, the
    arrays as ``lib`` (jnp or torch) tensors."""
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    return [(conv(np.ascontiguousarray(k[:, :, o:o + width])),
             conv(np.ascontiguousarray(v[:, :, o:o + width])), o)
            for o in offsets]


def _reference(q, q_offset, k, v, offsets, width, impl, monkeypatch):
    monkeypatch.setenv("PADDLE_SEP_RING_IMPL", impl)
    out = jra.blockwise_causal_attention(
        jnp.asarray(q), q_offset, _blocks(k, v, offsets, width, jnp),
        interpret=True)
    return np.asarray(out, np.float32)


def _port(q, q_offset, k, v, offsets, width):
    out = tra.blockwise_causal_attention(
        torch.from_numpy(q), q_offset, _blocks(k, v, offsets, width, torch))
    return out.float().numpy()


@pytest.mark.parametrize("impl", IMPLS)
def test_blockwise_matches_the_reference(impl, monkeypatch):
    """The reference's case (q at positions 16-23 over four blocks of 8
    keys, the last one wholly in the future), with grouped-query heads:
    the port within 2e-5 of the reference's tier and of dense attention."""
    q, k, v = _inputs(0)
    offsets = (0, 8, 16, 24)
    want = _reference(q, 16, k, v, offsets, 8, impl, monkeypatch)
    got = _port(q, 16, k, v, offsets, 8)
    np.testing.assert_allclose(got, want, **TOL)
    dense = tfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                              q_offset=16).numpy()
    np.testing.assert_allclose(got, dense, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_uneven_blocks_and_offsets(impl, monkeypatch):
    """Blocks of 12 keys (a partial tile), queries at 30-37 and a block
    that starts past some of them."""
    q, k, v = _inputs(1, sq=8, skv=36, d=16)
    offsets = (0, 12, 24)
    want = _reference(q, 30, k, v, offsets, 12, impl, monkeypatch)
    np.testing.assert_allclose(_port(q, 30, k, v, offsets, 12), want, **TOL)


def test_rows_dead_in_one_block_drop_out_of_the_merge(monkeypatch):
    """C10: every query sees block 0 and none sees block 1 (keys 8-15 for
    queries 0-7). Block 1's partial has lse -1e30 on every row and weighs
    exactly 0 in the merge: the result is block 0's attention alone, on
    both of the reference's tiers."""
    q, k, v = _inputs(2, sq=8, skv=16)
    got = _port(q, 0, k, v, (0, 8), 8)
    alone = _port(q, 0, k, v, (0,), 8)
    np.testing.assert_array_equal(got, alone)
    for impl in IMPLS:
        np.testing.assert_allclose(
            got, _reference(q, 0, k, v, (0, 8), 8, impl, monkeypatch), **TOL)
    _, lse = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k[:, :, 8:]),
        torch.from_numpy(v[:, :, 8:]), q_offset=0, kv_offset=8)
    assert (lse == tfa.NEG_INF).all()


def test_rows_dead_in_every_block_follow_the_kernel(monkeypatch):
    """Queries 0-7 over one block of keys 4-11: the tile runs (query 7
    sees key 4), and queries 0-3 see no key anywhere. Such a row follows
    the reference's kernel tier (B1 gives it the mean of V over the
    tile's keys, lse -1e30, and the merge with the initial -1e30 halves
    it), not its XLA tier, which zeroes it (C10); the live rows agree on
    all three."""
    q, k, v = _inputs(3, sq=8, skv=16)
    got = _port(q, 0, k, v, (4,), 8)
    want = _reference(q, 0, k, v, (4,), 8, "kernel", monkeypatch)
    np.testing.assert_allclose(got, want, **TOL)
    xla = _reference(q, 0, k, v, (4,), 8, "xla", monkeypatch)
    assert np.abs(xla[:, :, :4]).max() == 0.0
    assert np.abs(got[:, :, :4]).min() > 0.0
    np.testing.assert_allclose(got[:, :, 4:], xla[:, :, 4:], **TOL)


def test_merge_matches_the_reference():
    """``_merge`` on random partials, a -1e30 lse among them, against the
    reference's ``_merge`` (logaddexp and two exps): 1e-6."""
    rng = np.random.default_rng(4)
    out, out_i = (rng.standard_normal((1, 2, 5, 8)).astype(np.float32)
                  for _ in range(2))
    lse, lse_i = (rng.standard_normal((1, 2, 5)).astype(np.float32) * 3
                  for _ in range(2))
    lse_i[0, 0, 0] = tfa.NEG_INF
    lse[0, 1, 2] = tfa.NEG_INF
    want = jra._merge(*(jnp.asarray(a) for a in (out, lse, out_i, lse_i)))
    got = tra._merge(*(torch.from_numpy(a) for a in (out, lse, out_i,
                                                     lse_i)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_merge_order_is_the_list_order(monkeypatch):
    """Blocks merge in the order given, as in the reference: the reversed
    list agrees with the reference's reversed list, and both orders
    agree with each other within the reference's tolerance."""
    q, k, v = _inputs(5)
    offsets = (24, 16, 8, 0)
    got = _port(q, 28, k, v, offsets, 8)
    np.testing.assert_allclose(
        got, _reference(q, 28, k, v, offsets, 8, "kernel", monkeypatch),
        **TOL)
    np.testing.assert_allclose(got, _port(q, 28, k, v, offsets[::-1], 8),
                               **TOL)


def test_bf16_q_over_fp32_blocks():
    """A 16-bit q (``auto_cast`` O2 casts q alone) over fp32 blocks: each
    partial runs B1's fp32 version on the upcast q and is rounded to bf16
    before the fp32 merge, then the result is cast to bf16; bit-equal to
    spelling that out, and within one bf16 unit (2^-8, relative to the
    largest value) of the reference's kernel, which upcasts q, k and v
    and writes each partial in q's dtype."""
    q, k, v = _inputs(6)
    offsets = (0, 8, 16, 24)
    qb = torch.from_numpy(q).bfloat16()
    got = tra.blockwise_causal_attention(
        qb, 16, _blocks(k, v, offsets, 8, torch))
    assert got.dtype == torch.bfloat16
    out = torch.zeros(q.shape)
    lse = torch.full(q.shape[:3], tfa.NEG_INF)
    for kb, vb, off in _blocks(k, v, offsets, 8, torch):
        o, s = tfa.flash_attention_plain(qb.float(), kb, vb,
                                         q_offset=16, kv_offset=off)
        out, lse = tra._merge(out, lse, o.bfloat16().float(), s)
    np.testing.assert_array_equal(got.float().numpy(),
                                  out.bfloat16().float().numpy())
    want = np.asarray(jra.blockwise_causal_attention(
        jnp.asarray(q, jnp.bfloat16), 16, _blocks(k, v, offsets, 8, jnp),
        impl="kernel", interpret=True).astype(jnp.float32))
    bound = 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= bound
