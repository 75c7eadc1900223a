"""Parity of the port's ragged paged attention with the JAX reference.

The same seeded numpy inputs go through ``paddle_tpu``'s
``ragged_paged_attention`` (Pallas kernels in interpret mode, grid picked
with ``PADDLE_TPU_RAGGED_IMPL``) and through ``paddle_tpu_torch``'s plain
versions of the two CUDA kernels, which are what a CPU tensor runs.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.ops import ragged_paged_attention as trpa

# the package re-exports a function of the module's name
jrpa = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: plain versions vs the JAX kernels: the same fp32 online-softmax
#: recurrence in the same page order; only the dot's summation order
#: differs (XLA vs PyTorch CPU matmul), worth a few ulp
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
#: vs the dense reference: a one-shot softmax instead of the online
#: recurrence (the reference's own tolerance, test_qblock_attention.py)
REF_TOL = dict(rtol=2e-5, atol=2e-5)


def _alias(tbl):
    tbl[1, :2] = tbl[0, :2]        # slot 1 reuses slot 0's prefix pages


# (spans (slot, q_start, q_len, ctx), tokens, q_block, table edit, seed)
LAYOUTS = {
    # a 9-token prefill straddles blocks 0->1, a 6-token chunk 1->2
    "straddling": ([(0, 0, 1, 31), (1, 1, 9, 25), (2, 10, 6, 6),
                    (3, 16, 1, 4)], None, 8, None, 0),
    # every span one token: one block carries several owners
    "pure_decode": ([(0, 0, 1, 7), (1, 1, 1, 19), (2, 2, 1, 32),
                     (3, 3, 1, 1)], None, 8, None, 0),
    # a prefix-cache hit: two tables share leading pages
    "aliased_prefix": ([(0, 0, 1, 20), (1, 1, 3, 19)], None, 8, _alias, 7),
    # spans end at 10 of 24 tokens: blocks 1..2 are pure padding
    "padded_tail": ([(0, 0, 4, 12), (1, 4, 6, 6)], 24, 8, None, 0),
    # q_block smaller than most spans: every span straddles
    "small_block": ([(0, 0, 7, 15), (1, 7, 5, 5), (2, 12, 1, 30)], None, 2,
                    None, 0),
}


def _case(name, heads=4, kv_heads=2, d=32, page=8, pages_per_seq=4):
    spans, tokens, q_block, edit, seed = LAYOUTS[name]
    nslots = max(s[0] for s in spans) + 1
    rng = np.random.RandomState(seed)
    npages = nslots * pages_per_seq + 1          # page 0 = scratch
    kp = rng.randn(kv_heads, npages, page, d).astype(np.float32)
    vp = rng.randn(kv_heads, npages, page, d).astype(np.float32)
    tbl = np.zeros((nslots, pages_per_seq), np.int32)
    for s in range(nslots):
        tbl[s] = np.arange(1 + s * pages_per_seq, 1 + (s + 1) * pages_per_seq)
    if edit is not None:
        edit(tbl)
    desc = tuple(np.asarray([x[i] for x in spans], np.int32)
                 for i in range(4))
    T = tokens or int((desc[1] + desc[2]).max())
    q = np.random.RandomState(seed + 1).randn(T, heads, d).astype(np.float32)
    return dict(q=q, kp=kp, vp=vp, tbl=tbl, desc=desc, q_block=q_block,
                page=page, spans=spans)


def _span_rows(c):
    return np.concatenate([np.arange(qs, qs + ql)
                           for _, qs, ql, _ in c["spans"]])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_schedule_matches_jax(name):
    c = _case(name)
    T = c["q"].shape[0]
    want = jrpa.qblock_schedule(T, *c["desc"], c["tbl"], c["q_block"],
                                c["page"])
    got = trpa.qblock_schedule(T, *c["desc"], c["tbl"], c["q_block"],
                               c["page"])
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    want_tok = jrpa._token_descriptors(T, *c["desc"])
    got_tok = trpa._token_descriptors(T, *c["desc"])
    for w, g in zip(want_tok, got_tok):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("impl", trpa.IMPLS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_versions_match_jax_kernels(name, impl, monkeypatch):
    c = _case(name)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", impl)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_QBLOCK", str(c["q_block"]))
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tbl"]), *c["desc"], interpret=True))
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    got = trpa.ragged_paged_attention(q, kp, vp, c["tbl"], *c["desc"],
                                      impl=impl, q_block=c["q_block"])
    rows = _span_rows(c)                         # padding rows are garbage
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **KERNEL_TOL)
    ref = trpa.ragged_paged_attention_reference(q, kp, vp, c["tbl"],
                                                *c["desc"])
    np.testing.assert_allclose(got.numpy()[rows], ref.numpy()[rows],
                               **REF_TOL)
    jref = np.asarray(jrpa.ragged_paged_attention_reference(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        c["tbl"], *c["desc"]))
    np.testing.assert_allclose(ref.numpy(), jref, **REF_TOL)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """A CPU tensor takes the plain version: no kernel, no launch count.
    An unknown grid name is refused."""
    c = _case("straddling")
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    before = (trpa.qblock_attention.launches, trpa.token_attention.launches)
    plan = trpa.make_plan(q.shape[0], *c["desc"], c["tbl"], c["page"],
                          impl="qblock")
    a = trpa.qblock_attention(q, kp, vp, plan, 32 ** -0.5)
    b = trpa.qblock_attention_plain(q, kp, vp, plan, 32 ** -0.5)
    assert torch.equal(a, b)
    assert (trpa.qblock_attention.launches,
            trpa.token_attention.launches) == before
    with pytest.raises(ValueError):
        trpa.make_plan(q.shape[0], *c["desc"], c["tbl"], c["page"],
                       impl="xla")
    with pytest.raises(ValueError):
        trpa.ragged_paged_attention(q, kp, vp, c["tbl"], *c["desc"],
                                    impl="xla")


def test_bf16_plain_versions_track_fp32():
    """bf16 inputs accumulate in fp32 and return bf16, within bf16
    rounding of the fp32 result."""
    c = _case("straddling")
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    rows = _span_rows(c)
    for impl in trpa.IMPLS:
        f32 = trpa.ragged_paged_attention(q, kp, vp, c["tbl"], *c["desc"],
                                          impl=impl)
        bf = trpa.ragged_paged_attention(
            q.bfloat16(), kp.bfloat16(), vp.bfloat16(), c["tbl"],
            *c["desc"], impl=impl)
        assert bf.dtype == torch.bfloat16
        np.testing.assert_allclose(bf.float().numpy()[rows],
                                   f32.numpy()[rows], rtol=2e-2, atol=2e-2)
