"""The context split of the port's per-token ragged kernels (kernel 8 and
B9, the ``"cluster"`` variant) on the CPU, where the kernel itself cannot
run.

The kernel keeps ROADMAP C21 (the q-block kernel's bits on every row)
while S blocks of a cluster share one token's pages: the page maxima are
exchanged, every page's weights, sum, corr and pv are computed against the
running max before and after it, and one fold takes the pages in page
order. ``token_split_model``, that algorithm in PyTorch, must give the
plain version's bits (``token_attention_plain``, the same operations in
the same order) for every split count and round size, native and int8;
planted faults in the schedule, the maxima or the fold must break those
bits, merges that are right to fp32 rounding included. The model is also
held to the JAX package's per-token Pallas kernels in interpret mode, and
the rule, the schedule and the shared-memory formula are checked.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.models.generation import quantize_kv_rows
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

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


#: the plain version vs the JAX kernels: the same fp32 recurrence in the
#: same page order, only the dot's summation order differs (as in
#: test_torch_ragged_attention.py)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
#: a merge that is right but not C21 moves only the fp32 rounding
ROUNDING = dict(rtol=1e-5, atol=1e-5)

PAGE = trpa.SPLIT_PAGE

# (spans (slot, q_start, q_len, ctx), tokens, heads, kv_heads,
# pages_per_seq); head_dim 32
LAYOUTS = {
    # decode spans, a 37-token prefill, two slots aliasing a prefix (see
    # _case), one context of 19 pages, and 3 padding tokens
    "synthetic": ([(0, 0, 1, 300), (1, 1, 1, 33), (2, 2, 1, 1),
                   (3, 3, 37, 137), (4, 40, 20, 84), (5, 60, 1, 70)], 64,
                  8, 2, 24),
    # every token sees 1 key of a 128-page table (the engine's idle rows)
    "ctx_one_wide_table": ([(s, s, 1, 1) for s in range(6)], 6, 8, 2, 128),
    # one to three pages under up to eight splits
    "fewer_pages_than_splits": ([(0, 0, 1, 5), (1, 1, 1, 20), (2, 2, 1, 40)],
                                3, 8, 2, 8),
    # contexts that end on a page edge
    "page_edges": ([(s, s, 1, 16 * (s + 1)) for s in range(5)] +
                   [(5, 5, 2, 128)], 7, 8, 2, 10),
    # one query head a kv head
    "group_one": ([(0, 0, 1, 90), (1, 1, 3, 33), (2, 4, 1, 7)], 5, 2, 2, 8),
    # a single token, as a lone decode tick pads to
    "one_token": ([(0, 0, 1, 500)], 1, 8, 2, 40),
    # contexts of 44 pages: many rounds at every split count
    "multi_round": ([(0, 0, 1, 700), (1, 1, 5, 650)], 8, 8, 2, 48),
}


def _case(name, seed=0):
    spans, T, heads, kvh, pps = LAYOUTS[name]
    nslots = max(s[0] for s in spans) + 1
    rng = np.random.RandomState(seed + len(name))
    n_pages = nslots * pps + 1                        # page 0 = scratch
    kp = rng.randn(kvh, n_pages, PAGE, 32).astype(np.float32)
    vp = rng.randn(kvh, n_pages, PAGE, 32).astype(np.float32)
    tbl = (rng.permutation(nslots * pps).reshape(nslots, pps) + 1).astype(
        np.int32)
    if name == "synthetic":
        tbl[5, :4] = tbl[4, :4]                       # a shared prefix
    q = rng.randn(T, heads, 32).astype(np.float32)
    desc = tuple(np.asarray([x[i] for x in spans], np.int32)
                 for i in range(4))
    plan = trpa.make_plan(T, *desc, tbl, PAGE, impl="token")
    return dict(q=torch.from_numpy(q), kp=torch.from_numpy(kp),
                vp=torch.from_numpy(vp), tbl=tbl, desc=desc, plan=plan,
                np=(q, kp, vp))


def _int8(c):
    (kq, ks), (vq, vs) = quantize_kv_rows(c["kp"]), quantize_kv_rows(c["vp"])
    return kq, vq, (ks, vs)


def _scale(c):
    return c["q"].shape[-1] ** -0.5


def _plain(c, quant=False):
    if quant:
        kq, vq, scales = _int8(c)
        return trpa.token_attention_plain(c["q"], kq, vq, c["plan"],
                                          _scale(c), *scales)
    return trpa.token_attention_plain(c["q"], c["kp"], c["vp"], c["plan"],
                                      _scale(c))


def _model(c, splits, quant=False, **kw):
    if quant:
        kq, vq, scales = _int8(c)
        return trpa.token_split_model(c["q"], kq, vq, c["plan"], _scale(c),
                                      splits, *scales, **kw)
    return trpa.token_split_model(c["q"], c["kp"], c["vp"], c["plan"],
                                  _scale(c), splits, **kw)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# ---------------------------------------------------------------------------
# the schedule, the rule and the shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", range(1, trpa.MAX_SPLITS + 1))
def test_rounds_deal_every_page_once(splits):
    for c in range(1, trpa.MAX_ROUND_PAGES + 1):
        for n_pages in range(0, 45):
            dealt = [trpa.token_split_rounds(s, splits, n_pages, c)
                     for s in range(splits)]
            n_rounds = -(-n_pages // (splits * c))
            assert all(len(rounds) == n_rounds for rounds in dealt)
            seen = []
            for k in range(n_rounds):
                pages = [p for rounds in dealt for p in rounds[k]]
                # the round's pages, in block order, are its pages in order
                assert pages == list(range(k * splits * c, min(
                    (k + 1) * splits * c, n_pages))), (splits, c, n_pages)
                for s, rounds in enumerate(dealt):
                    assert len(rounds[k]) <= c
                    assert all(p // c % splits == s for p in rounds[k])
                seen += pages
            assert seen == list(range(n_pages))


# (tokens, kv_heads, pages_per_seq, SMs) -> splits
PLANS = {
    "mixed_tick": ((256, 8, 128, 132), 1),
    "pure_decode_tick": ((8, 8, 128, 132), 5),
    "one_token_capped": ((1, 8, 128, 132), trpa.MAX_SPLITS),
    "two_round_table": ((1, 8, 5, 132), 2),
    "one_page_table": ((8, 8, 1, 132), 1),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_splits_from_shapes_within_the_cluster_cap(name):
    (tokens, kvh, pps, n_sm), want = PLANS[name]
    s = trpa.token_splits(tokens, kvh, pps, n_sm)
    assert s == want
    cap = min(trpa.MAX_SPLITS, -(-pps // trpa.ROUND_PAGES))
    assert 1 <= s <= cap
    assert s * tokens * kvh >= trpa.SPLIT_BLOCKS_PER_SM * n_sm or s == cap


def test_rule_takes_the_main_path_and_names_the_rest():
    """The cluster kernel takes Llama-3-8B's ticks (page 16, head_dim
    128, fp32, bf16 or int8 pages); a page of 8, a head_dim that is no
    multiple of 16 and a misaligned pool take the block kernel."""
    q = torch.zeros(256, 32, 128, dtype=torch.bfloat16)
    kp = torch.zeros(8, 300, 16, 128, dtype=torch.bfloat16)
    assert trpa.token_variant(q, kp, kp, 128, 132) == ("cluster", 1)
    assert trpa.token_variant(q[:8], kp, kp, 128, 132) == ("cluster", 5)
    assert trpa.token_variant(q.float(), kp.float(), kp.float(), 128,
                              132) == ("cluster", 1)
    codes = torch.zeros(8, 300, 16, 128, dtype=torch.int8)
    scales = torch.zeros(8, 300, 16)
    assert trpa.token_variant(q[:8], codes, codes, 128, 132, scales,
                              scales) == ("cluster", 5)
    for d, page in ((128, 8), (72, 16), (40, 16)):
        pool = torch.zeros(8, 300, page, d)
        assert trpa.token_variant(torch.zeros(8, 32, d), pool, pool, 128,
                                  132) == ("block", 0), (d, page)
    shape = (8, 300, 16, 128)
    odd = torch.zeros(int(np.prod(shape)) + 1)[1:].view(shape)
    assert odd.data_ptr() % 16
    for pools in ((odd, kp.float()), (kp.float(), odd)):
        assert trpa.token_variant(q.float(), *pools, 128, 132)[0] == "block"
    odd_scales = torch.zeros(int(np.prod(shape[:3])) + 1)[1:].view(
        shape[:3])
    assert trpa.token_variant(q, codes, codes, 128, 132, odd_scales,
                              scales)[0] == "block"


def test_shared_memory_fits_at_the_captured_shapes():
    """Llama-3-8B's ticks (G = 4, head_dim 128) over the engine's
    128-page tables: the block's shared memory at the rule's splits, for
    fp32, bf16 and int8 pages, against the card's 227 KB; the formula's
    values are the C library's (chip_smoke.py holds the two equal)."""
    for tokens in (256, 8, 1):
        splits = trpa.token_splits(tokens, 8, 128, 132)
        for el, quant in ((4, False), (2, False), (1, True)):
            assert trpa.token_smem_bytes(el, quant, 4, 128, 128,
                                         splits) <= trpa.SMEM_LIMIT
    assert trpa.token_smem_bytes(2, False, 4, 128, 128, 1) == 57248
    assert trpa.token_smem_bytes(4, False, 4, 128, 128, 1) == 106400
    assert trpa.token_smem_bytes(1, True, 4, 128, 128, 5) == 30912
    # a block too large for the card takes the block kernel
    pool = torch.zeros(1, 4, 16, 2048)
    assert trpa.token_smem_bytes(4, False, 8, 2048, 4, 1) > trpa.SMEM_LIMIT
    assert trpa.token_variant(torch.zeros(2, 8, 2048), pool, pool, 4,
                              132) == ("block", 0)


# ---------------------------------------------------------------------------
# the model against the plain version, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", range(1, trpa.MAX_SPLITS + 1))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_model_gives_the_plain_bits(name, splits):
    c = _case(name)
    want = _plain(c)
    got = _model(c, splits)
    assert got.shape == want.shape
    assert _bits_equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("splits", [1, 3, 5, 8])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_int8_model_gives_the_plain_bits(name, splits):
    """int8 pages quantised by the cache's codec, dequantised row by row
    before both dots."""
    c = _case(name)
    assert _bits_equal(_model(c, splits, quant=True), _plain(c, quant=True))


@pytest.mark.parametrize("round_pages", range(1, trpa.MAX_ROUND_PAGES + 1))
def test_round_size_keeps_the_bits(round_pages):
    c = _case("multi_round")
    want = _plain(c)
    for splits in (1, 2, 7):
        assert _bits_equal(_model(c, splits, round_pages=round_pages), want)


def test_bf16_model_rounds_once():
    """A bf16 query runs the same fp32 algorithm and rounds once."""
    c = _case("synthetic")
    qb, kb, vb = (c[k].bfloat16() for k in ("q", "kp", "vp"))
    got = trpa.token_split_model(qb, kb, vb, c["plan"], _scale(c), 5)
    ref = trpa.token_split_model(qb.float(), kb.float(), vb.float(),
                                 c["plan"], _scale(c), 5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.bfloat16())


# ---------------------------------------------------------------------------
# the model against the JAX package's per-token Pallas kernels
# ---------------------------------------------------------------------------

def _span_rows(c):
    return np.concatenate([np.arange(a, a + n)
                           for a, n in zip(c["desc"][1], c["desc"][2])])


@pytest.mark.parametrize("name", ["synthetic", "fewer_pages_than_splits",
                                  "group_one", "page_edges"])
def test_model_matches_interpret_kernel(name, monkeypatch):
    c = _case(name)
    q, kp, vp = c["np"]
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "token")
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(c["tbl"]), *c["desc"], interpret=True))
    rows = _span_rows(c)
    splits = trpa.token_splits(q.shape[0], kp.shape[0], c["tbl"].shape[1],
                               132)
    got = _model(c, splits)
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **KERNEL_TOL)


@pytest.mark.parametrize("name", ["fewer_pages_than_splits", "group_one"])
def test_int8_model_matches_interpret_kernel(name, monkeypatch):
    c = _case(name)
    kq, vq, (ks, vs) = _int8(c)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "token")
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["np"][0]), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(c["tbl"]), *c["desc"],
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()),
        interpret=True))
    rows = _span_rows(c)
    for splits in (1, 5, 8):
        got = _model(c, splits, quant=True)
        np.testing.assert_allclose(got.numpy()[rows], want[rows],
                                   **KERNEL_TOL)


# ---------------------------------------------------------------------------
# planted faults: each must break the bits
# ---------------------------------------------------------------------------

def _fold_out_of_order(module):
    orig = module.ordered_fold

    def ordered_fold(acc, l, parts):
        return orig(acc, l, parts[::-1])
    return "ordered_fold", ordered_fold


def _stale_prefix(module):
    def round_maxima(m, parts):
        """Each page's running max from the round's carried max alone, as
        if the maxima of the round's earlier pages were not exchanged."""
        out = m
        for part in parts:
            part["m_prev"] = m
            part["m_new"] = torch.where(part["live"],
                                        torch.maximum(m, part["mcur"]), m)
            out = torch.where(part["live"],
                              torch.maximum(out, part["mcur"]), out)
        return out
    return "round_maxima", round_maxima


def _drop_last_page(module):
    orig = module.token_split_rounds

    def token_split_rounds(split, splits, n_pages, round_pages=None):
        rounds = orig(split, splits, n_pages, round_pages)
        if split == splits - 1:
            for pages in reversed(rounds):
                if pages:
                    pages.pop()
                    break
        return rounds
    return "token_split_rounds", token_split_rounds


def _partial_merge(module):
    def ordered_fold(acc, l, parts):
        """Each block's partial (m, l, acc) over its pages of the round,
        merged in block order into the carried state, as paged decode's
        cluster kernel merges: right to fp32 rounding, not C21."""
        inf = module.NEG_INF
        m0, M = parts[0]["m_prev"], parts[-1]["m_new"]
        f = torch.where(torch.isneginf(m0), 0.0, torch.exp(m0 - M))
        L, A = l * f, acc * f
        for split in sorted({part["split"] for part in parts}):
            mine = [part for part in parts if part["split"] == split]
            ms = torch.stack([torch.where(p["live"], p["mcur"], inf)
                              for p in mine]).amax(0)
            ls, As = 0.0, 0.0
            for p in mine:
                w = torch.where(p["live"], torch.exp(p["s"] - ms), 0.0)
                ls = ls + w.sum(-1, keepdim=True)
                As = As + w @ p["v"]
            fs = torch.where(torch.isneginf(ms), 0.0, torch.exp(ms - M))
            L, A = L + ls * fs, A + As * fs
        return A, L
    return "ordered_fold", ordered_fold


def _global_max(module):
    def round_maxima(m, parts):
        """Every page's weights against the round's max, once over all its
        pages (a two-pass softmax per round): right to fp32 rounding, not
        C21."""
        M = m
        for part in parts:
            M = torch.where(part["live"], torch.maximum(M, part["mcur"]), M)
        prev = m
        for part in parts:
            part["m_prev"], part["m_new"] = prev, M
            prev = M
        return M
    return "round_maxima", round_maxima


#: fault -> (its patch, whether the faulty algorithm is still right to
#: fp32 rounding)
FAULTS = {
    "fold_out_of_page_order": (_fold_out_of_order, False),
    "prefix_max_from_previous_round": (_stale_prefix, False),
    "block_drops_its_last_page": (_drop_last_page, False),
    "partial_merge_in_place_of_the_fold": (_partial_merge, True),
    "weights_against_the_global_max": (_global_max, True),
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_breaks_the_bits(fault, quant, monkeypatch):
    c = _case("synthetic")
    want = _plain(c, quant)
    splits = 3
    assert _bits_equal(_model(c, splits, quant), want)
    patch, still_close = FAULTS[fault]
    name, faulty = patch(trpa)
    monkeypatch.setattr(trpa, name, faulty)
    got = _model(c, splits, quant)
    assert not _bits_equal(got, want), fault
    if still_close:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **ROUNDING)
    else:
        assert float((got - want).abs().max()) > 1e-3, fault


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_cpu_tensor_runs_plain_under_any_variant(quant):
    """A CPU tensor runs the plain version whatever variant is asked, and
    no kernel is counted; an unknown variant raises."""
    c = _case("page_edges")
    want = _plain(c, quant)
    fn = trpa.token_attention_q8 if quant else trpa.token_attention
    counters = ("launches", "cluster_launches", "block_launches")
    before = [getattr(f, a) for f in (trpa.token_attention,
                                      trpa.token_attention_q8)
              for a in counters]
    if quant:
        kq, vq, (ks, vs) = _int8(c)
        args = (c["q"], kq, vq, ks, vs, c["plan"], _scale(c))
    else:
        args = (c["q"], c["kp"], c["vp"], c["plan"], _scale(c))
    for variant in (None, *trpa.TOKEN_VARIANTS):
        assert torch.equal(fn(*args, variant=variant), want)
    assert [getattr(f, a) for f in (trpa.token_attention,
                                    trpa.token_attention_q8)
            for a in counters] == before
    with pytest.raises(ValueError, match="variant"):
        fn(*args, variant="tensor_cores")
