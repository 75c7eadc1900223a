"""The context split of the port's paged decode kernels (B4 and B5, the
``"cluster"`` variant) on the CPU, where the kernel itself cannot run.

The split plan deals every page of a context to exactly one split from
shapes alone; ``paged_decode_split_model``, the kernel's algorithm in
PyTorch (per-split partials over the dealt pages, merged in split order),
matches the plain version (1e-6 in fp32) and the JAX package's Pallas
decode kernels in interpret mode (the reference's 2e-5), native and int8,
on the shapes of ``test_torch_paged_attention.py`` and on edge cases; and
planted faults in the plan or the merge make it disagree.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.models.generation import quantize_kv_rows
from paddle_tpu_torch.ops import paged_attention as tpa

from test_torch_paged_attention import (CASES, _inputs, _tables_contiguous,
                                        _tables_shared)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the split model against the plain version: the same fp32 recurrence,
#: summed in another order (chunks of two pages, then the merge)
TIGHT = dict(rtol=1e-6, atol=1e-6)
#: the reference's own tolerance for its kernel (test_paged_attention.py)
TOL = dict(rtol=2e-5, atol=2e-5)
#: how far a planted fault must move the output
FAULT = 1e-3


def _tables_wide(batch, pps):
    """Permuted pages over a table far wider than the contexts (the legacy
    cache's 128 pages), unused entries 0."""
    t = np.zeros((batch, pps), np.int32)
    perm = np.random.RandomState(4).permutation(np.arange(1, batch * pps))
    t[:, :40] = perm[:batch * 40].reshape(batch, 40)
    return t


# (batch, heads, kv_heads, d, page, pages_per_seq, ctx, tables), at the
# kernel's page size 16
EDGE = {
    "ctx_one": (3, 8, 2, 32, 16, 6, (1, 1, 1), _tables_contiguous),
    # one to three pages: one or two chunks, most of five splits empty
    "fewer_pages_than_splits": (3, 8, 2, 32, 16, 8, (5, 20, 40),
                                _tables_shared),
    "page_edge": (3, 8, 2, 32, 16, 6, (16, 32, 96), _tables_contiguous),
    "group_one": (3, 4, 4, 32, 16, 6, (7, 90, 33), _tables_shared),
    "wide_table": (3, 8, 2, 32, 16, 128, (3, 200, 600), _tables_wide),
}
ALL = {**CASES, **EDGE}


def _case(name):
    if name in CASES:
        return _inputs(name)
    batch, heads, kvh, d, page, pps, ctx, tables = EDGE[name]
    rng = np.random.RandomState(len(name) + 100)
    n_pages = batch * pps + 1
    q = rng.randn(batch, heads, d).astype(np.float32)
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    return q, kp, vp, tables(batch, pps), np.asarray(ctx, np.int32)


def _torch(q, kp, vp, tbl, ctx):
    return (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            tbl, ctx)


def _plain(q, kp, vp, tbl, ctx, scales=()):
    return tpa.paged_decode_plain(q, kp, vp, tbl, ctx, q.shape[-1] ** -0.5,
                                  *scales)


def _model(q, kp, vp, tbl, ctx, splits, scales=()):
    return tpa.paged_decode_split_model(q, kp, vp, tbl, ctx,
                                        q.shape[-1] ** -0.5, splits, *scales)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", range(1, tpa.MAX_SPLITS + 1))
def test_every_page_dealt_to_exactly_one_split(splits):
    for n_pages in range(0, 45):
        seen = []
        for s in range(splits):
            steps = tpa.split_pages(s, splits, n_pages)
            for pages in steps:
                assert 1 <= len(pages) <= tpa.CHUNK_PAGES
                assert pages == list(range(pages[0], pages[0] + len(pages)))
                # a step is chunk k of the context, dealt to split k mod S
                assert (pages[0] // tpa.CHUNK_PAGES) % splits == s
            flat = [p for pages in steps for p in pages]
            assert flat == sorted(flat)
            seen += flat
        assert sorted(seen) == list(range(n_pages)), (splits, n_pages)


# (batch, kv_heads, pages_per_seq, SMs) -> splits
PLANS = {
    "static_decode": ((8, 8, 33, 132), 5),
    "legacy_decode": ((8, 8, 128, 132), 5),
    "one_sequence_capped": ((1, 8, 128, 132), tpa.MAX_SPLITS),
    "large_batch": ((64, 8, 128, 132), 1),
    "one_page_table": ((8, 8, 1, 132), 1),
    "two_chunk_table": ((2, 8, 3, 132), 2),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_splits_from_shapes_within_the_cluster_cap(name):
    (batch, kvh, pps, n_sm), want = PLANS[name]
    s = tpa.paged_decode_splits(batch, kvh, pps, n_sm)
    assert s == want
    assert 1 <= s <= min(tpa.MAX_SPLITS, -(-pps // tpa.CHUNK_PAGES))
    # enough blocks for the SMs unless the cap or the table stops it
    assert s * batch * kvh >= tpa.SPLIT_BLOCKS_PER_SM * n_sm \
        or s == min(tpa.MAX_SPLITS, -(-pps // tpa.CHUNK_PAGES))


def test_rule_takes_the_main_path_and_names_the_rest():
    """The cluster kernel takes Llama-3-8B's decode (page 16, head_dim
    128, bf16, fp32 or int8 pages) with a 4-stage ring; a page of 8, a
    head_dim that is no multiple of 16 or past 256, and a misaligned pool
    take the block kernel."""
    q = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
    kp = torch.zeros(8, 300, 16, 128, dtype=torch.bfloat16)
    assert tpa.decode_variant(q, kp, kp, 128, 132) == \
        ("cluster", 5, 4)
    assert tpa.decode_variant(q.float(), kp.float(), kp.float(), 33,
                              132)[0] == "cluster"
    codes = torch.zeros(8, 300, 16, 128, dtype=torch.int8)
    scales = torch.zeros(8, 300, 16)
    assert tpa.decode_variant(q, codes, codes, 128, 132, scales, scales) == \
        ("cluster", 5, 4)
    for d, page in ((128, 8), (72, 16), (512, 16)):
        pool = torch.zeros(8, 300, page, d)
        assert tpa.decode_variant(torch.zeros(8, 32, d), pool, pool, 128,
                                  132)[0] == "block", (d, page)
    shape = (8, 300, 16, 128)
    odd = torch.zeros(int(np.prod(shape)) + 1)[1:].view(shape)
    assert odd.data_ptr() % 16
    assert tpa.decode_variant(q.float(), odd, kp.float(), 128,
                              132)[0] == "block"
    assert tpa.decode_variant(q.float(), kp.float(), odd, 128,
                              132)[0] == "block"


def test_shared_memory_of_the_ring():
    """The block's shared memory at Llama-3-8B's decode over the legacy
    cache's 128-page tables (5 splits), and the ring that fits."""
    assert tpa.split_smem_bytes(2, False, 4, 128, 128, 5, 4) == 71864
    assert tpa.split_smem_bytes(1, True, 4, 128, 128, 5, 4) == 40120
    assert tpa.split_stages(4, False, 4, 128, 128, 5) == 4
    # fp32 at head_dim 256: three stages of 64 KB fit beside 8 query
    # heads a kv head, two beside 24, none beside 64
    assert tpa.split_stages(4, False, 8, 256, 128, 5) == 3
    assert tpa.split_stages(4, False, 24, 256, 128, 5) == 2
    assert tpa.split_stages(4, False, 64, 256, 128, 1) == 0


# ---------------------------------------------------------------------------
# the model against the plain version and the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 2, 5, 8])
@pytest.mark.parametrize("name", sorted(ALL))
def test_split_model_matches_plain(name, splits):
    args = _torch(*_case(name))
    want = _plain(*args)
    got = _model(*args, splits)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TIGHT)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_split_model_rounds_match_plain(stages):
    """One online-softmax update per round of ``stages`` resident chunks
    (the kernel's ring depth) moves only the fp32 rounding."""
    q, kp, vp, tbl, ctx = _torch(*_case("wide_table"))
    got = tpa.paged_decode_split_model(q, kp, vp, tbl, ctx,
                                       q.shape[-1] ** -0.5, 3, stages=stages)
    np.testing.assert_allclose(got.numpy(), _plain(q, kp, vp, tbl,
                                                   ctx).numpy(), **TIGHT)


@pytest.mark.parametrize("name", sorted(ALL))
def test_split_model_matches_interpret_kernel(name):
    q, kp, vp, tbl, ctx = _case(name)
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tbl),
                               jnp.asarray(ctx), interpret=True)
    splits = tpa.paged_decode_splits(q.shape[0], kp.shape[0], tbl.shape[1],
                                     132)
    got = _model(*_torch(q, kp, vp, tbl, ctx), splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["ctx_one", "fewer_pages_than_splits",
                                  "group_one", "wide_table"])
def test_int8_split_model_matches_plain_and_interpret_kernel(name):
    """int8 pages quantised by the cache's codec: the model against B5's
    plain version and the reference's ``_decode_kernel_quant``."""
    q, kp, vp, tbl, ctx = _case(name)
    (kq, ks), (vq, vs) = (quantize_kv_rows(torch.from_numpy(x))
                          for x in (kp, vp))
    tq = torch.from_numpy(q)
    want = _plain(tq, kq, vq, tbl, ctx, (ks, vs))
    for splits in (1, 5, 8):
        got = _model(tq, kq, vq, tbl, ctx, splits, (ks, vs))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TIGHT)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kq.numpy()),
                              jnp.asarray(vq.numpy()), jnp.asarray(tbl),
                              jnp.asarray(ctx),
                              k_scales=jnp.asarray(ks.numpy()),
                              v_scales=jnp.asarray(vs.numpy()),
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_model_rounds_once():
    """A bf16 query runs the same fp32 algorithm and rounds once."""
    q, kp, vp, tbl, ctx = _torch(*_case("wide_table"))
    qb, kb, vb = (x.bfloat16() for x in (q, kp, vp))
    got = _model(qb, kb, vb, tbl, ctx, 5)
    ref = _model(qb.float(), kb.float(), vb.float(), tbl, ctx, 5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.bfloat16().float().numpy())


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def _drop_split(orig):
    def split_pages(split, splits, n_pages):
        return [] if split == 1 else orig(split, splits, n_pages)
    return "split_pages", split_pages


def _page_twice(orig):
    def split_pages(split, splits, n_pages):
        steps = orig(split, splits, n_pages)
        return steps + orig(0, splits, n_pages)[:1] if split == 1 else steps
    return "split_pages", split_pages


def _merge_with(rescale_l, rescale_acc, empty_as_zero):
    def merge_partials(parts):
        if empty_as_zero:
            parts = [(torch.where(torch.isneginf(m), 0.0, m), l, acc)
                     for m, l, acc in parts]
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, A = 0.0, 0.0
        for m, l, acc in parts:
            f = torch.where(torch.isneginf(m), 0.0, torch.exp(m - M))
            L = L + l * (f if rescale_l else 1.0)
            A = A + acc * (f if rescale_acc else 1.0)
        return A / L.clamp_min(1e-30)
    return lambda orig: ("merge_partials", merge_partials)


FAULTS = {
    "dropped_split": _drop_split,
    "page_in_two_splits": _page_twice,
    "l_not_rescaled": _merge_with(False, True, False),
    "acc_not_rescaled": _merge_with(True, False, False),
    "empty_split_as_m_zero": _merge_with(True, True, True),
}


def _negative_scores():
    """Every score below -104, where fp32's exp underflows to 0, the dots
    of integers exact in any order; contexts of one to three pages under
    five splits: a merge that takes an empty split's m as 0 loses every
    weight."""
    q, kp, vp, tbl, ctx = _case("fewer_pages_than_splits")
    rng = np.random.RandomState(1)
    q = -rng.randint(4, 7, q.shape).astype(np.float32)
    kp = rng.randint(6, 10, kp.shape).astype(np.float32)
    return q, kp, vp, tbl, ctx


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_breaks_the_model(fault, monkeypatch):
    args = _torch(*(_negative_scores() if fault == "empty_split_as_m_zero"
                    else _case("wide_table")))
    splits = 5
    want = _plain(*args)
    np.testing.assert_allclose(_model(*args, splits).numpy(), want.numpy(),
                               **TIGHT)
    name, faulty = FAULTS[fault](getattr(tpa, "split_pages"))
    monkeypatch.setattr(tpa, name, faulty)
    err = float((_model(*args, splits) - want).abs().max())
    assert err > FAULT, (fault, err)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_cpu_tensor_runs_plain_under_any_variant():
    """A CPU tensor runs the plain version whatever variant is asked, and
    no kernel is counted; an unknown variant raises."""
    args = _torch(*_case("page_edge"))
    before = (tpa.paged_attention.launches,
              tpa.paged_attention.cluster_launches,
              tpa.paged_attention.block_launches)
    want = _plain(*args)
    for variant in (None, *tpa.VARIANTS):
        got = tpa.paged_attention(*args, variant=variant)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.cluster_launches,
            tpa.paged_attention.block_launches) == before
    with pytest.raises(ValueError, match="variant"):
        tpa.paged_attention(*args, variant="tensor_cores")
