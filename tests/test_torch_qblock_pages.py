"""Kernel 6 / B7 at every page size and head dim: what the CPU can hold.

The q-block kernels run in two variants on the same units and grid:
``"unit"`` (pages of 4, 8, 16 or 32 keys, head_dim % 16 == 0, 16-byte
aligned pools, a block that fits shared memory) and ``"runtime"`` (every other
shape). These tests hold ``qblock_variant``'s rule, the unit list and the
fixed grid (``qblock_caps``) at pages of 4, 8, 12, 32 and 64, including
the worst case of speculative decoding's packing (every slot a verify
span of ``spec_k + 1`` tokens, prefill spans behind them) at every token
bucket, and the unit walk against the reference's ``_qblock_kernel`` in
interpret mode at pages of 8 and 12 and head_dim 72 (ROADMAP C1). The
kernels themselves run on the card (``chip_smoke.py`` phase 2(a), C21).
"""
import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.ops import ragged_paged_attention as trpa


def _load(name):
    """A sibling test module, loaded by path (``tests/`` is no package)."""
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


UNITS = _load("test_torch_ragged_qblock_units.py")
jrpa = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")

PAGES = (4, 8, 12, 32, 64)
#: C1: the reference's own kernel parity (tests/test_qblock_attention.py)
C1_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, page, d=32, heads=4, kv_heads=2):
    """``test_torch_ragged_qblock_units``'s layout ``name`` at pages of
    ``page`` keys and head_dim ``d``, tables wide enough for its 32-token
    contexts."""
    return UNITS._case(name, heads=heads, kv_heads=kv_heads, d=d, page=page,
                       pages_per_seq=max(2, -(-40 // page)))


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def _operands(page, d, heads=32, kv_heads=8, dtype=torch.bfloat16,
              quant=False, misaligned=False):
    pdt = torch.int8 if quant else dtype
    shape = (kv_heads, 9, page, d)

    def pool(shape, dt):
        t = torch.zeros(int(np.prod(shape)) + 1, dtype=dt)
        return (t[1:] if misaligned else t[:-1]).view(shape)
    q = torch.zeros(8, heads, d, dtype=dtype)
    k, v = pool(shape, pdt), pool(shape, pdt)
    scales = ((pool(shape[:3], torch.float32), pool(shape[:3], torch.float32))
              if quant else ())
    plan = trpa.make_plan(8, [0], [0], [8], [8], np.arange(1, 9)[None]
                          .astype(np.int32), page, impl="qblock",
                          max_slots=8)
    return q, k, v, plan, scales


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_variant_rule(quant):
    for page in (1, 2, 4, 8, 12, 16, 32, 64, 128):
        q, k, v, plan, sc = _operands(page, 128, quant=quant)
        want = "unit" if page in (4, 8, 16, 32) else "runtime"
        assert trpa.qblock_variant(q, k, v, plan, *sc) == want, page
    for d in (64, 72, 80, 96, 100, 128):
        q, k, v, plan, sc = _operands(16, d, quant=quant)
        want = "unit" if d % 16 == 0 else "runtime"
        assert trpa.qblock_variant(q, k, v, plan, *sc) == want, d
    q, k, v, plan, sc = _operands(16, 128, quant=quant, misaligned=True)
    assert any(t.data_ptr() % 16 for t in (k, v, *sc))
    assert trpa.qblock_variant(q, k, v, plan, *sc) == "runtime"


def test_variant_rule_takes_the_runtime_kernel_past_shared_memory():
    """A unit block holds q-block x G query rows of head_dim D: 8 x 8
    rows of 256 in fp32 do not fit, and the rule sends them on."""
    q, k, v, plan, _ = _operands(16, 256, heads=64, kv_heads=8,
                                 dtype=torch.float32)
    assert trpa.unit_smem_bytes(4, False, 64, 16, 256, 8, 8) \
        > trpa.SMEM_LIMIT
    assert trpa.qblock_variant(q, k, v, plan) == "runtime"
    q, k, v, plan, _ = _operands(16, 128)
    assert trpa.unit_smem_bytes(2, False, 32, 16, 128, 8, 8) \
        <= trpa.SMEM_LIMIT
    assert trpa.qblock_variant(q, k, v, plan) == "unit"
    # fp32 pages of 32 at Llama-3-8B's widths: the double buffer of four
    # staged pages alone is 266,240 bytes
    q, k, v, plan, _ = _operands(32, 128, dtype=torch.float32)
    assert trpa.qblock_variant(q, k, v, plan) == "runtime"
    q, k, v, plan, _ = _operands(32, 128, dtype=torch.bfloat16)
    assert trpa.qblock_variant(q, k, v, plan) == "unit"


def test_forced_variant_names_are_checked():
    q, k, v, plan, _ = _operands(16, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        trpa.qblock_attention(q, k, v, plan, 0.1, variant="warp")
    with pytest.raises(ValueError):
        trpa.qblock_attention_q8(q, k.to(torch.int8), v.to(torch.int8),
                                 torch.ones(k.shape[:3]),
                                 torch.ones(k.shape[:3]), plan, 0.1,
                                 variant="block")
    # on the CPU every variant is the plain version
    want = trpa.qblock_attention_plain(q, k, v, plan, 0.1)
    for variant in (None, *trpa.QBLOCK_VARIANTS):
        got = trpa.qblock_attention(q, k, v, plan, 0.1, variant=variant)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# units and the fixed grid at every page size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("name", sorted(UNITS.LAYOUTS))
def test_units_match_schedule_at_every_page(name, page):
    c = _case(name, page)
    units = c["plan"].host["units"]
    np.testing.assert_array_equal(
        units, trpa.qblock_units(c["plan"].host["job_slot"]))
    UNITS.check_units(units, c)
    # the same units on the engines' fixed grid, padded past the live ones
    fixed = trpa.plan_arrays(c["T"], *c["desc"], c["tbl"], page,
                             q_block=c["q_block"], max_slots=8)
    caps = trpa.qblock_caps(c["T"], c["q_block"], 8, c["tbl"].shape[1])
    live = int(fixed["n_units"][0])
    assert fixed["units"].shape == (caps[0], 4)
    assert fixed["job_page"].shape[1] == caps[1]
    np.testing.assert_array_equal(fixed["units"][:live], units)
    assert not fixed["units"][live:].any()


def _spec_worst_case(bucket, page, slots=8, spec_k=4, max_len=2048,
                     seed=0):
    """The most a speculating tick packs into ``bucket`` tokens: every slot
    a decode span of 1 + spec_k tokens as far as the bucket holds them
    (each at least its one token), then prefill spans of the slots left
    over, back to back from row 0 (as the engine packs), contexts drawn at
    random up to ``max_len``. Returns the descriptors and the tables."""
    rng = np.random.RandomState(seed + bucket + page)
    pps = -(-max_len // page)
    tbl = np.arange(1, 1 + slots * pps, dtype=np.int32).reshape(slots, pps)
    decode = min(slots, bucket)
    spans, off = [], 0
    for i in range(decode):
        room = bucket - off - (decode - i - 1)
        n = max(1, min(1 + spec_k, room))
        spans.append((i, off, n))
        off += n
    for i in range(decode, slots):
        if off >= bucket:
            break
        n = int(rng.randint(1, bucket - off + 1))
        spans.append((i, off, n))
        off += n
    ctx = [int(rng.randint(n, max_len + 1)) for _, _, n in spans]
    desc = tuple(np.asarray(a, np.int32) for a in
                 ([s for s, _, _ in spans], [o for _, o, _ in spans],
                  [n for _, _, n in spans], ctx))
    return desc, tbl


@pytest.mark.parametrize("page", PAGES)
def test_spec_worst_case_fits_the_fixed_grid_at_every_bucket(page):
    for bucket in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        for seed in range(3):
            desc, tbl = _spec_worst_case(bucket, page, seed=seed)
            arrays = trpa.plan_arrays(bucket, *desc, tbl, page,
                                      q_block=trpa.DEFAULT_QBLOCK,
                                      max_slots=8)
            u_max, j_max = trpa.qblock_caps(bucket, trpa.DEFAULT_QBLOCK, 8,
                                            tbl.shape[1])
            live = int(arrays["n_units"][0])
            assert 0 < live <= u_max == arrays["units"].shape[0]
            assert arrays["job_page"].shape[1] == j_max
            # every real row lies in one unit whose pages are its own
            units = trpa.qblock_units(arrays["job_slot"])
            np.testing.assert_array_equal(arrays["units"][:live], units)
            for b, s, j0, n in units.tolist():
                rows = np.flatnonzero(arrays["row_slot"][b * 8:(b + 1) * 8]
                                      == s)
                need = -(-int(arrays["row_ctx"][b * 8 + rows].max()) // page)
                assert n == min(need, tbl.shape[1])
                np.testing.assert_array_equal(
                    arrays["job_page"][b, j0:j0 + n], tbl[s, :n])


def test_spec_worst_case_reaches_the_unit_cap():
    """The bound is tight: 8 verify spans of 5 tokens over a 64-token
    bucket change slot inside most q-blocks."""
    desc, tbl = _spec_worst_case(64, 16)
    arrays = trpa.plan_arrays(64, *desc, tbl, 16, max_slots=8)
    u_max, _ = trpa.qblock_caps(64, 8, 8, tbl.shape[1])
    assert int(arrays["n_units"][0]) >= u_max - 2


# ---------------------------------------------------------------------------
# the unit walk against the reference's kernel, and planted faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page,d", [(8, 32), (12, 32), (8, 72), (12, 72),
                                    (16, 72)])
@pytest.mark.parametrize("name", sorted(UNITS.LAYOUTS))
def test_unit_walk_matches_jax_qblock_kernel(name, page, d, monkeypatch):
    c = _case(name, page, d=d)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    monkeypatch.setenv("PADDLE_TPU_RAGGED_QBLOCK", str(c["q_block"]))
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tbl"]), *c["desc"], interpret=True))
    rows = UNITS._span_rows(c)
    walk = UNITS.unit_walk(c).numpy()
    np.testing.assert_allclose(walk[rows], want[rows], **C1_TOL)
    # and the plain version the CPU runs for both variants
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    plain = trpa.qblock_attention_plain(q, kp, vp, c["plan"],
                                        1.0 / math.sqrt(d)).numpy()
    np.testing.assert_allclose(plain[rows], want[rows], **C1_TOL)


@pytest.mark.parametrize("page", [4, 12])
@pytest.mark.parametrize("fault", ["dropped_last_page", "alien_page",
                                   "swapped_pages"])
def test_planted_faults_fail_the_structure_check(fault, page):
    c = _case("straddling", page)
    UNITS.check_units(c["plan"].host["units"], c, c["plan"].host["job_page"])
    units, job_page = UNITS._plant(c, fault)
    with pytest.raises(AssertionError):
        UNITS.check_units(units, c, job_page)


def test_planted_walk_fault_changes_the_output_at_page_12():
    c = _case("straddling", 12)
    units, _ = UNITS._plant(c, "dropped_last_page")
    good, bad = UNITS.unit_walk(c), UNITS.unit_walk(c, units)
    assert not torch.allclose(good, bad, **C1_TOL)
