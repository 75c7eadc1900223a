"""The q-block kernels' work units (kernel 6 and B7) against the schedule.

``qblock_units`` turns the reference's q-block schedule into one unit per
(q-block, owner slot): the unit's pages are that slot's run of the block's
job list, its rows the block's rows of that slot. The kernel walks each
unit's own pages only, which ROADMAP C21 says gives every row the same
recurrence as the reference's job walk (alien jobs are exact no-ops) and
as the per-token kernel. These tests hold the unit list to the schedule
structurally, show that planted faults in it are caught, and run a PyTorch
walk of the unit list, through the module's own ``_online_step``, against
the plain versions of both grids and the JAX q-block kernel in interpret
mode.
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

jrpa = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")


def _load_layouts():
    """``LAYOUTS`` of tests/test_torch_ragged_attention.py, loaded by path
    (``tests/`` is no package)."""
    path = Path(__file__).with_name("test_torch_ragged_attention.py")
    spec = importlib.util.spec_from_file_location("_ragged_layouts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LAYOUTS


# (spans (slot, q_start, q_len, ctx), tokens, q_block, table edit, seed)
LAYOUTS = dict(_load_layouts())
# bucket padding: tokens 6..11 are outside every span, so they get (slot 0,
# ctx 1); tokens 6 and 7 share block 0 with the real slot-0 span 1..5, and
# block 1 holds padding alone
LAYOUTS["bucket_padded"] = ([(1, 0, 1, 12), (0, 1, 5, 20)], 12, 8, None, 3)

#: as in test_torch_ragged_attention.py: the same fp32 recurrence in the
#: same page order, only the dot's summation order differs
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    plan = trpa.make_plan(T, *desc, tbl, page, impl="qblock",
                          q_block=q_block)
    return dict(q=q, kp=kp, vp=vp, tbl=tbl, desc=desc, q_block=q_block,
                page=page, T=T, plan=plan, spans=spans)


def check_units(units, c, job_page=None):
    """Raise AssertionError unless ``units`` is the schedule's unit list:
    every row t < T (bucket padding included: the kernel writes it) lies
    in exactly one unit; a unit's pages are its slot's whole run of the
    block's job list, pages 0..n-1 of the slot's table row in order; no
    unit holds another slot's job or a padding job."""
    h = c["plan"].host
    jp = h["job_page"] if job_page is None else job_page
    js, jk = h["job_slot"], h["job_kv"]
    rs, rc = h["row_slot"], h["row_ctx"]
    qb, T, P, tbl = c["q_block"], c["T"], c["page"], c["tbl"]
    covered = np.zeros(T, int)
    for b, s, j0, n in np.asarray(units).tolist():
        assert s >= 0, f"unit ({b}, {s}) is a padding slot"
        rows = [t for t in range(b * qb, (b + 1) * qb) if rs[t] == s]
        assert rows, f"unit ({b}, {s}) has no rows"
        for t in rows:
            assert t < T, f"unit ({b}, {s}) holds block padding row {t}"
            covered[t] += 1
        run = np.flatnonzero(js[b] == s)
        assert run.size and run[0] == j0 and run.size == n, \
            f"unit ({b}, {s}) jobs {j0}..{j0 + n} are not its slot's run " \
            f"{run.tolist()}"
        assert (js[b, j0:j0 + n] == s).all(), \
            f"unit ({b}, {s}) holds another slot's job"
        cmax = max(int(rc[t]) for t in rows)
        assert n == min(max(-(-cmax // P), 1), tbl.shape[1]), \
            f"unit ({b}, {s}) has {n} pages for context {cmax}"
        np.testing.assert_array_equal(jp[b, j0:j0 + n], tbl[s, :n],
                                      err_msg=f"unit ({b}, {s}) pages")
        np.testing.assert_array_equal(jk[b, j0:j0 + n],
                                      np.arange(n) * P,
                                      err_msg=f"unit ({b}, {s}) offsets")
    assert (covered == 1).all(), \
        f"rows covered {covered.tolist()} times, not once each"


def unit_walk(c, units=None):
    """The q-block kernel's recurrence in PyTorch, unit by unit: each row
    walks its unit's pages in order through ``_online_step`` and stops at
    its own ceil(ctx / P) pages. Rows of no unit stay zero."""
    h = c["plan"].host
    units = h["units"] if units is None else units
    q = torch.from_numpy(c["q"])
    kp, vp = torch.from_numpy(c["kp"]), torch.from_numpy(c["vp"])
    T, H, D = q.shape
    KVH, _, P, _ = kp.shape
    G = H // KVH
    qb, scale = c["q_block"], 1.0 / math.sqrt(D)
    out = torch.zeros(T, H, D)
    for b, s, j0, n in np.asarray(units).tolist():
        toks = [t for t in range(b * qb, (b + 1) * qb) if h["row_slot"][t] == s]
        ctx = torch.as_tensor([int(h["row_ctx"][t]) for t in toks])
        own = torch.clamp(-(-ctx // P), max=n)            # pages a row reads
        qg = q[toks].view(len(toks), KVH, G, D)            # [tok, KVH, G, D]
        m = torch.full((len(toks), KVH, G, 1), float("-inf"))
        l = torch.zeros((len(toks), KVH, G, 1))
        acc = torch.zeros((len(toks), KVH, G, D))
        for p in range(n):
            page = int(h["job_page"][b, j0 + p])
            k, v = kp[:, page], vp[:, page]                # [KVH, P, D]
            sc = torch.einsum("tkgd,kpd->tkgp", qg, k) * scale
            pos = p * P + torch.arange(P)
            sc = torch.where(pos < ctx[:, None, None, None], sc,
                             float("-inf"))
            m2, l2, acc2 = trpa._online_step(sc, v[None], m, l, acc)
            live = (p < own)[:, None, None, None]
            m, l = torch.where(live, m2, m), torch.where(live, l2, l)
            acc = torch.where(live, acc2, acc)
        out[toks] = (acc / l.clamp_min(1e-30)).reshape(len(toks), H, D)
    return out


def _span_rows(c):
    return np.concatenate([np.arange(qs, qs + ql)
                           for _, qs, ql, _ in c["spans"]])


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_units_match_schedule(name):
    c = _case(name)
    units = c["plan"].host["units"]
    assert units.dtype == np.int32 and units.shape[1] == 4
    np.testing.assert_array_equal(
        units, trpa.qblock_units(c["plan"].host["job_slot"]))
    check_units(units, c)
    # one unit per distinct slot of each block, and the plan ships it
    rs, qb = c["plan"].host["row_slot"], c["q_block"]
    want = sum(len({s for s in rs[b * qb:(b + 1) * qb] if s >= 0})
               for b in range(len(rs) // qb))
    assert len(units) == want
    assert c["plan"].dev["units"].dtype == torch.int32


def test_bucket_padding_shares_slot_zero_units():
    """Padding rows carry slot 0: in block 0 they join the real slot-0
    span's unit (not a range of rows), and block 1's padding rows get a
    unit of their own."""
    c = _case("bucket_padded")
    units = c["plan"].host["units"].tolist()
    assert [u[:2] for u in units] == [[0, 1], [0, 0], [1, 0]]
    rs = c["plan"].host["row_slot"]
    assert rs[:12].tolist() == [1] + [0] * 11 and (rs[12:] == -1).all()


def test_units_of_padding_job_blocks_are_none():
    js = np.array([[3, 3, 5, -2], [-2, -2, -2, -2], [4, -2, -2, -2]],
                  np.int32)
    np.testing.assert_array_equal(
        trpa.qblock_units(js), [[0, 3, 0, 2], [0, 5, 2, 1], [2, 4, 0, 1]])


def _plant(c, fault):
    units = c["plan"].host["units"].copy()
    job_page = c["plan"].host["job_page"].copy()
    js = c["plan"].host["job_slot"]
    if fault == "dropped_last_page":
        k = int(np.flatnonzero(units[:, 3] >= 2)[0])
        units[k, 3] -= 1
    elif fault == "alien_page":
        # extend a unit over the next job, which belongs to another slot
        for k, (b, s, j0, n) in enumerate(units.tolist()):
            if j0 + n < js.shape[1] and js[b, j0 + n] >= 0:
                units[k, 3] += 1
                break
        else:
            raise AssertionError("no unit is followed by another slot")
    elif fault == "swapped_pages":
        b, s, j0, n = units[int(np.flatnonzero(units[:, 3] >= 2)[0])]
        job_page[b, [j0, j0 + 1]] = job_page[b, [j0 + 1, j0]]
    elif fault == "padding_row_unassigned":
        # block 1 of the bucket-padded layout holds padding rows alone
        units = units[units[:, 0] != 1]
    return units, job_page


@pytest.mark.parametrize("fault", ["dropped_last_page", "alien_page",
                                   "swapped_pages",
                                   "padding_row_unassigned"])
def test_planted_faults_fail_the_structure_check(fault):
    c = _case("bucket_padded" if fault == "padding_row_unassigned"
              else "straddling")
    check_units(c["plan"].host["units"], c, c["plan"].host["job_page"])
    units, job_page = _plant(c, fault)
    with pytest.raises(AssertionError):
        check_units(units, c, job_page)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_unit_walk_matches_both_plain_versions(name):
    c = _case(name)
    walk = unit_walk(c)
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    scale = 1.0 / math.sqrt(q.shape[-1])
    qblock = trpa.qblock_attention_plain(q, kp, vp, c["plan"], scale)
    tplan = trpa.make_plan(c["T"], *c["desc"], c["tbl"], c["page"],
                           impl="token")
    token = trpa.token_attention_plain(q, kp, vp, tplan, scale)
    # every row t < T is written, padding included: the per-token grid
    # computes the same (slot 0, ctx 1) garbage for it
    rows = np.arange(c["T"])
    np.testing.assert_allclose(walk.numpy()[rows], token.numpy()[rows],
                               **KERNEL_TOL)
    rows = _span_rows(c)
    np.testing.assert_allclose(walk.numpy()[rows], qblock.numpy()[rows],
                               **KERNEL_TOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_unit_walk_matches_jax_qblock_kernel(name, monkeypatch):
    c = _case(name)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    monkeypatch.setenv("PADDLE_TPU_RAGGED_QBLOCK", str(c["q_block"]))
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tbl"]), *c["desc"], interpret=True))
    rows = _span_rows(c)
    np.testing.assert_allclose(unit_walk(c).numpy()[rows], want[rows],
                               **KERNEL_TOL)


def test_planted_walk_faults_change_the_output():
    """The walk is no tautology: a unit with its last page dropped gives
    another output on the rows that needed that page."""
    c = _case("straddling")
    units, _ = _plant(c, "dropped_last_page")
    good, bad = unit_walk(c), unit_walk(c, units)
    assert not torch.allclose(good, bad, **KERNEL_TOL)
