"""Kernels 4, 6 and 8 with a 16-bit query over fp32 pages (ROADMAP C29).

Under AMP's O2 a 16-bit model's pools stay fp32 (the rope's fp32 tables
make k fp32, C25), and the reference casts the cached attention op's one
tensor argument, q, to the AMP dtype. Its kernels read q exactly into
fp32, run their fp32 arithmetic and store the output in q's dtype
(``paged_attention.py:68``, ``ragged_paged_attention.py:231``, ``:402``).
The port's CUDA kernels do the same as new instantiations
(``<bf16, float>``, ``<fp16, float>``), reached through the dtype codes 3
and 4 of every native-page C entry point.

Here, on the CPU: the plain versions (what a CPU tensor runs) and the
cluster kernels' PyTorch models give on mixed inputs exactly the fp32
query's result rounded once to q's dtype (the rule the card holds the
new kernels to, bit for bit); they agree with the reference's
interpret-mode Pallas kernels on the same mixed inputs within one unit
in the last place of q's dtype; the CUDA wrappers' checks take a 16-bit
q over fp32 pages and refuse other mixes; every native entry point of
the sources dispatches codes 3 and 4 to ``<16-bit, float>``. Planted
faults (a kernel that rounds the pages to q's dtype, or one that
truncates its output) fail the exact rule.
"""
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

# the package re-exports a function of the module's name
jrpa = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
#: significand bits after the point: one ulp of x is 2^(floor(log2|x|) - b)
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _ulp(x, dtype):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - MANTISSA[dtype])


def _rng_array(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _paged_case(seed=0, batch=3, heads=8, kvh=2, d=32, page=16, pps=4):
    n_pages = batch * pps + 1
    tables = (1 + np.arange(batch)[:, None] * pps
              + np.arange(pps)[None, :]).astype(np.int32)
    ctx = np.asarray([1, 23, 64], np.int32)[:batch]
    return dict(q=_rng_array(seed, batch, heads, d),
                kp=_rng_array(seed + 1, kvh, n_pages, page, d),
                vp=_rng_array(seed + 2, kvh, n_pages, page, d),
                tables=tables, ctx=ctx)


#: (slot, q_start, q_len, ctx): a 9-token chunk straddling q-blocks, a
#: decode token, a 6-token prefill and a decode at a long context
SPANS = [(0, 0, 1, 31), (1, 1, 9, 25), (2, 10, 6, 6), (3, 16, 1, 60)]


def _ragged_case(seed=0, heads=8, kvh=2, d=32, page=16, pps=4):
    nslots = len(SPANS)
    npages = nslots * pps + 1
    tbl = (1 + np.arange(nslots)[:, None] * pps
           + np.arange(pps)[None, :]).astype(np.int32)
    desc = tuple(np.asarray([s[i] for s in SPANS], np.int32)
                 for i in range(4))
    T = int((desc[1] + desc[2]).max())
    return dict(q=_rng_array(seed, T, heads, d),
                kp=_rng_array(seed + 1, kvh, npages, page, d),
                vp=_rng_array(seed + 2, kvh, npages, page, d),
                tbl=tbl, desc=desc, page=page,
                rows=np.concatenate([np.arange(qs, qs + ql)
                                     for _, qs, ql, _ in SPANS]))


def _plan(c, impl):
    return trpa.make_plan(c["q"].shape[0], *c["desc"], c["tbl"], c["page"],
                          impl=impl, q_block=8)


def _mixed(c, dtype):
    """q rounded to ``dtype``; fp32 pages."""
    return (torch.from_numpy(c["q"]).to(dtype), torch.from_numpy(c["kp"]),
            torch.from_numpy(c["vp"]))


SCALE = 1.0 / np.sqrt(32)


def _paged(q, kp, vp, c):
    return tpa.paged_attention(q, kp, vp, c["tables"], c["ctx"])


def _paged_split(q, kp, vp, c):
    return tpa.paged_decode_split_model(q, kp, vp, c["tables"], c["ctx"],
                                        SCALE, splits=3, stages=2)


def _qblock(q, kp, vp, c):
    return trpa.qblock_attention(q, kp, vp, _plan(c, "qblock"), SCALE)


def _token(q, kp, vp, c):
    return trpa.token_attention(q, kp, vp, _plan(c, "token"), SCALE)


def _token_split(q, kp, vp, c):
    return trpa.token_split_model(q, kp, vp, _plan(c, "token"), SCALE,
                                  splits=2, round_pages=1)


#: kernel -> (its plain version or PyTorch model, case builder)
KERNELS = {
    "4 paged (block, plain)": (_paged, _paged_case),
    "4 paged (cluster model)": (_paged_split, _paged_case),
    "6 q-block (plain)": (_qblock, _ragged_case),
    "8 per-token (plain)": (_token, _ragged_case),
    "8 per-token (cluster model)": (_token_split, _ragged_case),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_mixed_inputs_give_the_upcast_query_rounded_once(kernel, dtype):
    """The bit-equality rule of the new variants: ``f(q16, pages32) ==
    f(q16.float(), pages32).to(q16.dtype)``, exactly. The upcast of q is
    exact and the arithmetic after it the fp32 variant's."""
    fn, case = KERNELS[kernel]
    c = case()
    dt = DTYPES[dtype]
    q, kp, vp = _mixed(c, dt)
    got = fn(q, kp, vp, c)
    want = fn(q.float(), kp, vp, c).to(dt)
    assert got.dtype == dt and got.shape == q.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _pages_rounded(q, kp, vp, c, fn):
    """Planted fault: pages read in q's dtype (the 16-bit variant's
    arithmetic on a copy of the pool)."""
    return fn(q, kp.to(q.dtype), vp.to(q.dtype), c)


def _output_truncated(q, kp, vp, c):
    """Planted fault: the fp32 result stored to bf16 by truncation (a
    round-toward-zero conversion) instead of rounding to nearest."""
    out = _paged(q.float(), kp, vp, c)
    bits = out.view(torch.int32) & -65536          # keep the top 16 bits
    return bits.view(torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["pages in q's dtype",
                                   "output truncated"])
def test_planted_faults_fail_the_exact_rule(fault):
    c = _paged_case()
    q, kp, vp = _mixed(c, torch.bfloat16)
    want = _paged(q.float(), kp, vp, c).to(torch.bfloat16)
    if fault == "pages in q's dtype":
        got = _pages_rounded(q, kp, vp, c, _paged)
    else:
        got = _output_truncated(q, kp, vp, c)
    assert got.dtype == torch.bfloat16
    assert not torch.equal(got.view(torch.int16), want.view(torch.int16))


def _assert_within_one_ulp(got, want, dtype):
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    bound = _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    assert (np.abs(g - w) <= bound).all(), float(
        (np.abs(g - w) / bound).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_plain_matches_the_interpret_kernel_on_mixed_inputs(dtype):
    """The reference's decode kernel upcasts q (``:68``) and stores q's
    dtype (``:178``): on the same 16-bit q over fp32 pages the port's
    plain version is within one ulp of q's dtype (two fp32 sums of
    different order, then one rounding each)."""
    c = _paged_case(seed=4)
    dt = DTYPES[dtype]
    q, kp, vp = _mixed(c, dt)
    want = jpa.paged_attention(jnp.asarray(q.float().numpy()).astype(dtype),
                               jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
                               jnp.asarray(c["tables"]),
                               jnp.asarray(c["ctx"]), interpret=True)
    assert str(want.dtype) == dtype
    got = _paged(q, kp, vp, c)
    _assert_within_one_ulp(got, want, dt)


@pytest.mark.parametrize("impl", trpa.IMPLS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_plain_matches_the_interpret_kernels_on_mixed_inputs(
        dtype, impl, monkeypatch):
    """The reference's q-block and per-token kernels upcast q (``:231``,
    ``:402``) and store q's dtype (``:377-378``, ``:513``): the port's
    plain versions on the same mixed inputs, within one ulp of q's dtype
    on every real row."""
    c = _ragged_case(seed=6)
    dt = DTYPES[dtype]
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", impl)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_QBLOCK", "8")
    q, kp, vp = _mixed(c, dt)
    want = jrpa.ragged_paged_attention(
        jnp.asarray(q.float().numpy()).astype(dtype), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["tbl"]), *c["desc"],
        interpret=True)
    assert str(want.dtype) == dtype
    got = trpa.ragged_paged_attention(q, kp, vp, c["tbl"], *c["desc"],
                                      impl=impl, q_block=8)
    rows = c["rows"]
    _assert_within_one_ulp(got[rows], want[rows], dt)


# -- the CUDA wrappers' checks and the C entry points -------------------------

def test_attention_dtype_codes():
    code = _build.attention_dtype_code
    f32, bf16, f16, i8 = (torch.float32, torch.bfloat16, torch.float16,
                          torch.int8)
    assert [code(d, d) for d in (f32, bf16, f16)] == [0, 1, 2]
    assert [code(d, i8) for d in (f32, bf16, f16)] == [0, 1, 2]
    assert (code(bf16, f32), code(f16, f32)) == (3, 4)
    for q, pages in ((f32, bf16), (f32, f16), (bf16, f16), (f16, bf16)):
        with pytest.raises(TypeError):
            code(q, pages)


def _paged_operands(dtype, page_dtype, quant=False):
    c = _paged_case()
    q = torch.from_numpy(c["q"]).to(dtype)
    kp, vp = (torch.from_numpy(c[n]).to(page_dtype) for n in ("kp", "vp"))
    scales = (torch.ones(kp.shape[:3]),) * 2 if quant else (None, None)
    return (q, kp, vp, torch.from_numpy(c["tables"]),
            torch.from_numpy(c["ctx"]), *scales)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_checks_take_a_16_bit_query_over_fp32_pages(dtype):
    """The checks the CUDA wrappers run before a launch (shapes, types and
    devices only, so they run on CPU tensors here): a bf16 or fp16 q over
    fp32 native pages passes for the paged and both ragged kernels; an
    fp32 q over 16-bit pages, or two different 16-bit types, raises."""
    dt = DTYPES[dtype]
    tpa._check_cuda_inputs(*_paged_operands(dt, torch.float32))
    tpa._check_cuda_inputs(*_paged_operands(dt, torch.int8, quant=True))
    c = _ragged_case()
    for impl in trpa.IMPLS:
        q, kp, vp = _mixed(c, dt)
        trpa._check_cuda_inputs(q, kp, vp, _plan(c, impl), impl)
    other = torch.float16 if dt == torch.bfloat16 else torch.bfloat16
    for qd, pd in ((torch.float32, dt), (dt, other)):
        with pytest.raises(TypeError):
            tpa._check_cuda_inputs(*_paged_operands(qd, pd))
        q, kp, vp = _mixed(c, qd)
        with pytest.raises(TypeError):
            trpa._check_cuda_inputs(q, kp.to(pd), vp.to(pd),
                                    _plan(c, "qblock"), "qblock")


#: every C entry point over native pages, by source
NATIVE_ENTRIES = {
    "paged_attention.cu": ("ptt_paged_decode", "ptt_paged_decode_split"),
    "ragged_paged_attention.cu": ("ptt_ragged_token",
                                  "ptt_ragged_token_split"),
    "qblock_runtime.cu": ("ptt_ragged_qblock_rt",),
    "qblock.cuh": ("ptt_ragged_qblock_p##P",),
}


def _body(text, name):
    start = text.index(f"int {name}(")
    return text[start:text.index("default:", start)]


@pytest.mark.parametrize("source", sorted(NATIVE_ENTRIES))
def test_native_entry_points_dispatch_the_mixed_codes(source):
    """Codes 3 and 4 reach ``<__nv_bfloat16, float>`` and ``<__half,
    float>`` (q's type, then fp32 pages) in every native-page entry
    point; the int8 entry points take no such code."""
    text = (_build.CSRC / source).read_text()
    for name in NATIVE_ENTRIES[source]:
        body = re.sub(r"\s+", " ", _body(text, name).replace("\\", " "))
        for code, t in ((3, "__nv_bfloat16"), (4, "__half")):
            case = re.search(rf"case {code}: return \(int\)(\w+)<{t}"
                             rf"(?:, float, P)?> ?\( ?q, "
                             rf"native_pages<float>\(kp, vp\)", body)
            assert case, (source, name, code)
        q8 = _body(text, name + ("##" if name.endswith("##P") else "")
                   + "_q8")
        assert "case 3:" not in q8 and "case 4:" not in q8


def test_every_native_entry_point_is_listed():
    """Every exported function over native pages appears in
    NATIVE_ENTRIES, so the test above sees any new one."""
    names = set()
    for sig in _build.SIGNATURES.values():
        for fn in sig:
            if re.fullmatch(r"ptt_(paged_decode|ragged_(token|qblock))"
                            r"(_split|_rt|_p\d+)?", fn):
                names.add(re.sub(r"_p\d+$", "_p##P", fn))
    listed = {n for ns in NATIVE_ENTRIES.values() for n in ns}
    assert names == listed


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wrappers_pass_the_mixed_code_and_count_the_launch(dtype,
                                                           monkeypatch):
    """Each CUDA wrapper, its launch intercepted (no card here): a 16-bit
    q over fp32 pages goes out with code 3 (bf16) or 4 (fp16) and adds
    one to ``mixed_launches`` beside ``launches`` and its variant's
    count; q and pages of one dtype, or int8 pages, do not count as
    mixed."""
    dt = DTYPES[dtype]
    launched = []
    monkeypatch.setattr(tpa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(trpa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, device, args,
                        counters=(): launched.append(
                            (name, args[0].value,
                             [key for _, key in counters])))
    want_code = _build.attention_dtype_code(dt, torch.float32)
    q, kp, vp, tables, ctx, _, _ = _paged_operands(dt, torch.float32)
    tpa._paged_cuda(tpa.paged_attention, q, kp, vp, tables, ctx, SCALE,
                    None, None, None)
    c = _ragged_case()
    q, kp, vp = _mixed(c, dt)
    trpa._qblock_cuda(trpa.qblock_attention, q, kp, vp, _plan(c, "qblock"),
                      SCALE, None, None, None)
    trpa._token_cuda(trpa.token_attention, q, kp, vp, _plan(c, "token"),
                     SCALE, None, None, None)
    assert [code for _, code, _ in launched] == [want_code] * 3
    # each launch also counts under its dtypes in ``launches_by_dtype``
    mixed = f"{dtype}/float32"
    assert [keys for *_, keys in launched] == [
        ["launches", "cluster_launches", mixed, "mixed_launches"],
        ["launches", "unit_launches", mixed, "mixed_launches"],
        ["launches", "cluster_launches", mixed, "mixed_launches"]]
    launched.clear()
    same = _paged_operands(dt, dt)[:5]
    tpa._paged_cuda(tpa.paged_attention, *same, SCALE, None, None, None)
    q8 = _paged_operands(dt, torch.int8, quant=True)
    tpa._paged_cuda(tpa.paged_attention_q8, *q8[:5], SCALE, *q8[5:],
                    None)
    assert [(code, keys) for _, code, keys in launched] == [
        (_build.dtype_code(dt), ["launches", "cluster_launches",
                                 f"{dtype}/{pages}"])
        for pages in (dtype, "int8")]
