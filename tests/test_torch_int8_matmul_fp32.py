"""The fp32 variants of the port's weight-only int8 matmul (B10).

What the CUDA kernels cannot show on a CPU, tested here: which variant an
fp32 call takes (``matmul_variant``, ``FP32_STREAM_MAX_M`` and its
override in ``chip_smoke.forced_variant``), the fp32 split-K plans
(``split_plan``, ``split_parts``: K covered once, a function of the shape
alone, a stream part's x slice within shared memory), the exact int8 ->
fp32 conversion the kernels do in registers (emulated with numpy bit
operations for all 256 codes), and a CPU imitation of each kernel's
arithmetic: the stream's k-lanes (a warp's 16-code chunks of every box,
k ascending, the lanes' chains added in order), the GEMM's one chain per
output, the parts' partials added in order, the scale once, one cast. It
must pass ``FP32_TOL`` against the plain version at the chip's weight
shapes and match the JAX package's interpret-mode Pallas ``int8_matmul``
at scaled-down shapes; the same imitation with a fault planted (a dropped
last part, a stale ring stage, the neighbouring channel's scale, a row
written past M) must fail it.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu_torch.ops import quant_matmul as tqm
from test_torch_int8_matmul_wgmma import byte_perm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FP32 = ("fp32_stream", "fp32_gemm")
#: kFStages of csrc/quant_matmul.cu: the stream's ring a stale stage comes
#: from (the GEMM's ring is shallower; a box a ring's depth back is stale
#: to either)
STAGES = 4
#: the opt-in shared memory of an H100 block
SMEM_LIMIT = 232448
#: kFWarps of csrc/quant_matmul.cu: the stream's consumer warps, whose
#: k-lanes split each box's chunks
WARPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- variants

@pytest.mark.parametrize("m,k,forced,want", [
    (0, 4096, None, "fp32_stream"),
    (1, 4096, None, "fp32_stream"),
    (8, 14336, None, "fp32_stream"),
    (33, 4096, None, "fp32_stream"),
    (64, 4096, None, "fp32_stream"),
    (65, 4096, None, "fp32_gemm"),
    (256, 14336, None, "fp32_gemm"),
    (8, 4104, None, "simt"),
    (256, 4100, None, "simt"),
    (8, 4096, "fp32_gemm", "fp32_gemm"),
    (256, 4096, "fp32_stream", "fp32_stream"),
    (8, 4104, "fp32_gemm", "simt"),
    (256, 4100, "fp32_stream", "simt"),
    (8, 4096, "wgmma_gemm", "fp32_stream"),
    (256, 4096, "wgmma_stream", "fp32_gemm")])
def test_fp32_variant(m, k, forced, want):
    """fp32 with K % 16 == 0 takes the stream up to FP32_STREAM_MAX_M and
    the GEMM above; an fp32 override forces either at the other's M and
    leaves bf16 on its tensor-core rule; a tensor-core override leaves
    fp32 alone; K % 16 != 0 stays on the scalar kernel."""
    rules = (tqm.STREAM_MAX_M, tqm.FP32_STREAM_MAX_M)
    with smoke.forced_variant(tqm, forced):
        assert tqm.matmul_variant(torch.float32, m, 1024, k) == want
        if forced in FP32:
            assert tqm.matmul_variant(torch.bfloat16, m, 1024, k) == (
                "simt" if k % 16 else "wgmma_stream"
                if m <= tqm.STREAM_MAX_M else "wgmma_gemm")
    assert (tqm.STREAM_MAX_M, tqm.FP32_STREAM_MAX_M) == rules


# ----------------------------------------------------------- split plan

SHAPES = smoke.MATMUL_SHAPES + [(4096 + 48, 1000)]


@pytest.mark.parametrize("k,n", SHAPES, ids=str)
def test_fp32_plans_cover_k_once(k, n):
    """At every M of the chip's list, in both fp32 variants: the parts
    run in order over K without gap or overlap, each a nonempty run of
    whole k16 steps; the plan is what the C entry point accepts ((S - 1)
    tpp < k_tiles <= S tpp); 128 channels a block; a stream block (its
    weight ring, x slice, barriers and alignment slack) fits the H100's
    shared memory."""
    k_tiles = -(-k // tqm.K_TILE)
    for m in smoke.MATMUL_MS:
        for variant in FP32:
            mt, nwg, splits, tpp = tqm.split_plan(variant, m, n, k)
            parts = tqm.split_parts(variant, m, n, k)
            assert len(parts) == splits >= 1
            assert (splits - 1) * tpp < k_tiles <= splits * tpp
            assert parts[0][0] == 0 and parts[-1][1] == k
            for (_, a1), (b0, _) in zip(parts, parts[1:]):
                assert a1 == b0
            for a0, a1 in parts:
                assert a0 < a1 and a0 % 16 == 0 and a1 % 16 == 0
            assert 64 * nwg == tqm.FP32_CHANNELS
            if variant == "fp32_stream":
                assert mt in tqm.FP32_STREAM_TILES
                assert mt >= m or mt == tqm.FP32_STREAM_TILES[-1]
                assert mt * tpp * tqm.K_TILE * 4 <= tqm.FP32_X_SLICE_BYTES
                ring = 4 * tqm.FP32_CHANNELS * tqm.K_TILE
                assert ring + tqm.FP32_X_SLICE_BYTES + 64 + 1024 \
                    <= SMEM_LIMIT
            else:
                assert mt == tqm.GEMM_TILE


def test_fp32_plans_depend_on_shape_alone():
    """The plan, and with it the order of every fp32 sum, is a function
    of (variant, M, N, K), the same at every call."""
    for k, n in SHAPES:
        for m in smoke.MATMUL_MS:
            variant = tqm.matmul_variant(torch.float32, m, n, k)
            assert variant in FP32
            assert len({tqm.split_plan(variant, m, n, k)
                        for _ in range(3)}) == 1


@pytest.mark.parametrize("k,n", smoke.MATMUL_SHAPES, ids=str)
def test_fp32_plans_fill_the_card(k, n):
    """Both ask for the parts that fit one wave (none past one part while
    their tiles fill it; the stream's wave is one block an SM, the
    GEMM's two), the stream for more where its x slice would not fit;
    each plan then takes the shortest parts of whole k-tiles that need no
    more parts than asked."""
    k_tiles = -(-k // tqm.K_TILE)
    for m in smoke.MATMUL_MS:
        for variant in FP32:
            mt, _, splits, tpp = tqm.split_plan(variant, m, n, k)
            tiles = -(-m // mt) * -(-n // tqm.FP32_CHANNELS)
            if variant == "fp32_stream":
                most = tqm.FP32_X_SLICE_BYTES // (mt * tqm.K_TILE * 4)
                asked = max(tqm.PLAN_SMS // tiles, -(-k_tiles // most))
                assert splits == 1 or tiles * splits <= tqm.PLAN_SMS \
                    or splits <= -(-k_tiles // most)
            else:
                wave = tqm.PLAN_SMS * tqm.FP32_GEMM_BLOCKS_PER_SM
                asked = wave // tiles
                assert splits == 1 or tiles * splits <= wave
            asked = max(1, min(k_tiles, asked))
            assert splits <= asked
            assert tpp == 1 or -(-k_tiles // (tpp - 1)) > asked


def test_decode_plans_at_llama_shapes():
    """A decode tick (M = 8) at each Llama-3-8B weight: 8-token tiles,
    K split into the parts that fit one wave of 128-channel blocks:
    gate/up (112 blocks) and lm_head (1002) unsplit, no workspace."""
    want = {(4096, 4096): 4, (4096, 1024): 16, (4096, 14336): 1,
            (14336, 4096): 4, (4096, 128256): 1}
    for (k, n), splits in want.items():
        assert tqm.split_plan("fp32_stream", 8, n, k)[::2] == (8, splits)
    assert tqm.split_plan("fp32_gemm", 256, 128256, 4096)[2] == 1


# ----------------------------------------------------------- conversion

@pytest.mark.parametrize("i", range(4))
def test_fp32_conversion_is_exact_for_every_code(i):
    """``code_f32``: byte i of a word xor 0x80808080 permuted into fp32
    bits 0x4B0000bb (2^23 + bb), minus 2^23 + 128, is the code, for all
    256 codes at each byte position."""
    codes = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    u = codes.view(np.uint32)[:, 0] ^ np.uint32(0x80808080)
    bits = byte_perm(u, 0x4B000000, 0x7540 | i)
    assert (bits >> 24 == 0x4B).all()
    val = bits.view(np.float32) - np.float32(8388736.0)
    assert val.dtype == np.float32
    np.testing.assert_array_equal(val, codes[:, i].astype(np.float32))


# ------------------------------------------------- the kernels, imitated

def imitate_fp32(x, wq, scale, variant, n_full, fault=None):
    """An fp32 kernel's arithmetic on the CPU, at the plan of the full
    ``n_full`` channels (``wq`` may hold a slice of them): per K part, the
    stream's L = 8 / G k-lanes (lane l takes the 16-code chunks kk with kk
    % L == l of every 128-code box) each run one fp32 chain, k ascending,
    and the chains are added l = 0 .. L - 1; the GEMM runs one chain, k
    ascending. Each part's unscaled partial goes to a workspace of
    ``len(parts) x M`` rows, the partials are added in the order of the
    parts, ``scale[n]`` once, one cast to x's dtype. ``fault`` plants one
    defect: ``"drop_last_part"``, ``"stale_stage"`` (one box replaced by
    the one a ring's depth before it), ``"neighbour_scale"``,
    ``"row_past_m"`` (every part writes all rows of its token tile, the
    last parts first)."""
    m, k = x.shape
    mt, _, _, _ = tqm.split_plan(variant, m, n_full, k)
    parts = tqm.split_parts(variant, m, n_full, k)
    lanes = WARPS // (mt // 8) if variant == "fp32_stream" else 1
    xf, wf = x.float(), wq.float()
    if fault == "stale_stage":
        t = (k // tqm.K_TILE) // 2
        old = (t - STAGES) * tqm.K_TILE
        wf = wf.clone()
        wf[:, t * tqm.K_TILE:(t + 1) * tqm.K_TILE] = \
            wf[:, old:old + tqm.K_TILE]
    sc = torch.roll(scale, -1) if fault == "neighbour_scale" else scale
    n = wq.shape[0]
    work = torch.zeros((len(parts) * m + mt, n))
    order = range(len(parts))
    if fault == "row_past_m":
        order = reversed(order)
    for s in order:
        k0, k1 = parts[s]
        total = None
        for lane in range(lanes):
            acc = torch.zeros((m, n))
            for kk in range(k0, k1):
                if ((kk - k0) // 16) % lanes == lane:
                    acc.addcmul_(xf[:, kk:kk + 1], wf[:, kk])
            total = acc if total is None else total + acc
        rows = -(-m // mt) * mt if fault == "row_past_m" else m
        if rows > m:                 # rows of the tile past M: x read as 0
            total = torch.cat([total, torch.zeros((rows - m, n))])
        work[s * m:s * m + rows] = total
    if fault == "drop_last_part":
        work[(len(parts) - 1) * m:] = 0
    total = work[:m].clone()
    for s in range(1, len(parts)):
        total = total + work[s * m:(s + 1) * m]
    return (total * sc).to(x.dtype)


def _operands(k, m, seed, channels=64):
    """Seeded fp32 x and ``channels`` channels of an N(0, 0.02) bf16
    weight quantised as the model's are."""
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((channels, k), generator=g) * 0.02).bfloat16()
    wq, ws = tqm.quantize_weight(w)
    return torch.randn((m, k), generator=g), wq, ws


def fp32_error(got, ref):
    """chip_smoke's fp32 rule for B10: max error over the reference's
    largest magnitude, within FP32_TOL."""
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("variant", FP32)
@pytest.mark.parametrize("k,n,m", [(4096, 1024, 8), (14336, 4096, 17),
                                   (4096, 4096, 33), (4096, 14336, 256),
                                   (4096, 128256, 1), (4144, 1000, 65)],
                         ids=str)
def test_imitation_passes_fp32_tol(k, n, m, variant):
    """At the chip's shapes (the plan of the full N, 64 channels of it
    computed; each variant also at the other's M), the imitation is
    within FP32_TOL of the plain version."""
    x, wq, ws = _operands(k, m, seed=k + n + m)
    got = imitate_fp32(x, wq, ws, variant, n)
    ref = tqm.int8_matmul_plain(x, wq, ws)
    assert got.dtype == torch.float32
    assert fp32_error(got, ref) <= smoke.FP32_TOL


@pytest.mark.parametrize("m,k,n", [(8, 512, 96), (24, 1024, 200),
                                   (40, 384, 160), (130, 256, 72)], ids=str)
def test_imitation_matches_interpret_kernel(m, k, n):
    """The variant the rule names, at scaled-down shapes, within 1e-5 of
    the largest output of the JAX package's interpret-mode Pallas
    kernel."""
    rng = np.random.RandomState(m + k + n)
    jq, js = jqm.quantize_weight(jnp.asarray(rng.randn(k, n), jnp.float32))
    x = rng.randn(m, k).astype(np.float32)
    want = np.asarray(jqm.int8_matmul(jnp.asarray(x), jq, js,
                                      interpret=True))
    variant = tqm.matmul_variant(torch.float32, m, n, k)
    got = imitate_fp32(torch.from_numpy(x),
                       torch.from_numpy(np.asarray(jq).T.copy()),
                       torch.from_numpy(np.array(js)), variant, n)
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) <= 1e-5


def _splits(variant, k, n, m):
    return tqm.split_plan(variant, m, n, k)[2]


#: each variant at an M of its own (1 and 200 leave rows of the token
#: tile past M)
FAULT_CASES = [(v, k, n, m, f) for v, m in (("fp32_stream", 1),
                                            ("fp32_gemm", 200))
               for k, n in smoke.MATMUL_SHAPES
               for f in ("stale_stage", "neighbour_scale",
                         "drop_last_part", "row_past_m")
               if f in ("stale_stage", "neighbour_scale")
               or _splits(v, k, n, m) > 1]


def test_fault_cases_cover_every_split_shape():
    """The two faults that need a split K are planted at every weight
    shape whose fp32 plan splits: q/o, k/v and down, in the stream at M =
    1 and the GEMM at M = 200 (gate/up's 112 and 224 blocks and
    lm_head's 1002 and 2004 fill the card unsplit)."""
    split = {(v, k, n) for v, k, n, _, f in FAULT_CASES
             if f == "row_past_m"}
    assert split == {("fp32_stream", 4096, 4096), ("fp32_stream", 4096, 1024),
                     ("fp32_stream", 14336, 4096),
                     ("fp32_gemm", 4096, 4096), ("fp32_gemm", 4096, 1024),
                     ("fp32_gemm", 14336, 4096)}


@pytest.mark.parametrize("variant,k,n,m,fault", FAULT_CASES, ids=str)
def test_planted_faults_fail_fp32_tol(variant, k, n, m, fault):
    """Each planted fault breaks FP32_TOL at the chip's shapes (the plan
    of the full N, 64 of its channels computed)."""
    x, wq, ws = _operands(k, m, seed=7 * k + n + m)
    got = imitate_fp32(x, wq, ws, variant, n, fault)
    assert fp32_error(got, tqm.int8_matmul_plain(x, wq, ws)) \
        > smoke.FP32_TOL
