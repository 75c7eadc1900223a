"""The tensor-core variants of the port's weight-only int8 matmul (B10).

What the CUDA kernels cannot show on a CPU, tested here: which variant a
call takes (``matmul_variant``), the split-K plan
(``split_plan``, ``split_parts``), the exact int8 -> bf16 / fp16
conversion the kernel does in registers (emulated with numpy bit
operations for all 256 codes), and the check ``chip_smoke.py`` holds the
kernels to on the card (ROADMAP C20, ``chip_smoke.c20_error``). A CPU
imitation of the kernel's arithmetic (exact products, k16 steps in
order, split-K partials added in a fixed order, the scale once after the
sum, one cast) must pass C20 against the plain version and match the JAX
package's interpret-mode Pallas ``int8_matmul`` in fp32; the same
imitation with a fault planted (a dropped last K part, a stale ring
stage, the neighbouring channel's scale, a row written past M) must fail
C20 at the chip's weight shapes. Scaling each partial before the sum is
not caught by C20, which is why the kernel's source states the order.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu_torch.ops import quant_matmul as tqm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

#: kStages of csrc/quant_matmul.cu: the ring a stale stage comes from
STAGES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- variants

@pytest.mark.parametrize("dtype,m,k,forced,want", [
    (torch.bfloat16, 1, 4096, None, "wgmma_stream"),
    (torch.bfloat16, 8, 4096, None, "wgmma_stream"),
    (torch.float16, 32, 14336, None, "wgmma_stream"),
    (torch.bfloat16, 33, 4096, None, "wgmma_gemm"),
    (torch.float16, 256, 4096, None, "wgmma_gemm"),
    (torch.bfloat16, 300, 14336, None, "wgmma_gemm"),
    (torch.bfloat16, 0, 4096, None, "wgmma_stream"),
    (torch.float32, 8, 4096, None, "fp32_stream"),
    (torch.float32, 256, 14336, None, "fp32_gemm"),
    (torch.bfloat16, 8, 4104, None, "simt"),
    (torch.float16, 256, 4100, None, "simt"),
    # chip_smoke forces a tensor-core variant by moving STREAM_MAX_M: a
    # call on the tensor cores follows, an fp32 one or one on the scalar
    # kernel stays
    (torch.bfloat16, 8, 4096, "wgmma_gemm", "wgmma_gemm"),
    (torch.float16, 256, 4096, "wgmma_stream", "wgmma_stream"),
    (torch.float32, 8, 4096, "wgmma_gemm", "fp32_stream"),
    (torch.float32, 256, 4096, "wgmma_stream", "fp32_gemm"),
    (torch.bfloat16, 8, 4104, "wgmma_gemm", "simt"),
    (torch.float16, 256, 4100, "wgmma_stream", "simt")])
def test_matmul_variant(dtype, m, k, forced, want):
    rule = tqm.STREAM_MAX_M
    with smoke.forced_variant(tqm, forced):
        assert tqm.matmul_variant(dtype, m, 1024, k) == want
    assert tqm.STREAM_MAX_M == rule


@pytest.mark.parametrize("dtype,m,n,k,exc", [
    (torch.float64, 8, 1024, 4096, TypeError),
    (torch.int8, 8, 1024, 4096, TypeError),
    (torch.bfloat16, -1, 1024, 4096, ValueError),
    (torch.bfloat16, 8, 0, 4096, ValueError),
    (torch.float16, 8, 1024, 0, ValueError)])
def test_matmul_variant_raises(dtype, m, n, k, exc):
    with pytest.raises(exc):
        tqm.matmul_variant(dtype, m, n, k)


def test_int8_matmul_refuses_other_devices():
    x = torch.empty((8, 4096), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no int8 matmul"):
        tqm.int8_matmul(x, torch.zeros((16, 4096), dtype=torch.int8),
                        torch.ones(16))


# ----------------------------------------------------------- split plan

PLAN_CASES = [(k, n, m) for k, n in smoke.MATMUL_SHAPES
              for m in smoke.MATMUL_MS]


@pytest.mark.parametrize("k,n", smoke.MATMUL_SHAPES, ids=str)
def test_split_parts_cover_k_once(k, n):
    """At every M of the chip's list, in both tensor-core variants: the
    parts run in order over K, each a nonempty run of whole k16 steps,
    without gap or overlap; the plan is what the C entry point accepts
    ((S - 1) tpp < k_tiles <= S tpp)."""
    for m in smoke.MATMUL_MS:
        for variant in smoke.TENSOR_CORE_VARIANTS:
            mt, nwg, splits, tpp = tqm.split_plan(variant, m, n, k)
            parts = tqm.split_parts(variant, m, n, k)
            k_tiles = -(-k // tqm.K_TILE)
            assert len(parts) == splits >= 1
            assert (splits - 1) * tpp < k_tiles <= splits * tpp
            assert parts[0][0] == 0 and parts[-1][1] == k
            for (a0, a1), (b0, _) in zip(parts, parts[1:]):
                assert a1 == b0
            for a0, a1 in parts:
                assert a0 < a1 and a0 % 16 == 0 and a1 % 16 == 0
            assert mt >= min(m, mt) and mt in (*tqm.STREAM_TILES,
                                               tqm.GEMM_TILE)
            assert nwg == (1 if variant == "wgmma_stream" else 2)


def test_split_plan_depends_on_shape_alone():
    """The plan, and with it the order of every fp32 sum, is a function
    of (variant, M, N, K): the same for bf16 and fp16 and for every
    call, so two launches on the same inputs add the same partials in
    the same order."""
    for k, n, m in PLAN_CASES:
        variant = tqm.matmul_variant(torch.bfloat16, m, n, k)
        assert tqm.matmul_variant(torch.float16, m, n, k) == variant
        plans = {tqm.split_plan(variant, m, n, k) for _ in range(3)}
        assert len(plans) == 1


@pytest.mark.parametrize("k,n", smoke.MATMUL_SHAPES, ids=str)
def test_split_plan_fills_the_card(k, n):
    """The stream asks for the parts that bring its blocks to at least
    one per SM, the GEMM for the parts that fit one wave (none past one
    part where its tiles fill it); each plan then takes the shortest
    parts of whole k-tiles that need no more parts than asked."""
    k_tiles = -(-k // tqm.K_TILE)
    for m in smoke.MATMUL_MS:
        variant = tqm.matmul_variant(torch.bfloat16, m, n, k)
        mt, nwg, splits, tpp = tqm.split_plan(variant, m, n, k)
        tiles = -(-m // mt) * -(-n // (64 * nwg))
        if variant == "wgmma_stream":
            asked = -(-tqm.PLAN_SMS // tiles)
        else:
            asked = tqm.PLAN_SMS // tiles
        asked = max(1, min(k_tiles, asked))
        assert splits <= asked
        assert tpp == 1 or -(-k_tiles // (tpp - 1)) > asked
        if variant == "wgmma_gemm":
            assert splits == 1 or tiles * splits <= tqm.PLAN_SMS


def test_decode_plans_at_llama_shapes():
    """A decode tick (M = 8) at each Llama-3-8B weight: 8-token tiles,
    K split where the 64-channel tiles are fewer than the SMs, not at
    gate/up (224 tiles) or lm_head (2004)."""
    want = {(4096, 4096): 3, (4096, 1024): 8, (4096, 14336): 1,
            (14336, 4096): 3, (4096, 128256): 1}
    for (k, n), splits in want.items():
        assert tqm.split_plan("wgmma_stream", 8, n, k)[::2] == (8, splits)


# ----------------------------------------------------------- conversion

def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte n of the
    result is byte ``(sel >> 4 n) & 7`` of the 8-byte value ``y:x``."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * b)) & np.uint64(0xFF)) \
            << np.uint64(8 * n)
    return out.astype(np.uint32)


def _words():
    """All 256 int8 codes, four to a little-endian 32-bit word as the
    kernel loads them, each byte biased by 128 (xor 0x80)."""
    codes = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)
    return codes, codes.view(np.uint32)[:, 0] ^ np.uint32(0x80808080)


@pytest.mark.parametrize("i", [0, 2])
def test_bf16_conversion_is_exact_for_every_code(i):
    """fp32 bits 0x4B0000bb are 2^23 + bb; minus 2^23 + 128 gives the
    code; two such values pack to bf16x2 without rounding."""
    codes, u = _words()
    for j in (i, i + 1):
        bits = byte_perm(u, 0x4B000000, 0x7540 | j)
        val = bits.view(np.float32) - np.float32(8388736.0)
        np.testing.assert_array_equal(val, codes[:, j].astype(np.float32))
        t = torch.from_numpy(val.copy())
        assert torch.equal(t.bfloat16().float(), t)


@pytest.mark.parametrize("i", [0, 2])
def test_fp16_conversion_is_exact_for_every_code(i):
    """Half bits 0x64bb are 1024 + bb; one half2 subtract of 1152 gives
    both codes of a register, byte i in the low half."""
    codes, u = _words()
    h = byte_perm(u, 0x64646464, 0x4040 | i | ((i + 1) << 8))
    halves = h.view(np.float16).reshape(-1, 2)
    assert halves.view(np.uint16).reshape(-1, 2)[0, 0] >> 8 == 0x64
    val = halves - np.float16(1152)
    assert val.dtype == np.float16
    np.testing.assert_array_equal(val[:, 0], codes[:, i].astype(np.float16))
    np.testing.assert_array_equal(val[:, 1],
                                  codes[:, i + 1].astype(np.float16))


# ------------------------------------------------- the kernel, imitated

def imitate_b10(x, wq, scale, parts, fault=None, mt=8):
    """The tensor-core kernel's arithmetic on the CPU: the codes exact
    in x's dtype, every product exact in fp32, each k16 step's 16
    products summed in fp32 and added to the fp32 accumulator step by
    step, one partial per K part in a workspace of ``len(parts) x M``
    rows, the partials added in the order of the parts, ``scale[n]``
    once, one cast to x's dtype. ``fault`` plants one defect:
    ``"drop_last_part"``, ``"stale_stage"`` (one k-tile's weight box
    replaced by the one a ring's depth before it, as if its stage were
    read before the new copy landed), ``"neighbour_scale"``,
    ``"row_past_m"`` (every part writes all ``mt`` rows of its token
    tile, the last parts first), ``"scale_each_part"``."""
    m, k = x.shape
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
        steps = torch.einsum("msj,nsj->smn",
                             xf[:, k0:k1].reshape(m, -1, 16),
                             wf[:, k0:k1].reshape(n, -1, 16))
        acc = torch.zeros((m, n))
        for step in steps:
            acc = acc + step
        if fault == "scale_each_part":
            acc = acc * sc
        rows = -(-m // mt) * mt if fault == "row_past_m" else m
        if rows > m:                 # rows of the tile past M: x read as 0
            acc = torch.cat([acc, torch.zeros((rows - m, n))])
        work[s * m:s * m + rows] = acc
    if fault == "drop_last_part":
        work[(len(parts) - 1) * m:] = 0
    total = work[:m].clone()
    for s in range(1, len(parts)):
        total = total + work[s * m:(s + 1) * m]
    if fault != "scale_each_part":
        total = total * sc
    return total.to(x.dtype)


def _operands(k, n, m, seed, channels=64):
    """Seeded x and the first ``channels`` channels of an N(0, 0.02) bf16
    weight quantised as the model's are."""
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((channels, k), generator=g) * 0.02).bfloat16()
    wq, ws = tqm.quantize_weight(w)
    return torch.randn((m, k), generator=g), wq, ws


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k,n,m", [(4096, 1024, 8), (14336, 4096, 17),
                                   (4096, 4096, 33), (4096, 14336, 256),
                                   (4096, 128256, 300)], ids=str)
def test_imitation_passes_c20(k, n, m, dtype):
    """At the chip's shapes (the plan of the full N, 64 channels of it
    computed), the imitation passes C20 against the plain version."""
    x, wq, ws = _operands(k, n, m, seed=k + n + m)
    x = x.to(dtype)
    variant = tqm.matmul_variant(dtype, m, n, k)
    got = imitate_b10(x, wq, ws, tqm.split_parts(variant, m, n, k))
    ref = tqm.int8_matmul_plain(x.float(), wq, ws)
    _, ratio = smoke.c20_error(torch, got, ref)
    assert ratio <= 1.0


@pytest.mark.parametrize("m,k,n", [(8, 512, 96), (40, 384, 160),
                                   (130, 256, 72)], ids=str)
def test_imitation_matches_interpret_kernel_fp32(m, k, n):
    """The same arithmetic in fp32 (no cast) within 1e-5 of the largest
    output of the JAX package's interpret-mode Pallas kernel, as the
    plain version is held in ``test_torch_quant.py``."""
    rng = np.random.RandomState(m + k + n)
    jq, js = jqm.quantize_weight(jnp.asarray(rng.randn(k, n), jnp.float32))
    x = rng.randn(m, k).astype(np.float32)
    want = np.asarray(jqm.int8_matmul(jnp.asarray(x), jq, js,
                                      interpret=True))
    variant = tqm.matmul_variant(torch.bfloat16, m, n, k)
    parts = tqm.split_parts(variant, m, n, k)
    got = imitate_b10(torch.from_numpy(x),
                      torch.from_numpy(np.asarray(jq).T.copy()),
                      torch.from_numpy(np.array(js)), parts)
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) <= 1e-5


def _splits(k, n, m):
    return tqm.split_plan(tqm.matmul_variant(torch.bfloat16, m, n, k),
                          m, n, k)[2]


#: M = 1 and 200 leave rows of the last token tile (8 and 128) past M
FAULT_CASES = [(k, n, m, fault) for k, n in smoke.MATMUL_SHAPES
               for m in (1, 200)
               for fault in ("stale_stage", "neighbour_scale")] + [
    (k, n, m, fault) for k, n in smoke.MATMUL_SHAPES for m in (1, 200)
    for fault in ("drop_last_part", "row_past_m") if _splits(k, n, m) > 1]


def test_fault_cases_cover_every_split_shape():
    """The two faults that need a split K are planted at every weight
    shape whose plan splits at M = 1 or 200: q/o, k/v and down (gate/up's
    224 and lm_head's 2004 channel tiles fill the card unsplit)."""
    split = {(k, n) for k, n, _, f in FAULT_CASES if f == "row_past_m"}
    assert split == {(4096, 4096), (4096, 1024), (14336, 4096)}


@pytest.mark.parametrize("k,n,m,fault", FAULT_CASES, ids=str)
def test_planted_faults_fail_c20(k, n, m, fault):
    """Each planted fault breaks C20 at the chip's shapes (the plan of
    the full N, 64 of its channels computed)."""
    variant = tqm.matmul_variant(torch.bfloat16, m, n, k)
    mt = tqm.split_plan(variant, m, n, k)[0]
    x, wq, ws = _operands(k, n, m, seed=7 * k + n + m)
    x = x.bfloat16()
    got = imitate_b10(x, wq, ws, tqm.split_parts(variant, m, n, k), fault,
                      mt)
    _, ratio = smoke.c20_error(torch, got,
                               tqm.int8_matmul_plain(x.float(), wq, ws))
    assert ratio > 1.0


@pytest.mark.parametrize("k,n,m", [(4096, 1024, 8), (14336, 4096, 8),
                                   (4096, 4096, 256)], ids=str)
def test_scaling_each_part_is_not_caught(k, n, m):
    """For the record: a kernel that scales every partial before the
    sum passes C20 (the two orders differ by a rounding), so the rule
    cannot hold the kernel to the reference's order; the source does
    (the scale once, after the fixed-order sum, ROADMAP C13)."""
    variant = tqm.matmul_variant(torch.bfloat16, m, n, k)
    parts = tqm.split_parts(variant, m, n, k)
    assert len(parts) > 1
    x, wq, ws = _operands(k, n, m, seed=k - n + m)
    x = x.bfloat16()
    ref = tqm.int8_matmul_plain(x.float(), wq, ws)
    good = imitate_b10(x, wq, ws, parts)
    bad = imitate_b10(x, wq, ws, parts, "scale_each_part")
    assert smoke.c20_error(torch, good, ref)[1] <= 1.0
    assert smoke.c20_error(torch, bad, ref)[1] <= 1.0


def test_c20_error_reads_one_ulp_as_within():
    """The rule's edge: one ulp off the rounded reference reads just
    under 1, two ulps over it (bf16 and fp16)."""
    ref = torch.tensor([[1.0, -3.0, 0.5]])
    for dt, ulp in ((torch.bfloat16, 2.0 ** -7), (torch.float16, 2.0 ** -10)):
        one = (ref + ulp * torch.tensor([[1.0, 2.0, 0.5]])).to(dt)
        two = (ref + 2 * ulp * torch.tensor([[1.0, 2.0, 0.5]])).to(dt)
        assert smoke.c20_error(torch, one, ref)[1] <= 1.0
        assert smoke.c20_error(torch, two, ref)[1] > 1.0
