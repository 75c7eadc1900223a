"""Weight-only int8 matmul (port of
``paddle_tpu/ops/pallas/quant_matmul.py``).

A weight is stored as int8 codes ``[N, K]`` (torch's ``[out, in]``
Linear layout; the reference keeps ``[K, N]``) and one fp32 scale per
output channel ``[N]``. The product ``x @ (q * scale).T`` is computed as
the reference's kernel computes it: exact products, one fp32 sum over the
whole K reduction, times ``scale[n]`` once at the end, then cast to x's
dtype. There is no int8 x int8 product.

A CUDA tensor goes to kernel B10 (``csrc/quant_matmul.cu``) or raises; a
CPU tensor runs :func:`int8_matmul_plain`. The reference's
dequantise-and-matmul fallback behind its compile guard has no
counterpart. B10 has five variants, chosen by :func:`matmul_variant`
before the launch: two on the tensor cores for bf16 and fp16 x (a split-K
weight stream for decode M, a GEMM for prefill M; their fp32 sums differ
from the reference's only in order, ROADMAP C20), the same two shapes on
the fp32 FMA units for fp32 x, and the simple scalar kernel for K % 16 !=
0 in every dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: codes of K per tensor-core k-tile (one 128-byte row of a weight box)
K_TILE = 128
#: token tiles (wgmma's N) of the stream variant, one consumer warpgroup
STREAM_TILES = (8, 16, 32)
#: the largest M the stream variant takes; the GEMM takes larger M (the
#: two cross over between M = 32 and 48 on an H100, PERF.md section 6)
STREAM_MAX_M = 32
#: the GEMM's token tile and consumer warpgroups (128 channels a block)
GEMM_TILE, GEMM_WARPGROUPS = 128, 2
#: SMs the split-K plan fills (an H100 SXM's), fixed so that the plan,
#: and with it the order of every sum, depends on (M, N, K) alone
PLAN_SMS = 132
#: token tiles of the fp32 stream variant (8 tokens a consumer warp's
#: group); it takes fp32 x up to FP32_STREAM_MAX_M, the fp32 GEMM above
FP32_STREAM_TILES = (8, 16, 32, 64)
FP32_STREAM_MAX_M = 64
#: output channels of an fp32 block (both fp32 variants)
FP32_CHANNELS = 128
#: fp32 GEMM blocks an SM holds at once (its registers and shared memory
#: allow two), so one wave of them is twice PLAN_SMS
FP32_GEMM_BLOCKS_PER_SM = 2
#: shared memory a stream block may give its part's x slice (token tile x
#: the part's k-tiles in fp32), so that the block fits beside its 64 KB
#: weight ring: parts are cut shorter where the slice would not fit
FP32_X_SLICE_BYTES = 128 * 1024
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _cdiv(a, b):
    return -(-a // b)


def matmul_variant(dtype, M, N, K):
    """Which B10 kernel a CUDA call ``x [M, K]`` by ``w_int8 [N, K]``
    takes: ``"wgmma_stream"`` (tensor cores, split-K weight stream) for
    bf16 and fp16 at ``M <= STREAM_MAX_M``, ``"wgmma_gemm"`` (tensor
    cores, 128 x 128 tiles) above it; ``"fp32_stream"`` (fp32 FMAs,
    split-K weight stream) for fp32 at ``M <= FP32_STREAM_MAX_M`` and
    ``"fp32_gemm"`` (fp32 FMAs, 128 x 128 register tiles) above it, which
    keep the reference's fp32 parity; all four only where TMA and 16-byte
    copies can read the operands (``K % 16 == 0``; the wrapper copies an
    x whose base is not 16-byte aligned and refuses such a weight);
    ``"simt"`` (the simple scalar kernel) for any other K, in every
    dtype. Raises for a dtype no kernel takes or a shape with no work
    defined."""
    if dtype not in _DTYPES:
        raise TypeError(f"int8 matmul takes x in {list(_DTYPES)}, got "
                        f"{dtype}")
    if M < 0 or N <= 0 or K <= 0:
        raise ValueError(f"int8 matmul shape M={M} N={N} K={K}")
    if K % 16:
        return "simt"
    if dtype == torch.float32:
        return "fp32_stream" if M <= FP32_STREAM_MAX_M else "fp32_gemm"
    return "wgmma_stream" if M <= STREAM_MAX_M else "wgmma_gemm"


def split_plan(variant, M, N, K):
    """The launch plan of a variant other than ``"simt"``: ``(mt, nwg,
    splits, tpp)``: the token tile ``mt`` (wgmma's N; the fp32 kernels'
    tokens a block), ``nwg`` 64-channel groups a block (the tensor-core
    kernels' consumer warpgroups; 2 for the fp32 kernels' 128 channels),
    and K's ``ceil(K / K_TILE)`` k-tiles cut into ``splits`` parts of
    ``tpp`` tiles (the last part may be shorter, none is empty). The
    tensor-core stream asks for the parts that bring its blocks to at
    least one per SM; the fp32 stream (one block an SM: its x slice
    takes most of the shared memory) and the GEMMs for the parts that fit
    one wave (none while their tiles fill the SMs; the fp32 GEMM's wave
    is ``FP32_GEMM_BLOCKS_PER_SM`` blocks an SM), the fp32 stream also
    for parts whose x slice fits ``FP32_X_SLICE_BYTES``; the parts are
    then the shortest runs of whole k-tiles that need no more parts than
    asked. The parts' fp32 partials are added in the order of the
    parts."""
    k_tiles = _cdiv(K, K_TILE)
    if variant in ("wgmma_stream", "fp32_stream"):
        fp32 = variant == "fp32_stream"
        tiles_m = FP32_STREAM_TILES if fp32 else STREAM_TILES
        mt = next((t for t in tiles_m if t >= M), tiles_m[-1])
        nwg = FP32_CHANNELS // 64 if fp32 else 1
        tiles = _cdiv(M, mt) * _cdiv(N, 64 * nwg)
        splits = _cdiv(PLAN_SMS, tiles)
        if fp32:
            most = FP32_X_SLICE_BYTES // (mt * K_TILE * 4)
            splits = max(PLAN_SMS // tiles, _cdiv(k_tiles, most))
    elif variant in ("wgmma_gemm", "fp32_gemm"):
        mt = GEMM_TILE
        nwg = (GEMM_WARPGROUPS if variant == "wgmma_gemm"
               else FP32_CHANNELS // 64)
        tiles = _cdiv(M, mt) * _cdiv(N, 64 * nwg)
        wave = PLAN_SMS * (FP32_GEMM_BLOCKS_PER_SM
                           if variant == "fp32_gemm" else 1)
        splits = wave // tiles
    else:
        raise ValueError(f"no split plan for variant {variant!r}")
    splits = max(1, min(k_tiles, splits))
    tpp = _cdiv(k_tiles, splits)
    return mt, nwg, _cdiv(k_tiles, tpp), tpp


def split_parts(variant, M, N, K):
    """The K range ``(k0, k1)`` of every part of :func:`split_plan`, in
    the order their partials are added."""
    _, _, splits, tpp = split_plan(variant, M, N, K)
    return [(s * tpp * K_TILE, min(K, (s + 1) * tpp * K_TILE))
            for s in range(splits)]


def quantize_weight(w):
    """``w [N, K]`` float -> ``(int8 [N, K], float32 scale [N])``,
    symmetric per output channel (abs-max over K). As in the reference
    (``quant_matmul.py:130-136``) the arithmetic runs in the weight's own
    dtype: for a bf16 weight the abs-max, the ``/ 127``, the division and
    the rounding (half to even) are bf16, and only the scale returned is
    upcast to fp32. The divisor is a tensor: a Python scalar would let
    CUDA multiply by its reciprocal instead of dividing."""
    amax = w.abs().amax(1).clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def int8_matmul_plain(x, w_int8, scale):
    """``x [M, K]`` float, ``w_int8 [N, K]`` int8, ``scale [N]`` fp32 ->
    ``[M, N]`` in x's dtype: fp32 operands, fp32 accumulation, the scale
    applied to the accumulator, then the cast."""
    acc = x.float() @ w_int8.float().t()
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x, w_int8, scale):
    """Kernel B10: ``x [M, K]`` (fp32, bf16 or fp16) times the int8
    weight ``w_int8 [N, K]`` with per-channel ``scale [N]`` -> ``[M, N]``
    in x's dtype. A CPU tensor runs :func:`int8_matmul_plain`. A CUDA
    call launches the kernel :func:`matmul_variant` names. CUDA calls
    are counted in ``int8_matmul.launches``, those of the four variants
    other than ``"simt"`` also in ``.<variant>_launches``
    (``.wgmma_stream_launches``, ``.wgmma_gemm_launches``,
    ``.fp32_stream_launches``, ``.fp32_gemm_launches``), and every one by
    M in ``.launches_by_m`` (``{M: count}``)."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul for device {x.device}")
    code = _build.dtype_code(x.dtype)
    for name, t, dtype in (("w_int8", w_int8, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{dtype} on {x.device}")
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[1] \
            or tuple(scale.shape) != (w_int8.shape[0],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_int8 "
                         f"{tuple(w_int8.shape)}, scale {tuple(scale.shape)}")
    (M, K), N = x.shape, w_int8.shape[0]
    variant = matmul_variant(x.dtype, M, N, K)
    x, w_int8 = x.contiguous(), w_int8.contiguous()
    scale = scale.contiguous()
    if w_int8.data_ptr() % 16:
        raise ValueError("w_int8 must start on a 16-byte boundary (as "
                         "quantize_weight's codes do): the kernels load "
                         "16-byte rows and TMA boxes of it")
    if x.data_ptr() % 16:
        x = x.clone()                   # a fresh allocation is aligned
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, w_int8, scale, out)]
    counters = ((int8_matmul, "launches"), (int8_matmul.launches_by_m, M))
    if variant == "simt":
        _build.launch("ptt_int8_matmul", x.device,
                      [ctypes.c_int(code)] + ptrs
                      + [ctypes.c_int(v) for v in (M, N, K)], counters)
        return out
    mt, nwg, splits, tpp = split_plan(variant, M, N, K)
    part = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    ptrs.append(ctypes.c_void_p(None if part is None else part.data_ptr()))
    counters += ((int8_matmul, f"{variant}_launches"),)
    if variant.startswith("fp32"):
        _build.launch("ptt_int8_matmul_fp32", x.device,
                      [ctypes.c_int(variant == "fp32_gemm")] + ptrs
                      + [ctypes.c_int(v) for v in (M, N, K, mt, splits, tpp)],
                      counters)
    else:
        _build.launch("ptt_int8_matmul_wgmma", x.device,
                      [ctypes.c_int(code)] + ptrs
                      + [ctypes.c_int(v)
                         for v in (M, N, K, mt, nwg, splits, tpp)],
                      counters)
    return out


int8_matmul.launches = 0
int8_matmul.wgmma_stream_launches = 0
int8_matmul.wgmma_gemm_launches = 0
int8_matmul.fp32_stream_launches = 0
int8_matmul.fp32_gemm_launches = 0
int8_matmul.launches_by_m = {}
