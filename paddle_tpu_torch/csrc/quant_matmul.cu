// Weight-only int8 matmul for Hopper (sm_90a): out[M, N] = (x[M, K] @
// w[N, K]^T) * scale[N], in x's type.
//
// Replaces the Pallas TPU kernel _kernel of
// paddle_tpu/ops/pallas/quant_matmul.py (:65, int8_matmul :83, pallas_call
// :112; grid (m, n, k), k sequential). Like it, every product of the whole
// K reduction is exact and summed in fp32, the sum is multiplied by
// scale[n] once at the end and cast to x's type once. No int8 x int8
// product and no int32 accumulator (the reference dots in fp32, see
// ROADMAP C5). Four kernels, chosen by the wrapper (ops/quant_matmul.py,
// matmul_variant) before the launch:
//
// int8_matmul_wgmma_kernel, for bf16 and fp16 x with K % 16 == 0 (the
// main path). An int8 code in [-127, 127] is exact in bf16 and fp16, and
// its product with a bf16 or fp16 x is exact in fp32, so a tensor-core
// product with fp32 accumulators differs from the reference only in the
// order of the fp32 sum (ROADMAP C20). What bounds it on an H100: at a
// decode tick (M = 8) each weight byte serves 2 M = 16 flops, far under
// the ~295 flops a byte where bf16 tensor cores take over, so the floor is
// the int8 weight read once at 3.35 TB/s; at a 256-token tick (M = 256)
// it is 512 flops a byte and the 989 TFLOP/s of the tensor cores bound
// it. The design, for both:
//   - A and B swapped: out^T[N, M] = W[N, K] x^T. The weight is wgmma's A
//     operand (64 output channels a consumer warpgroup), the MT tokens of
//     the block its N (MT = 8, 16, 32 or 128; MT = 8 covers a decode
//     tick of 8 tokens with no padding). Each accumulator row is one
//     output channel, so scale[n] is one register a row.
//   - One producer warp issues TMA copies of int8 weight boxes (64 NWG
//     rows x 128 codes, 128-byte swizzled) and of the x tile (two 64-column
//     boxes of MT rows) into a ring of kStages stages, full/empty
//     mbarriers; TMA's zero fill covers rows past M and N and codes past K.
//   - Consumers read their A fragment's codes from the swizzled box (two
//     32-bit loads a row and k16 step: a k16 step of int8 codes is one
//     16-byte chunk of the row), convert them in registers and feed the
//     RS product m64nMTk16 with x as the K-major B operand. Conversion,
//     exact and without a cvt per code: bias a code by 128 (xor 0x80),
//     byte-permute it into the low mantissa byte of a magic number, then
//     one subtract. bf16: fp32 bits 0x4B000000 | (q + 128) are 2^23 + q +
//     128; minus 2^23 + 128 is q; two such fp32 values pack to bf16x2
//     exactly (integers of at most 8 bits). fp16: half bits 0x6400 | (q +
//     128) are 1024 + q + 128; one half2 subtract of 1152 gives two codes.
//   - Decode M (the "stream" variant, M <= 32, NWG = 1, MT the least of
//     8, 16 and 32 that holds M): a tick's few output tiles (16 at N =
//     1024) cannot fill 132 SMs, so K is split into S parts by a host plan
//     (ops/quant_matmul.py, split_plan: S depends on M, N and K only) and
//     each part writes its unscaled fp32 partial to a workspace; a second
//     kernel adds the S partials in the fixed order s = 0 .. S - 1,
//     applies scale[n] once and casts. No atomics: two launches give the
//     same bits. The plan asks for about one block an SM (two or more
//     fit, each with kStages 8 KB weight boxes in flight): covering the
//     SMs twice measured slower at three of the four split shapes, the
//     second kernel's few microseconds outweighing the extra overlap.
//   - Prefill M (the "gemm" variant, M > 32, NWG = 2, MT = 128): blocks
//     of 128 channels x 128 tokens, the token tiles of one weight tile next to
//     each other in launch order (blockIdx.x), so the weight is read from
//     device memory about once and x stays in L2; split-K only while the
//     tiles do not fill the SMs once, with the same fixed-order sum.
//   The variants cross over between M = 32 and 48 (measured, PERF.md).
//   Registers (at most 227 a thread at 288 threads) hold the 64
//   accumulators and 32 A registers of the gemm variant without
//   setmaxnreg, so the producer is one warp, not a warpgroup. Left for
//   later: overlapping one k-tile's conversion with the previous tile's
//   products inside a warpgroup, staged 16-byte stores of the output, a
//   persistent grid.
//
// The fp32 kernels, for fp32 x with K % 16 == 0 (every int8 Linear after
// layer 0's q, k and v since C25). The reference dots in fp32 and the
// port holds them to 1e-5 of the output's largest magnitude (ROADMAP C20),
// so no tensor cores and no TF32: products and sums are scalar fp32 FMAs
// (67 TFLOP/s on an H100), the codes converted exactly by the same
// magic-number trick in fp32 (0x4B000000 | (q + 128) is 2^23 + q + 128;
// minus 2^23 + 128 is q). At a decode tick (M = 8) the int8 weight read at
// 3.35 TB/s and the FMAs at 67 TFLOP/s bound it about equally; at a
// 256-token tick the FMAs bound it. Every sum runs in an order fixed by
// (M, N, K): two launches give the same bits.
//   - int8_matmul_fp32_stream_kernel ("fp32_stream", M <= the wrapper's
//     FP32_STREAM_MAX_M, 64: the two cross over between M = 64 and 80 on
//     an H100): a split-K weight stream. A block owns 128 output channels,
//     MT = 8 G tokens (G = 1, 2, 4, 8) and one K part of the host plan
//     (ops/quant_matmul.py, split_plan: the parts that fit one wave of one
//     block an SM, more only where the part's x slice would not fit shared
//     memory; fewer, larger blocks measured faster than a second, partial
//     wave). One producer warp keeps kFStages weight boxes (128 rows x 128
//     codes, 128-byte swizzled, 16 KB) in flight with TMA and mbarriers;
//     the kFWarps = 8 consumer warps first stage the part's x slice (MT x
//     K_part fp32) with cp.async, zero past M and K. Consumer warp w takes
//     token group g = w % G and k-lane l = w / G of L = 8 / G: the part's
//     16-code chunks q (8 a box) with q % L == l. Lane t owns channels t +
//     32 c (c < 4) x the group's 8 tokens, 32 accumulators; it reads its
//     rows' 16-byte chunks (the swizzle puts chunk kk of row r at kk ^ (r
//     % 8): conflict-free), converts four codes at a time and runs one
//     fmaf chain per output, k ascending; x is read as warp-wide
//     broadcasts of float4. The L chains of an output are added in the
//     order l = 0 .. L - 1 through shared memory; S == 1 writes scale[n]
//     times the sum, else the part's unscaled fp32 partial, added by
//     int8_matmul_reduce_kernel<float> in the order s = 0 .. S - 1 with
//     the scale once. Sixteen consumer warps (more latency hidden, L up to
//     16) measured no faster.
//   - int8_matmul_fp32_gemm_kernel ("fp32_gemm", larger M): a
//     register-tiled SGEMM. A block of 256 threads owns 128 channels x 128
//     tokens; each thread 8 x 8 outputs (channels and tokens tx * 4 + {0..3,
//     64..67}), one fmaf chain per output, k ascending. K steps of 32:
//     cp.async brings the raw int8 weight tile (128 x 32 codes) and x tile
//     (128 x 32 fp32), chunks XOR-swizzled, into a ring of kGStages; each
//     step converts its stage once (every code once a block) and transposes
//     both into [k][n] and [k][m] fp32 buffers that the inner loop reads as
//     float4 (four LDS.128 a 64 FMAs). Two blocks fit an SM (at most 128
//     registers a thread, 94,208 bytes of shared memory); split-K only
//     while the tiles do not fill those 264 slots once, with the same
//     fixed-order reduce.
//
// int8_matmul_kernel, the simple kernel that was right first: any K % 16
// != 0, in every dtype. A block of 256
// threads owns a BM x 64 output tile (BM = 16 for M <= 16, else 64) and
// walks K in 64-wide steps: it stages the x tile as fp32 (rows padded to
// 65 floats) and the int8 weight tile as fp32, transposed to [k][n] (rows
// padded to 68 floats, 16-byte aligned for float4 reads), in shared
// memory; each thread then accumulates BM / 16 rows x 4 columns with
// scalar FMAs, k ascending. Edges in M, N and K are masked (zero fill).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64, kBK = 64;
constexpr int kXPad = kBK + 1;   // x tile row stride: conflict-free stores
constexpr int kWPad = kBN + 4;   // w tile row stride: float4-aligned reads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Grid (ceil(N / 64), ceil(M / BM)). Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty * TM .. ty * TM + TM - 1 and columns tx * 4 .. tx * 4 + 3.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out, int M,
                   int N, int K) {
  constexpr int TM = BM / 16;
  __shared__ float xs[BM * kXPad];
  __shared__ __align__(16) float ws[kBK * kWPad];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const bool vec_w = (K % 16) == 0;   // 16-byte rows of the weight tile

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int m = m0 + r, k = k0 + c;
      xs[r * kXPad + c] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    if (vec_w) {
      // 64 rows of 64 codes: thread tid loads 16 codes of row tid / 4
      const int n = tid / 4, c = (tid % 4) * 16;
      int4 raw = make_int4(0, 0, 0, 0);
      if (n0 + n < N && k0 + c < K)
        raw = *reinterpret_cast<const int4*>(w + (size_t)(n0 + n) * K + k0 + c);
      const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[(c + e) * kWPad + n] = (float)codes[e];
    } else {
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int n = i / kBK, c = i - n * kBK;
        ws[c * kWPad + n] = (n0 + n < N && k0 + c < K)
                                ? (float)w[(size_t)(n0 + n) * K + k0 + c]
                                : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k * kWPad + tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xv = xs[(ty * TM + i) * kXPad + k];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m < M) out[(size_t)m * N + n] = from_f32<T>(acc[i][j] * s);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  const unsigned nb = (unsigned)((N + kBN - 1) / kBN);
  if (M <= 16) {
    int8_matmul_kernel<T, 16><<<dim3(nb, (M + 15) / 16), kThreads, 0, stream>>>(
        (const T*)x, w, scale, (T*)out, M, N, K);
  } else {
    int8_matmul_kernel<T, 64><<<dim3(nb, (M + 63) / 64), kThreads, 0, stream>>>(
        (const T*)x, w, scale, (T*)out, M, N, K);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------- tensor-core kernel

constexpr int kTK = 128;       // codes per k-tile: one 128-byte box row
constexpr int kStages = 4;     // depth of the ring

// Shared memory of one block, in bytes from a 1024-aligned base: kStages
// stages of [the weight box (64 NWG rows x 128 codes), x's two 64-column
// boxes of MT rows], then the full and empty barriers. Every box starts on
// a 1024-byte boundary.
template <int MT, int NWG>
struct MmSmem {
  static constexpr int kW = NWG * 64 * kTK;
  static constexpr int kXBox = MT * 128;
  static constexpr int kStage = kW + 2 * kXBox;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + slack
};

// Two int8 codes of the 32-bit word `u` (already xor 0x80808080, so each
// byte is code + 128), bytes `i` and `i + 1`, as two exact values of T in
// one register, byte i in the low half.
template <typename T> struct Codes;
template <> struct Codes<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pair(uint32_t u, uint32_t i) {
    // fp32 bits 0x4B0000bb = 2^23 + bb; minus 2^23 + 128 is the code
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
                     8388736.0f;
    const float hi =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (i + 1))) -
        8388736.0f;
    return Wgmma<__nv_bfloat16>::pack(lo, hi);
  }
};
template <> struct Codes<__half> {
  static __device__ __forceinline__ uint32_t pair(uint32_t u, uint32_t i) {
    // half bits 0x64bb = 1024 + bb, two at once; minus 1152 is the code
    const uint32_t h = __byte_perm(u, 0x64646464u, 0x4040u | i | ((i + 1) << 8));
    const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                              __half2half2(__ushort_as_half(0x6480)));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// Grid (ceil(M / MT), ceil(N / (64 NWG)), S): block (i, j, s) owns tokens
// MT i .., channels 64 NWG j .. and k-tiles tpp s .. min(tpp (s + 1),
// k_tiles) - 1 (every part nonempty, by the plan). With S == 1 it writes
// out (scaled, cast); otherwise its unscaled fp32 partial to part[s].
template <typename T, int MT, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_x,
                         const float* __restrict__ scale, T* __restrict__ out,
                         float* __restrict__ part, int M, int N, int k_tiles,
                         int tpp) {
  using L = MmSmem<MT, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * (NWG * 64);
  const int t0 = blockIdx.z * tpp;
  const int nt = min(k_tiles, t0 + tpp) - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == NWG * 4) {
    // producer warp: one thread issues every copy
    if (lane == 0) {
      for (int j = 0; j < nt; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
        uint8_t* stage = smem + st * L::kStage;
        const int k = (t0 + j) * kTK;
        mbar_expect_tx(full + st, L::kStage);
        tma_load_2d(stage, &tm_w, full + st, k, n0);
        tma_load_2d(stage + L::kW, &tm_x, full + st, k, m0);
        tma_load_2d(stage + L::kW + L::kXBox, &tm_x, full + st, k + 64, m0);
      }
    }
    return;
  }

  // consumers: this thread's A rows are ra and ra + 8 of the box; its
  // codes of a k16 step are bytes 2 q, 2 q + 1 (word q / 2, half q % 2)
  // and the same 8 bytes on of the step's 16-byte chunk, which the
  // swizzle puts at chunk kk ^ (ra % 8)
  const int ra = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int sw = (lane / 4) & 7;
  const uint32_t hsel = (lane & 1) * 2;
  const int word = 4 * ((lane & 3) >> 1);
  float acc[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;
  uint32_t a[32];

  for (int j = 0; j < nt; ++j) {
    const int st = j % kStages;
    mbar_wait(full + st, (j / kStages) & 1);
    const uint8_t* stage = smem + st * L::kStage;
    const uint8_t* row_a = stage + ra * 128 + word;
    const uint8_t* row_b = row_a + 8 * 128;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = (kk ^ sw) * 16;
      const uint32_t la = *reinterpret_cast<const uint32_t*>(row_a + c) ^ 0x80808080u;
      const uint32_t lb = *reinterpret_cast<const uint32_t*>(row_b + c) ^ 0x80808080u;
      const uint32_t ha = *reinterpret_cast<const uint32_t*>(row_a + c + 8) ^ 0x80808080u;
      const uint32_t hb = *reinterpret_cast<const uint32_t*>(row_b + c + 8) ^ 0x80808080u;
      a[4 * kk] = Codes<T>::pair(la, hsel);
      a[4 * kk + 1] = Codes<T>::pair(lb, hsel);
      a[4 * kk + 2] = Codes<T>::pair(ha, hsel);
      a[4 * kk + 3] = Codes<T>::pair(hb, hsel);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      WgmmaRsK<T, MT>::mma(
          acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
          smem_desc(stage + L::kW + (kk / 4) * L::kXBox + (kk % 4) * 32, 16,
                    1024),
          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with it
  }

  // accumulator i: channel row ra + 8 ((i / 2) % 2), token 8 (i / 4) +
  // 2 (lane % 4) + i % 2
  const int na = n0 + ra, nb = na + 8;
  const int mq = m0 + 2 * (lane & 3);
  if (part == nullptr) {
    const float sa = na < N ? scale[na] : 0.f, sb = nb < N ? scale[nb] : 0.f;
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int m = mq + 8 * (i / 4) + (i & 1);
      const int n = (i & 2) ? nb : na;
      if (m < M && n < N)
        out[(size_t)m * N + n] = from_f32<T>(acc[i] * ((i & 2) ? sb : sa));
    }
  } else {
    float* p = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int m = mq + 8 * (i / 4) + (i & 1);
      const int n = (i & 2) ? nb : na;
      if (m < M && n < N) p[(size_t)m * N + n] = acc[i];
    }
  }
}

// out[m, n] = cast(scale[n] (part[0] + part[1] + ... + part[S - 1])[m, n]),
// the partials added in that fixed order.
template <typename T>
__global__ void __launch_bounds__(256)
int8_matmul_reduce_kernel(const float* __restrict__ part,
                          const float* __restrict__ scale, T* __restrict__ out,
                          long long total, int N, int S) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float acc = part[i];
  for (int s = 1; s < S; ++s) acc += part[(long long)s * total + i];
  out[i] = from_f32<T>(acc * scale[i % N]);
}

// Raises a kernel's dynamic shared memory limit to `bytes`, once per
// device (bit d of *done: done on device d).
template <typename F>
cudaError_t raise_smem(F kernel, int bytes, int dev, unsigned long long* done) {
  if (*done >> dev & 1) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done |= 1ull << dev;
  return err;
}

// The second launch of a split K: the partials added in order, scaled,
// cast.
template <typename T>
cudaError_t launch_reduce(const float* part, const float* scale, T* out,
                          int M, int N, int splits, cudaStream_t stream) {
  const long long total = (long long)M * N;
  int8_matmul_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                                 stream>>>(part, scale, out, total, N, splits);
  return cudaGetLastError();
}

// Host work per call: two tensor maps and one or two launches; the
// shared-memory limit is raised once per device and instantiation.
template <typename T, int MT, int NWG>
cudaError_t launch_tc(const CUtensorMap& mw, const CUtensorMap& mx,
                      const float* scale, T* out, float* part, int M, int N,
                      int k_tiles, int splits, int tpp, int dev,
                      cudaStream_t stream) {
  constexpr int bytes = MmSmem<MT, NWG>::kBytes;
  static unsigned long long raised = 0;
  cudaError_t err =
      raise_smem(int8_matmul_wgmma_kernel<T, MT, NWG>, bytes, dev, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + MT - 1) / MT, (N + NWG * 64 - 1) / (NWG * 64), splits);
  int8_matmul_wgmma_kernel<T, MT, NWG><<<grid, NWG * 128 + 32, bytes, stream>>>(
      mw, mx, scale, out, splits > 1 ? part : nullptr, M, N, k_tiles, tpp);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce(part, scale, out, M, N, splits, stream);
}

template <typename T>
cudaError_t launch_tc_mt(const CUtensorMap& mw, const CUtensorMap& mx,
                         const float* scale, void* out, float* part, int M,
                         int N, int k_tiles, int mt, int nwg, int splits,
                         int tpp, int dev, cudaStream_t s) {
  T* o = (T*)out;
  if (nwg == 1) {
    switch (mt) {
      case 8: return launch_tc<T, 8, 1>(mw, mx, scale, o, part, M, N, k_tiles, splits, tpp, dev, s);
      case 16: return launch_tc<T, 16, 1>(mw, mx, scale, o, part, M, N, k_tiles, splits, tpp, dev, s);
      case 32: return launch_tc<T, 32, 1>(mw, mx, scale, o, part, M, N, k_tiles, splits, tpp, dev, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (nwg == 2 && mt == 128)
    return launch_tc<T, 128, 2>(mw, mx, scale, o, part, M, N, k_tiles, splits, tpp, dev, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------- fp32 kernels

constexpr int kFChan = 128;             // output channels a block
constexpr int kFStages = 4;             // stream: depth of the weight ring
constexpr int kFBox = kFChan * kTK;     // stream: one weight box, bytes
constexpr int kFConsumers = 256;        // stream: consumer threads
constexpr int kFWarps = kFConsumers / 32;
constexpr int kSmemLimit = 232448;      // opt-in shared memory of a block

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
// (src-size 0: nothing is read). Completes with the commit group.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Barrier 1 over the `threads` consumer threads (the producer warp has
// returned).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// Code i (byte i) of the word `u`, already xor 0x80808080, as an exact
// fp32: bits 0x4B0000bb are 2^23 + bb, minus 2^23 + 128 is the code.
__device__ __forceinline__ float code_f32(uint32_t u, uint32_t i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) -
         8388736.0f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Dynamic shared memory of a stream block: the weight ring, the x slice
// (MT rows of tpp k-tiles), the full and empty barriers, 1 KB of alignment
// slack.
__host__ __device__ constexpr int stream_smem_bytes(int mt, int tpp) {
  return kFStages * kFBox + mt * tpp * kTK * 4 + 2 * kFStages * 8 + 1024;
}

// Grid (ceil(M / MT), ceil(N / 128), S): block (i, j, s) owns tokens MT i
// .., channels 128 j .. and k-tiles tpp s .. min(tpp (s + 1), k_tiles) -
// 1. With part == nullptr (S == 1) it writes out, scaled; otherwise its
// unscaled partial to part[s].
template <int G>
__global__ void __launch_bounds__(kFConsumers + 32, 1)
int8_matmul_fp32_stream_kernel(const __grid_constant__ CUtensorMap tm_w,
                               const float* __restrict__ x,
                               const float* __restrict__ scale,
                               float* __restrict__ out,
                               float* __restrict__ part, int M, int N, int K,
                               int k_tiles, int tpp) {
  constexpr int MT = 8 * G, L = kFWarps / G;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* xs = reinterpret_cast<float*>(smem + kFStages * kFBox);
  const int kp = tpp * kTK;                       // x slice row, floats
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + MT * kp);
  uint64_t* empty = full + kFStages;

  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kFChan;
  const int t0 = blockIdx.z * tpp;
  const int nt = min(k_tiles, t0 + tpp) - t0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFWarps);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kFWarps) {
    if (lane == 0) {
      for (int j = 0; j < nt; ++j) {
        const int st = j % kFStages;
        mbar_wait(empty + st, ((j / kFStages) & 1) ^ 1);
        mbar_expect_tx(full + st, kFBox);
        tma_load_2d(smem + st * kFBox, &tm_w, full + st, (t0 + j) * kTK, n0);
      }
    }
    return;
  }

  // the part's x slice, zero past M and K (the producer is already
  // filling the ring)
  const int tid = threadIdx.x;
  const int chunks = nt * kTK / 4;               // 16-byte chunks a row
  for (int i = tid; i < MT * chunks; i += kFConsumers) {
    const int r = i / chunks, c = i - r * chunks;
    const int m = m0 + r, k = t0 * kTK + 4 * c;
    const bool ok = m < M && k < K;
    cp_async16_zfill(xs + r * kp + 4 * c, ok ? x + (size_t)m * K + k : x, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  consumer_sync(kFConsumers);

  const int g = warp % G, l = warp / G;
  const int sw = lane & 7;                       // row % 8 of every row
  const float* xg = xs + g * 8 * kp;
  float acc[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[c][t] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int st = j % kFStages;
    mbar_wait(full + st, (j / kFStages) & 1);
    const uint8_t* box = smem + st * kFBox + lane * kTK;
    // this warp's chunks of the box: the part's 16-code chunks j 8 + kk
    // with (j 8 + kk) % L == l
    const int first = ((l - 8 * j) % L + L) % L;
#pragma unroll
    for (int q = 0; q < (8 + L - 1) / L; ++q) {
      const int kk = first + q * L;
      if (kk >= 8) break;
      uint4 raw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        raw[c] = *reinterpret_cast<const uint4*>(box + c * 32 * kTK +
                                                 ((kk ^ sw) * 16));
      const float* xk = xg + j * kTK + kk * 16;
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {           // codes 4 wd .. 4 wd + 3
        float wf[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t u = word_of(raw[c], wd) ^ 0x80808080u;
#pragma unroll
          for (int e = 0; e < 4; ++e) wf[c][e] = code_f32(u, e);
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float4 xv = *reinterpret_cast<const float4*>(xk + t * kp + 4 * wd);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[c][t] = fmaf(xv.x, wf[c][0], acc[c][t]);
            acc[c][t] = fmaf(xv.y, wf[c][1], acc[c][t]);
            acc[c][t] = fmaf(xv.z, wf[c][2], acc[c][t]);
            acc[c][t] = fmaf(xv.w, wf[c][3], acc[c][t]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);      // this warp is done with it
  }

  // the L chains of each output, added in the order l = 0 .. L - 1
  // through the ring (every box has landed and been read: 32 KB of it)
  consumer_sync(kFConsumers);
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int t = 0; t < 8; ++t)
      red[((l * G + g) * 8 + t) * kFChan + lane + 32 * c] = acc[c][t];
  consumer_sync(kFConsumers);
  for (int i = tid; i < MT * kFChan; i += kFConsumers) {
    const int ch = i % kFChan, tok = i / kFChan;
    const int m = m0 + tok, n = n0 + ch;
    if (m >= M || n >= N) continue;
    const float* r = red + tok * kFChan + ch;   // l = 0: (g 8 + t) = tok
    float s = r[0];
#pragma unroll
    for (int l2 = 1; l2 < L; ++l2) s += r[l2 * G * 8 * kFChan];
    if (part == nullptr)
      out[(size_t)m * N + n] = s * scale[n];
    else
      part[((size_t)blockIdx.z * M + m) * N + n] = s;
  }
}

constexpr int kGTok = 128;              // gemm: tokens a block
constexpr int kGK = 32;                 // gemm: codes a step
constexpr int kGStages = 3;             // gemm: depth of the raw ring
constexpr int kGRawW = kFChan * kGK;    // raw weight tile, bytes
constexpr int kGRaw = kGRawW + kGTok * kGK * 4;   // + raw x tile
constexpr int kGBytes = kGStages * kGRaw + 2 * kGK * 128 * 4;

// Grid (ceil(M / 128), ceil(N / 128), S), as the stream's; the part's K
// range is [tpp s K_TILE, min(K, tpp (s + 1) K_TILE)).
__global__ void __launch_bounds__(256, 2)
int8_matmul_fp32_gemm_kernel(const float* __restrict__ x,
                             const int8_t* __restrict__ w,
                             const float* __restrict__ scale,
                             float* __restrict__ out,
                             float* __restrict__ part, int M, int N, int K,
                             int tpp) {
  extern __shared__ __align__(16) uint8_t gsm[];
  float* wt = reinterpret_cast<float*>(gsm + kGStages * kGRaw);  // [k][n]
  float* xt = wt + kGK * 128;                                    // [k][m]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kGTok, n0 = blockIdx.y * kFChan;
  const int kb = blockIdx.z * tpp * kTK;
  const int ke = min(K, kb + tpp * kTK);
  const int steps = (ke - kb + kGK - 1) / kGK;

  // one step's raw tiles into stage st: the weight's 128 rows of 32 codes
  // (chunk h of row r at h ^ ((r / 4) % 2)) and x's 128 rows of 32 floats
  // (chunk c of row r at c ^ (r % 8)), zero past N, M and the part's end
  auto load = [&](int step, int st) {
    uint8_t* raw = gsm + st * kGRaw;
    const int k0 = kb + step * kGK;
    {
      const int r = tid >> 1, h = tid & 1;
      const int n = n0 + r, k = k0 + 16 * h;
      const bool ok = n < N && k < ke;
      cp_async16_zfill(raw + r * 32 + 16 * (h ^ ((r >> 2) & 1)),
                       ok ? w + (size_t)n * K + k : w, ok);
    }
    float* rx = reinterpret_cast<float*>(raw + kGRawW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + 256 * i, r = id >> 3, c = id & 7;
      const int m = m0 + r, k = k0 + 4 * c;
      const bool ok = m < M && k < ke;
      cp_async16_zfill(rx + r * 32 + 4 * (c ^ (r & 7)),
                       ok ? x + (size_t)m * K + k : x, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];                               // [token][channel]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();          // the stage has landed; the last step is read
    {
      // convert and transpose: thread (r, h) = (tid % 128, tid / 128)
      // takes codes and x values 16 h .. 16 h + 15 of row r
      const uint8_t* raw = gsm + (step % kGStages) * kGRaw;
      const int r = tid & 127, h = tid >> 7;
      const uint4 cw = *reinterpret_cast<const uint4*>(
          raw + r * 32 + 16 * (h ^ ((r >> 2) & 1)));
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const uint32_t u = word_of(cw, wd) ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wt[(16 * h + 4 * wd + e) * 128 + r] = code_f32(u, e);
      }
      const float* rx = reinterpret_cast<const float*>(raw + kGRawW);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = 4 * h + c;
        const float4 v =
            *reinterpret_cast<const float4*>(rx + r * 32 + 4 * (cc ^ (r & 7)));
        xt[(4 * cc + 0) * 128 + r] = v.x;
        xt[(4 * cc + 1) * 128 + r] = v.y;
        xt[(4 * cc + 2) * 128 + r] = v.z;
        xt[(4 * cc + 3) * 128 + r] = v.w;
      }
    }
    {
      // refill the stage converted at the previous step
      const int nx = step + kGStages - 1;
      if (nx < steps) load(nx, nx % kGStages);
      cp_async_commit();
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + k * 128 + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xt + k * 128 + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(wt + k * 128 + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wt + k * 128 + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const bool vec = (N % 4) == 0;
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int n = n0 + 64 * jh + tx * 4;
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = n + j < N ? scale[n + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = part == nullptr ? acc[i][4 * jh + j] * sc[j] : acc[i][4 * jh + j];
      float* dst = part == nullptr
                       ? out + (size_t)m * N + n
                       : part + ((size_t)blockIdx.z * M + m) * N + n;
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) dst[j] = v[j];
      }
    }
  }
}

template <int G>
cudaError_t launch_fp32_stream(const CUtensorMap& mw, const float* x,
                               const float* scale, float* out, float* part,
                               int M, int N, int K, int k_tiles, int splits,
                               int tpp, int dev, cudaStream_t stream) {
  static unsigned long long raised = 0;
  const int bytes = stream_smem_bytes(8 * G, tpp);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = raise_smem(int8_matmul_fp32_stream_kernel<G>, kSmemLimit,
                               dev, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + 8 * G - 1) / (8 * G), (N + kFChan - 1) / kFChan, splits);
  int8_matmul_fp32_stream_kernel<G><<<grid, kFConsumers + 32, bytes, stream>>>(
      mw, x, scale, out, splits > 1 ? part : nullptr, M, N, K, k_tiles, tpp);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce(part, scale, out, M, N, splits, stream);
}

cudaError_t launch_fp32_gemm(const float* x, const int8_t* w,
                             const float* scale, float* out, float* part,
                             int M, int N, int K, int splits, int tpp,
                             int dev, cudaStream_t stream) {
  static unsigned long long raised = 0;
  cudaError_t err =
      raise_smem(int8_matmul_fp32_gemm_kernel, kGBytes, dev, &raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGTok - 1) / kGTok, (N + kFChan - 1) / kFChan, splits);
  int8_matmul_fp32_gemm_kernel<<<grid, 256, kGBytes, stream>>>(
      x, w, scale, out, splits > 1 ? part : nullptr, M, N, K, tpp);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce(part, scale, out, M, N, splits, stream);
}

}  // namespace

// Plain C interface, bound with ctypes. dtype (of x and out): 0 float32,
// 1 bfloat16, 2 float16. x [M, K], w int8 [N, K], scale float32 [N], out
// [M, N], all contiguous device tensors (the Python wrapper checks them,
// w's 16-byte alignment included: the 16-byte weight loads need it when K
// % 16 == 0). Returns the cudaError_t of the launch.
extern "C" {

int ptt_int8_matmul(int dtype, const void* x, const void* w,
                    const float* scale, void* out, int M, int N, int K,
                    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  switch (dtype) {
    case 0: return (int)launch<float>(x, wq, scale, out, M, N, K, s);
    case 1: return (int)launch<__nv_bfloat16>(x, wq, scale, out, M, N, K, s);
    case 2: return (int)launch<__half>(x, wq, scale, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core kernels: dtype 1 (bf16) or 2 (fp16), K % 16 == 0, x and
// w 16-byte aligned (the TMA's rule). (mt, nwg) is (8, 16 or 32, 1)
// or (128, 2); the K tiles of 128 codes (k_tiles = ceil(K / 128)) go in
// `splits` parts of `tpp` tiles, every part nonempty. With splits > 1,
// part is an fp32 workspace of splits x M x N. Returns
// cudaErrorInvalidValue for anything else.
int ptt_int8_matmul_wgmma(int dtype, const void* x, const void* w,
                          const float* scale, void* out, float* part, int M,
                          int N, int K, int mt, int nwg, int splits, int tpp,
                          void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int k_tiles = (K + kTK - 1) / kTK;
  if ((dtype != 1 && dtype != 2) || K <= 0 || K % 16 != 0 || splits < 1 ||
      tpp < 1 || (long long)(splits - 1) * tpp >= k_tiles ||
      (long long)splits * tpp < k_tiles || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  CUtensorMap mw, mx;
  err = encode_2d_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, K,
                      nwg * 64);
  if (err == cudaSuccess)
    err = encode_2d_map(&mx, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                        2, x, K, M, 2LL * K, mt);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? (int)launch_tc_mt<__nv_bfloat16>(mw, mx, scale, out, part, M, N,
                                                k_tiles, mt, nwg, splits, tpp,
                                                dev, s)
             : (int)launch_tc_mt<__half>(mw, mx, scale, out, part, M, N,
                                         k_tiles, mt, nwg, splits, tpp, dev,
                                         s);
}

// The fp32 kernels: x and out float32, K % 16 == 0, x and w 16-byte
// aligned. variant 0 is the stream (mt = 8, 16, 32 or 64 tokens a
// block), 1 the GEMM (mt = 128); K's k_tiles = ceil(K / 128) tiles of
// 128 codes go in `splits` parts of `tpp` tiles, every part nonempty;
// with splits > 1, part is an fp32 workspace of splits x M x N. Returns
// cudaErrorInvalidValue for anything else (a stream part whose x slice
// does not fit shared memory included).
int ptt_int8_matmul_fp32(int variant, const float* x, const void* w,
                         const float* scale, float* out, float* part, int M,
                         int N, int K, int mt, int splits, int tpp,
                         void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int k_tiles = (K + kTK - 1) / kTK;
  if (K <= 0 || K % 16 != 0 || splits < 1 || tpp < 1 ||
      (long long)(splits - 1) * tpp >= k_tiles ||
      (long long)splits * tpp < k_tiles || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  if (variant == 1) {
    if (mt != kGTok) return (int)cudaErrorInvalidValue;
    return (int)launch_fp32_gemm(x, wq, scale, out, part, M, N, K, splits,
                                 tpp, dev, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap mw;
  err = encode_2d_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, K,
                      kFChan);
  if (err != cudaSuccess) return (int)err;
  switch (mt) {
    case 8: return (int)launch_fp32_stream<1>(mw, x, scale, out, part, M, N, K, k_tiles, splits, tpp, dev, s);
    case 16: return (int)launch_fp32_stream<2>(mw, x, scale, out, part, M, N, K, k_tiles, splits, tpp, dev, s);
    case 32: return (int)launch_fp32_stream<4>(mw, x, scale, out, part, M, N, K, k_tiles, splits, tpp, dev, s);
    case 64: return (int)launch_fp32_stream<8>(mw, x, scale, out, part, M, N, K, k_tiles, splits, tpp, dev, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one fp32 kernel block: the stream's at (mt,
// tpp), or the GEMM's (variant 1).
int ptt_int8_matmul_fp32_smem(int variant, int mt, int tpp) {
  return variant == 1 ? kGBytes : stream_smem_bytes(mt, tpp);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
