// Weight-only int8 matmul for Hopper (sm_90a): out[M, N] = (x[M, K] @
// w[N, K]^T) * scale[N], in x's type.
//
// Replaces the Pallas TPU kernel _kernel of
// paddle_tpu/ops/pallas/quant_matmul.py (:65, int8_matmul :83, pallas_call
// :112; grid (m, n, k), k sequential). Like it, every product of the whole
// K reduction is exact and summed in fp32, the sum is multiplied by
// scale[n] once at the end and cast to x's type once. No int8 x int8
// product and no int32 accumulator (the reference dots in fp32, see
// ROADMAP C5). Two kernels, chosen by the wrapper (ops/quant_matmul.py,
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
// int8_matmul_kernel, the simple kernel that was right first: fp32 x (the
// reference's fp32 parity at 1e-5), and any K % 16 != 0. A block of 256
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

// Host work per call: two tensor maps and one or two launches; the
// shared-memory limit is raised once per device and instantiation.
template <typename T, int MT, int NWG>
cudaError_t launch_tc(const CUtensorMap& mw, const CUtensorMap& mx,
                      const float* scale, T* out, float* part, int M, int N,
                      int k_tiles, int splits, int tpp, int dev,
                      cudaStream_t stream) {
  constexpr int bytes = MmSmem<MT, NWG>::kBytes;
  static unsigned long long raised = 0;  // bit d: done on device d
  if (!(raised >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_wgmma_kernel<T, MT, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  const dim3 grid((M + MT - 1) / MT, (N + NWG * 64 - 1) / (NWG * 64), splits);
  int8_matmul_wgmma_kernel<T, MT, NWG><<<grid, NWG * 128 + 32, bytes, stream>>>(
      mw, mx, scale, out, splits > 1 ? part : nullptr, M, N, k_tiles, tpp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  int8_matmul_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, scale, out, total, N, splits);
  return cudaGetLastError();
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

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
