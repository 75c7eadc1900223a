// Weight-only int8 matmul for Hopper (sm_90a): out[M, N] = (x[M, K] @
// w[N, K]^T) * scale[N], in x's type.
//
// Replaces the Pallas TPU kernel _kernel of
// paddle_tpu/ops/pallas/quant_matmul.py (:65, int8_matmul :83, pallas_call
// :112; grid (m, n, k), k sequential). Like it, it converts both operands
// to fp32, accumulates every product of the whole K reduction in fp32,
// multiplies the accumulator by scale[n] once at the end and casts to x's
// type. No int8 x int8 product and no int32 accumulator (the reference
// dots in fp32, see ROADMAP C5).
//
// What bounds it on an H100: at a decode step (M = 8) each weight byte is
// used for 2 M = 16 flops, far under the ~295 flops/byte where tensor cores
// take over, so the floor is the int8 weight read once at 3.35 TB/s (half
// the bytes of bf16). At M = 256 (a ragged tick) it does 512 flops a weight
// byte; with scalar fp32 FMAs (67 TFLOP/s peak outside the tensor cores)
// the arithmetic, not the memory, is then the limit.
//
// The design is the simple one that is right first. A block of 256 threads
// owns a BM x 64 output tile (BM = 16 for M <= 16, else 64) and walks K in
// 64-wide steps: it stages the x tile as fp32 (rows padded to 65 floats)
// and the int8 weight tile as fp32, transposed to [k][n] (rows padded to 68
// floats, 16-byte aligned for float4 reads), in shared memory; each thread
// then accumulates BM / 16 rows x 4 columns with scalar FMAs, k ascending.
// Edges in M, N and K are masked (zero fill), so no padding is needed.
// Left for later: tensor cores (int8 codes in [-127, 127] are exact in
// bf16, so a bf16 wgmma with fp32 accumulation reproduces the products
// exactly for a bf16 x and differs only in summation order), cp.async or
// TMA double buffering, and a split-K pass so a decode step's few output
// tiles fill all 132 SMs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

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

}  // namespace

// Plain C interface, bound with ctypes. dtype (of x and out): 0 float32,
// 1 bfloat16, 2 float16. x [M, K], w int8 [N, K], scale float32 [N], out
// [M, N], all contiguous device tensors (the Python wrapper checks them;
// the 16-byte weight loads need K % 16 == 0 and a 16-byte aligned w, which
// torch's allocations give). Returns the cudaError_t of the launch.
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

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
