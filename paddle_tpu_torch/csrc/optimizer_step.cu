// The fused optimizer step for Hopper (sm_90a): one launch updates a whole
// group of parameters with Adam or AdamW (K-A, adam_step_kernel), and two
// launches take the global norm's fp32 sum of squares over a list of grads
// (K-B, sumsq_partial_kernel then sumsq_finish_kernel).
//
// Neither has a Pallas counterpart. The reference's fused step
// (paddle_tpu/optimizer/fused.py:65 FusedStepEngine) is one XLA program
// per parameter group over Adam._apply (paddle_tpu/optimizer/__init__.py
// :286-297), and its global-norm clip (paddle_tpu/nn/clip_grad.py:52-81)
// a jnp sum of per-tensor sums. Here the parity target is the port's own
// eager loop on the card (paddle_tpu_torch/optimizer/__init__.py, Adam
// _apply and _masterized_apply, after ClipGradByGlobalNorm), bit for bit.
// So K-A spells every rounding point with an intrinsic, in the eager
// loop's order, as PyTorch's CUDA kernels round them: a tensor times a
// Python number multiplies by the number cast to fp32; a tensor divided
// by a Python number multiplies by the number's reciprocal, taken in
// double on the host and cast to fp32 (the wrapper passes 1 / (1 - b^t)
// that way: an fp32 reciprocal differed in the last bit of ~0.4 % of the
// master weights at step 7 on the card); a tensor divided by a tensor is
// an IEEE division; sqrt is IEEE. nvcc would contract a * b + c into one
// FMA otherwise.
//
// What bounds both on an H100: bytes. K-A reads g and, for each element,
// the fp32 master (or the fp32 parameter), m and v, and writes them back
// with the bf16 parameter: 28 bytes an element for bf16 with a master, 32
// for fp32, at a few flops an element. K-B reads each grad once. The
// design is the simple one that streams them:
//   - A group's tensors are cut into chunks of `chunk` elements (a
//     multiple of 8); a table on the device holds each tensor's pointers
//     and the prefix sums of its chunk counts, and a block maps a chunk to
//     its tensor by a binary search of those sums. Blocks walk the chunks
//     in a grid-stride loop; a thread takes 8 elements a step by 16-byte
//     loads and stores (the wrapper refuses a tensor that is not 16-byte
//     aligned), and the last partial vector of a tensor element by
//     element.
//   - K-A's table (pointers to p, the master or 0, m and v, the element
//     count and the need-clip flag, then the chunk prefix sums) is built
//     once a group and rebuilt only when a pointer changes; the grads'
//     pointers come anew at every step. The global-norm clip's scale, when
//     given, is read from the device: a clipped grad is g * scale rounded
//     to the grad's type, as the clip's cast back does, so the clip needs
//     no pass and no copy of its own, and the step no host sync.
//   - K-B writes one fp32 partial a chunk (each thread sums its elements'
//     squares in order by fmaf, then a fixed shuffle tree over the block);
//     a second launch of one block adds a tensor's partials (thread j
//     those at j, j + 1024, ... in order, then the same fixed tree) and
//     the tensors' sums in parameter order. No atomics: two runs give the
//     same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // K-A and K-B's first kernel
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;             // elements a thread takes a step
constexpr int kBlocksPerSM = 8;

// K-A's flags
constexpr int kDecoupled = 1;       // AdamW: p * (1 - lr wd) before the update
constexpr int kDecay = 2;           // wd != 0

// K-A's table: one row of kCols int64 a tensor, then the chunk prefix sums
constexpr int kCols = 6;            // p, master, m, v, numel, need_clip

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

// Round to nearest even, as PyTorch's casts from fp32 do.
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// 8 elements at p (16 bytes of a 2-byte type, 32 of fp32), to fp32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = to_f(e[k]);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* in) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kVec; ++k) e[k] = from_f<T>(in[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  }
}

// The tensor of chunk c: the largest i with cs[i] <= c (cs[0] = 0, cs[n]
// the chunk count; an empty tensor's equal sums are skipped).
__device__ __forceinline__ int tensor_of(const long long* cs, int n,
                                         long long c) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cs[mid] <= c) lo = mid; else hi = mid;
  }
  return lo;
}

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd, decay;
  int flags;
};

// One element of Adam._apply, in its order and with its roundings:
//   g = g + wd * p                      (Adam, wd != 0)
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + ((1 - b2) * g) * g
//   mhat = m / (1 - b1^t), vhat = v / (1 - b2^t)   (times the reciprocal)
//   p = p * (1 - lr wd)                 (AdamW, wd != 0)
//   p = p - (mhat * lr) / (sqrt(vhat) + eps)
__device__ __forceinline__ void adam_update(float& p, float g, float& m,
                                            float& v, const AdamArgs& a) {
  if ((a.flags & kDecay) && !(a.flags & kDecoupled))
    g = __fadd_rn(g, __fmul_rn(a.wd, p));
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float mhat = __fmul_rn(m, a.inv_bc1);
  const float vhat = __fmul_rn(v, a.inv_bc2);
  if ((a.flags & kDecay) && (a.flags & kDecoupled)) p = __fmul_rn(p, a.decay);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(mhat, a.lr),
                             __fadd_rn(__fsqrt_rn(vhat), a.eps)));
}

// K-A. T is the parameter's and the grad's type; with a master (bf16,
// fp16) the update runs on the fp32 master and p receives it rounded.
template <typename T>
__global__ void __launch_bounds__(kThreads) adam_step_kernel(
    const long long* __restrict__ tab, const long long* __restrict__ gptr,
    int n, long long chunk, const float* __restrict__ scale_ptr,
    AdamArgs a) {
  const long long* cs = tab + (long long)kCols * n;
  const long long total = cs[n];
  const float scale = scale_ptr ? *scale_ptr : 1.f;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    const int i = tensor_of(cs, n, c);
    const long long* row = tab + (long long)kCols * i;
    T* p = reinterpret_cast<T*>(row[0]);
    float* master = reinterpret_cast<float*>(row[1]);
    float* m = reinterpret_cast<float*>(row[2]);
    float* v = reinterpret_cast<float*>(row[3]);
    const long long numel = row[4];
    const bool clip = scale_ptr != nullptr && row[5] != 0;
    const T* g = reinterpret_cast<const T*>(gptr[i]);
    // the fp32 array the update runs on: the master, or p itself (fp32)
    float* w = master ? master : reinterpret_cast<float*>(p);
    const long long lo = (c - cs[i]) * chunk;
    const long long hi = min(lo + chunk, numel);
    for (long long base = lo + (long long)threadIdx.x * kVec; base < hi;
         base += (long long)kThreads * kVec) {
      if (base + kVec <= hi) {
        float gv[kVec], wv[kVec], mv[kVec], vv[kVec];
        load8(g + base, gv);
        load8(w + base, wv);
        load8(m + base, mv);
        load8(v + base, vv);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float gk =
              clip ? to_f(from_f<T>(__fmul_rn(gv[k], scale))) : gv[k];
          adam_update(wv[k], gk, mv[k], vv[k], a);
        }
        store8(w + base, wv);
        store8(m + base, mv);
        store8(v + base, vv);
        if (master) store8(p + base, wv);
      } else {
        // a tensor's last, partial vector: element by element
        for (long long e = base; e < hi; ++e) {
          float gk = to_f(g[e]), we = w[e], me = m[e], ve = v[e];
          if (clip) gk = to_f(from_f<T>(__fmul_rn(gk, scale)));
          adam_update(we, gk, me, ve, a);
          w[e] = we;
          m[e] = me;
          v[e] = ve;
          if (master) p[e] = from_f<T>(we);
        }
      }
    }
  }
}

// The sum of `x` over the block, in a fixed order (shuffle tree within
// each warp, then the warps' sums by warp 0); the result is valid in
// thread 0. Ends with the block synchronised.
template <int kBlock>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kBlock / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  }
  __syncthreads();
  return x;
}

template <typename T>
__device__ __forceinline__ float sumsq_range(const T* g, long long lo,
                                             long long hi) {
  float acc = 0.f;
  for (long long base = lo + (long long)threadIdx.x * kVec; base < hi;
       base += (long long)kThreads * kVec) {
    float x[kVec];
    const int cnt = (int)min((long long)kVec, hi - base);
    if (cnt == kVec) {
      load8(g + base, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc = __fmaf_rn(x[k], x[k], acc);
    } else {
      for (int k = 0; k < cnt; ++k) {
        const float e = to_f(g[base + k]);
        acc = __fmaf_rn(e, e, acc);
      }
    }
  }
  return acc;
}

// K-B, first launch. tab: rows of (pointer, numel, dtype code), then the
// chunk prefix sums; one fp32 partial a chunk.
__global__ void __launch_bounds__(kThreads) sumsq_partial_kernel(
    const long long* __restrict__ tab, int n, long long chunk,
    float* __restrict__ partial) {
  const long long* cs = tab + 3LL * n;
  const long long total = cs[n];
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    const int i = tensor_of(cs, n, c);
    const long long* row = tab + 3LL * i;
    const long long lo = (c - cs[i]) * chunk;
    const long long hi = min(lo + chunk, row[1]);
    float acc;
    switch ((int)row[2]) {
      case 0:
        acc = sumsq_range(reinterpret_cast<const float*>(row[0]), lo, hi);
        break;
      case 1:
        acc = sumsq_range(reinterpret_cast<const __nv_bfloat16*>(row[0]), lo,
                          hi);
        break;
      default:
        acc = sumsq_range(reinterpret_cast<const __half*>(row[0]), lo, hi);
        break;
    }
    acc = block_sum<kThreads>(acc);
    if (threadIdx.x == 0) partial[c] = acc;
  }
}

// K-B, second launch, one block: each tensor's partials, then the tensors
// in parameter order, into out[0].
__global__ void __launch_bounds__(kFinishThreads) sumsq_finish_kernel(
    const long long* __restrict__ tab, int n,
    const float* __restrict__ partial, float* __restrict__ out) {
  const long long* cs = tab + 3LL * n;
  float total = 0.f;
  for (int i = 0; i < n; ++i) {
    float acc = 0.f;
    for (long long c = cs[i] + threadIdx.x; c < cs[i + 1]; c += kFinishThreads)
      acc = __fadd_rn(acc, partial[c]);
    acc = block_sum<kFinishThreads>(acc);
    if (threadIdx.x == 0) total = i == 0 ? acc : __fadd_rn(total, acc);
  }
  if (threadIdx.x == 0) out[0] = total;
}

cudaError_t grid_for(long long chunks, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * kBlocksPerSM;
  *grid = (int)(chunks < cap ? chunks : cap);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_adam(const long long* tab, const long long* grads, int n,
                        long long chunks, long long chunk, const float* scale,
                        const AdamArgs& a, cudaStream_t s) {
  int grid = 0;
  cudaError_t err = grid_for(chunks, &grid);
  if (err != cudaSuccess) return err;
  adam_step_kernel<T><<<grid, kThreads, 0, s>>>(tab, grads, n, chunk, scale,
                                                 a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K-A over n tensors of type `dtype` (0 fp32, 1 bf16, 2 fp16): tab is the
// group's device table (n rows of p, master, m, v, numel, need_clip, then
// n + 1 chunk prefix sums, `chunks` in all), grads n grad pointers on the
// device. scale: the clip's fp32 scale on the device, or null. Every
// pointer 16-byte aligned, chunk a positive multiple of 8.
int ptt_adam_step(int dtype, const long long* tab, const long long* grads,
                  int n, long long chunks, long long chunk,
                  const float* scale, float lr, float b1, float omb1,
                  float b2, float omb2, float inv_bc1, float inv_bc2,
                  float eps, float wd, float decay, int flags, void* stream) {
  if (n <= 0 || chunks <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk % kVec != 0) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd, decay,
                   flags};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_adam<float>(tab, grads, n, chunks, chunk,
                                           scale, a, s);
    case 1: return (int)launch_adam<__nv_bfloat16>(tab, grads, n, chunks,
                                                   chunk, scale, a, s);
    case 2: return (int)launch_adam<__half>(tab, grads, n, chunks, chunk,
                                            scale, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K-B's first launch: tab holds n rows of (pointer, numel, dtype code) and
// n + 1 chunk prefix sums (`chunks` in all); partial gets one fp32 a chunk.
int ptt_sum_squares_partial(const long long* tab, int n, long long chunks,
                            long long chunk, float* partial, void* stream) {
  if (n <= 0 || chunks <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk % kVec != 0) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_for(chunks, &grid);
  if (err != cudaSuccess) return (int)err;
  sumsq_partial_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tab, n, chunk, partial);
  return (int)cudaGetLastError();
}

// K-B's second launch: out[0] = the sum of the partials, by tensor.
int ptt_sum_squares_finish(const long long* tab, int n, const float* partial,
                           float* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  sumsq_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(
      tab, n, partial, out);
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
