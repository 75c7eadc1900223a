// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends its context through a block table over KV pages.
//
// Replaces two Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py
// (grid (batch, kv_heads, pages_per_seq), the page axis sequential):
//   * _decode_kernel (:55, pallas_call :218), native pages
//       -> paged_decode_kernel<T, T>        (B4, ptt_paged_decode)
//   * _decode_kernel_quant (:97, pallas_call :175), int8 pages with one
//     fp32 scale per (kv head, page, slot) row
//       -> paged_decode_kernel<T, int8_t>   (B5, ptt_paged_decode_q8)
// B5 differs from B4 only where a page is staged: each row's codes are
// dequantised in fp32 (int8 * scale) as they land in shared memory,
// exactly the reference's per-block dequantisation. It computes
// the online-softmax recurrence of attention_common.cuh over the
// sequence's pages in table order, masks positions at or past the
// sequence's context length with -inf (the reference's constant), and
// writes the output in q's type.
//
// What bounds it on an H100: a decode step does ~4 flops per KV byte (one
// dot and one axpy per key for each of the group's query heads), far under
// the ~295 flops/byte where bf16 tensor cores become the limit, so the
// floor is the bytes of the K/V pages the contexts cover, read once at
// 3.35 TB/s. int8 pages halve those bytes against bf16 (plus 4 bytes of
// scale per 128-byte row): B5's floor is (d + 4) / 2d of B4's.
//
// The design is the per-token kernel of ragged_paged_attention.cu with a
// batch row where that kernel has a token: one thread block per (sequence,
// kv head) holds the group of query heads sharing that kv head, stages one
// page at a time in shared memory as fp32 and runs scalar FMAs. The TPU
// grid's sequential page axis becomes a loop inside the block. It stops at
// ceil(ctx / P) pages instead of walking all pages_per_seq: a fully masked
// page leaves m, l and acc unchanged bit for bit (every w = exp(-inf) = 0,
// corr = exp(0) = 1 once the first page, where position 0 < ctx, has made
// m finite). What it leaves on the table is the same as the ragged
// kernels': tensor cores, page prefetch, 16-byte loads, and splitting a
// long context across blocks so a small batch fills all 132 SMs.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;

// Grid (batch, kv_heads); the block's rows are the group of query heads
// sharing kv head h. tables [batch, pages_per_seq], ctx_lens [batch].
// PT is the page type: T (B4) or int8_t (B5).
template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const Pages<PT> pg,
                    T* __restrict__ out,
                    const int* __restrict__ tables,
                    const int* __restrict__ ctx_lens, int H, int KVH, int D,
                    int NP, int P, int pages_per_seq, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KVH, R = G;
  const Tile t = carve(smem, R, P, D);
  const int ctx = ctx_lens[b];
  const int n_pages = min((ctx + P - 1) / P, pages_per_seq);

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    t.q[r * (D + 1) + e] = to_f32(q[((size_t)b * H + h * G + r) * D + e]);
  }
  init_state(t, R, D);
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    load_page(t, pg, h, tables[(size_t)b * pages_per_seq + p], NP, P, D);
    __syncthreads();
    for (int i = threadIdx.x; i < R * P; i += blockDim.x) {
      const int r = i / P, c = i - r * P;
      const float sc = score(t, r, c, D, sm_scale);
      t.s[i] = p * P + c < ctx ? sc : -INFINITY;
    }
    __syncthreads();
    online_step(t, R, P, D);
  }

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    out[((size_t)b * H + h * G + r) * D + e] =
        from_f32<T>(finish(t.acc[i], t.l[r]));
  }
}

template <typename T, typename PT>
cudaError_t launch(const void* q, const Pages<PT>& pg, void* out,
                   const int* tables, const int* ctx, int B, int H, int KVH,
                   int D, int NP, int P, int pages_per_seq, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, P, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, PT><<<dim3(B, KVH), kThreads, smem, stream>>>(
      (const T*)q, pg, (T*)out, tables, ctx, H, KVH, D, NP, P, pages_per_seq,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. dtype (of q and out): 0 float32,
// 1 bfloat16, 2 float16. Every pointer is a device pointer of a
// contiguous tensor; the Python wrapper checks shapes, types and devices.
// Returns the cudaError_t of the launch (0 on success).
extern "C" {

int ptt_paged_decode(int dtype, const void* q, const void* kp, const void* vp,
                     void* out, const int* tables, const int* ctx_lens, int B,
                     int H, int KVH, int D, int NP, int P, int pages_per_seq,
                     float sm_scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<float>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch<__half>(q, native_pages<__half>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kp/vp int8 [KVH, NP, P, D], ks/vs float32 [KVH, NP, P].
int ptt_paged_decode_q8(int dtype, const void* q, const void* kp,
                        const void* vp, const float* ks, const float* vs,
                        void* out, const int* tables, const int* ctx_lens,
                        int B, int H, int KVH, int D, int NP, int P,
                        int pages_per_seq, float sm_scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch<float>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch<__nv_bfloat16>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch<__half>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
