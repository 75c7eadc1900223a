// Ragged paged attention for Hopper (sm_90a): a tick's mixed prefill and
// decode tokens attend their own context through the shared KV page pool.
//
// Replaces the four Pallas TPU kernels of
// paddle_tpu/ops/pallas/ragged_paged_attention.py:
//   * _qblock_kernel (:215, grid (q_blocks, kv_heads, jobs))
//       -> qblock_kernel<T, T>      (kernel 6, ptt_ragged_qblock)
//   * _qblock_kernel_quant (:258, same call :374 with two scale operands)
//       -> qblock_kernel<T, int8_t> (B7, ptt_ragged_qblock_q8)
//   * _ragged_kernel (:389, grid (tokens, kv_heads, pages))
//       -> token_kernel<T, T>       (kernel 8, ptt_ragged_token)
//   * _ragged_kernel_quant (:431, call :510)
//       -> token_kernel<T, int8_t>  (B9, ptt_ragged_token_q8)
// The int8 variants take pages of int8 codes with one fp32 scale per
// (kv head, page, slot) row and dequantise each row (int8 * scale, in
// fp32) as the page is staged in shared memory, as the reference does
// right before its dots; the rest is the native kernel's. All compute, per query row, the online-softmax recurrence
//   m' = max(m, max_p s), w = exp(s - m'), c = exp(m - m'),
//   l' = l c + sum w, acc' = acc c + w V,   out = acc / max(l, 1e-30)
// over KV pages in ascending order, in fp32 whatever the input type, and
// write the output in q's type. Masks are the reference's: a key past the
// row's causal bound scores -inf; in the q-block kernel a key of another
// sequence's job then scores BIG_NEG = -1e30 (finite, see below).
//
// What bounds it on an H100: a decode-heavy tick does ~4 flops per KV byte
// it reads (one dot and one axpy per key for each of the group's query
// heads), far under the ~295 flops/byte where bf16 tensor cores become the
// limit, so the floor is the bytes of K/V pages read at 3.35 TB/s (int8
// pages: (d + 4) / 2d of the bf16 bytes, with their scales). A large
// prefill span reads each page once per q-block that needs it and is still
// well below the tensor-core line at these tile sizes.
//
// The design is the simple one that is right first. One thread block holds
// R query rows (q-block: q_block * group rows, 8 * 4 = 32 at Llama-3-8B;
// token: group rows) in shared memory, stages one K/V page (16 x 128) at a
// time in shared memory as fp32, computes scores and the PV product with
// scalar FMAs, and keeps m, l and acc in shared memory. The TPU grid's
// sequential "arbitrary" axis becomes a loop inside the block. What it
// leaves on the table, for later work: tensor cores (wgmma / mma.sync)
// for QK^T and PV, TMA or cp.async double buffering so the next page
// loads while this one is used, keeping acc in registers, vectorised
// 16-byte loads, and splitting a long context across blocks (flash
// decoding) so a decode tick with few sequences fills all 132 SMs.
//
// The qblock schedule (jobs, row descriptors) is built on the host by
// qblock_schedule() in ops/ragged_paged_attention.py and copied to the
// device; the kernels only read it.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kBigNeg = -1e30f;

// Kernel 6 (PT = T) and B7 (PT = int8_t). Grid (q_blocks, kv_heads). Row
// r of block b is token b * qb + r / G, query head h * G + r % G.
template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads)
qblock_kernel(const T* __restrict__ q, const Pages<PT> pg, T* __restrict__ out,
              const int* __restrict__ row_slot, const int* __restrict__ row_ctx,
              const int* __restrict__ job_page, const int* __restrict__ job_slot,
              const int* __restrict__ job_kv, int T_tok, int H, int KVH, int D,
              int NP, int P, int qb, int J, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KVH, R = qb * G;
  const Tile t = carve(smem, R, P, D);

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    const int tok = b * qb + r / G;
    t.q[r * (D + 1) + e] =
        tok < T_tok ? to_f32(q[((size_t)tok * H + h * G + r % G) * D + e]) : 0.f;
  }
  init_state(t, R, D);
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    const int js = job_slot[b * J + j];
    // Padding jobs (slot -2) sit at the tail of each block's list. For a
    // row that has seen a real job they are exact no-ops: every score is
    // BIG_NEG, so w = exp(-1e30 - m) = 0 and corr = 1. Rows that have
    // seen none are padding, whose output the caller discards. Stopping
    // here changes no real row's bits.
    if (js == -2) break;
    const int jkv = job_kv[b * J + j];
    load_page(t, pg, h, job_page[b * J + j], NP, P, D);
    __syncthreads();
    for (int i = threadIdx.x; i < R * P; i += blockDim.x) {
      const int r = i / P, c = i - r * P;
      const int row = b * qb + r / G;
      float sc = score(t, r, c, D, sm_scale);
      if (jkv + c >= row_ctx[row]) sc = -INFINITY;  // causal bound
      if (row_slot[row] != js) sc = kBigNeg;        // another owner's page
      t.s[i] = sc;
    }
    __syncthreads();
    online_step(t, R, P, D);
  }

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    const int tok = b * qb + r / G;
    if (tok < T_tok)
      out[((size_t)tok * H + h * G + r % G) * D + e] =
          from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

// Kernel 8 (PT = T) and B9 (PT = int8_t). Grid (tokens, kv_heads); the
// block's rows are the group of query heads sharing kv head h. The reference grid walks all
// pages_per_seq pages; stopping at ceil(ctx / P) is bit-exact because a
// fully masked page leaves m, l and acc unchanged: every w = exp(-inf) = 0
// and corr = exp(0) = 1 once the row's first page (position 0 < ctx) has
// made m finite.
template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads)
token_kernel(const T* __restrict__ q, const Pages<PT> pg, T* __restrict__ out,
             const int* __restrict__ tok_slot, const int* __restrict__ tok_ctx,
             const int* __restrict__ tables, int H, int KVH, int D, int NP,
             int P, int pages_per_seq, float sm_scale) {
  extern __shared__ float smem[];
  const int tok = blockIdx.x, h = blockIdx.y;
  const int G = H / KVH, R = G;
  const Tile t = carve(smem, R, P, D);
  const int slot = tok_slot[tok], ctx = tok_ctx[tok];
  const int n_pages = min((ctx + P - 1) / P, pages_per_seq);

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    t.q[r * (D + 1) + e] = to_f32(q[((size_t)tok * H + h * G + r) * D + e]);
  }
  init_state(t, R, D);
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    load_page(t, pg, h, tables[(size_t)slot * pages_per_seq + p], NP, P, D);
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
    out[((size_t)tok * H + h * G + r) * D + e] =
        from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T, typename PT>
cudaError_t launch_qblock(const void* q, const Pages<PT>& pg, void* out,
                          const int* rs, const int* rc, const int* jp,
                          const int* js, const int* jk, int T_tok, int H,
                          int KVH, int D, int NP, int P, int qb, int B, int J,
                          float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(qb * (H / KVH), P, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      qblock_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  qblock_kernel<T, PT><<<dim3(B, KVH), kThreads, smem, stream>>>(
      (const T*)q, pg, (T*)out, rs, rc, jp, js, jk, T_tok, H, KVH, D, NP, P,
      qb, J, sm_scale);
  return cudaGetLastError();
}

template <typename T, typename PT>
cudaError_t launch_token(const void* q, const Pages<PT>& pg, void* out,
                         const int* ts, const int* tc, const int* tables,
                         int T_tok, int H, int KVH, int D, int NP, int P,
                         int pages_per_seq, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KVH, P, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      token_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  token_kernel<T, PT><<<dim3(T_tok, KVH), kThreads, smem, stream>>>(
      (const T*)q, pg, (T*)out, ts, tc, tables, H, KVH, D, NP, P,
      pages_per_seq, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. dtype (of q and out): 0 float32,
// 1 bfloat16, 2 float16. Every pointer is a device pointer of a
// contiguous tensor; the Python wrapper checks shapes, types and devices.
// The _q8 functions take int8 pages kp/vp [KVH, NP, P, D] and their fp32
// row scales ks/vs [KVH, NP, P]. Returns the cudaError_t of the launch (0
// on success).
extern "C" {

int ptt_ragged_qblock(int dtype, const void* q, const void* kp, const void* vp,
                      void* out, const int* row_slot, const int* row_ctx,
                      const int* job_page, const int* job_slot,
                      const int* job_kv, int T_tok, int H, int KVH, int D,
                      int NP, int P, int qb, int B, int J, float sm_scale,
                      void* stream) {
  if (T_tok <= 0 || B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_qblock<float>(q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    case 1: return (int)launch_qblock<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    case 2: return (int)launch_qblock<__half>(q, native_pages<__half>(kp, vp), out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ptt_ragged_qblock_q8(int dtype, const void* q, const void* kp,
                         const void* vp, const float* ks, const float* vs,
                         void* out, const int* row_slot, const int* row_ctx,
                         const int* job_page, const int* job_slot,
                         const int* job_kv, int T_tok, int H, int KVH, int D,
                         int NP, int P, int qb, int B, int J, float sm_scale,
                         void* stream) {
  if (T_tok <= 0 || B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_qblock<float>(q, pg, out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    case 1: return (int)launch_qblock<__nv_bfloat16>(q, pg, out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    case 2: return (int)launch_qblock<__half>(q, pg, out, row_slot, row_ctx, job_page, job_slot, job_kv, T_tok, H, KVH, D, NP, P, qb, B, J, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ptt_ragged_token(int dtype, const void* q, const void* kp, const void* vp,
                     void* out, const int* tok_slot, const int* tok_ctx,
                     const int* tables, int T_tok, int H, int KVH, int D,
                     int NP, int P, int pages_per_seq, float sm_scale,
                     void* stream) {
  if (T_tok <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_token<float>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch_token<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch_token<__half>(q, native_pages<__half>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ptt_ragged_token_q8(int dtype, const void* q, const void* kp,
                        const void* vp, const float* ks, const float* vs,
                        void* out, const int* tok_slot, const int* tok_ctx,
                        const int* tables, int T_tok, int H, int KVH, int D,
                        int NP, int P, int pages_per_seq, float sm_scale,
                        void* stream) {
  if (T_tok <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_token<float>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch_token<__nv_bfloat16>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch_token<__half>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
