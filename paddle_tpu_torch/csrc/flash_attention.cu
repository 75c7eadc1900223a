// Flash attention forward for Hopper (sm_90a): exact softmax attention
// over dense Q, K, V without materialising the score matrix, returning
// the output and the per-row log-sum-exp.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// paddle_tpu/ops/pallas/flash_attention.py (:110, pallas_call :195; grid
// (b, hq, q_blocks, kv_blocks), the kv axis sequential, blocks 128 x 128).
// Per query row it runs the online-softmax recurrence over key tiles
//   m' = max(m, max s), p = exp(s - m'), c = exp(m - m'),
//   l' = l c + sum p, acc' = acc c + p V
// in fp32 with the reference's finite mask NEG_INF = -1e30 and its rules:
// key k of row q is valid iff k < sk and (not causal, or q_offset + q >=
// kv_offset + k); out = acc / max(l, 1e-30) in q's type; lse = m +
// log(max(l, 1e-30)), or NEG_INF where l <= 1e-30, in fp32.
//
// Which keys a row visits is the reference's, not this kernel's tiling:
// the reference runs a (128-row, 128-key) tile iff its last query can see
// its first key, so a row visits every key of the reference tiles up to
// the last one its reference q-block runs (padded keys past sk included).
// A row with no valid key then gets p = exp(-1e30 - -1e30) = 1 on every
// visited key, and its output is the mean of V over them, not zero. This
// kernel reproduces that: keys past the row's reference range score
// -inf (weight exactly 0, whatever m is), keys inside it that are masked
// score -1e30. When no row of a block is dead, keys past the last row's
// causal limit are skipped outright: once key 0 has made m a real score,
// a -1e30 key adds exp(-1e30 - m) = 0 and corrects by exp(0) = 1, so
// stopping there changes no bit.
//
// What bounds it on an H100: a causal prefill of s tokens does on average
// 2 s d flops per query row (two dots of width d for each of ~s/2 visible
// keys) against ~5 d bytes of q, out and its share of K/V in bf16. At
// s = 512, d = 128 with four query heads per kv head that is ~200
// flops/byte, near the ~295 where bf16 tensor cores become the limit, so
// the byte floor (3.35 TB/s) and the FLOP floor (989 TFLOP/s) lie within
// 1.5x of each other. This first kernel reaches for neither: it computes
// QK^T and PV with scalar fp32 FMAs
// from shared memory, so it is bounded by shared-memory loads and the
// fp32 pipes (67 TFLOP/s at best). The design is the simple one that is
// right first. One block of 256 threads holds 64 query rows; each thread
// owns a 4 x 4 tile of scores (rows ty + 16 i, keys tx + 16 j) and a
// 4 x D/16 tile of the output (rows ty + 16 i, columns tx + 16 j) in
// registers, with m and l for its four rows. K and V tiles of 64 keys are
// staged in shared memory as fp32; the row reductions run across the 16
// lanes of a half-warp with shuffles. GQA reads kv head h / group. What it
// leaves on the table, for later work: wgmma tensor-core products with
// bf16 operands, TMA or cp.async double buffering of the K/V tiles, and
// a second pass over split key ranges for short, wide batches.

#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                      // [B, HQ, SQ]
  long long q_sb, q_sh, q_ss;      // element strides: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int HQ, HK, SQ, SK;
  int q_off, kv_off, causal;
  int bq_ref, bk_ref, kv_blocks_ref;  // the reference's tiling
  float sm_scale;
};

// End (exclusive, local key index) of the keys the reference visits for
// query row `row`: all of its q-block's tiles that run.
__device__ __forceinline__ int ref_kv_end(int row, const Args& a) {
  if (!a.causal) return a.kv_blocks_ref * a.bk_ref;
  const int last_q = a.q_off + (row / a.bq_ref) * a.bq_ref + a.bq_ref - 1;
  const int span = last_q - a.kv_off;   // tile j runs iff j * bk_ref <= span
  if (span < 0) return 0;
  return min(span / a.bk_ref + 1, a.kv_blocks_ref) * a.bk_ref;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int NC = D / 16;       // output columns per thread
  constexpr int QS = D + 1;        // padded row stride of Qs and Ks
  constexpr int PS = kBK + 1;      // padded row stride of Ps
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;       // [kBK][QS]
  float* Vs = Ks + kBK * QS;       // [kBK][D]
  float* Ps = Vs + kBK * D;        // [kBQ][PS] weights of the current tile

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.HQ / a.HK);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    Qs[r * QS + e] =
        q0 + r < a.SQ ? to_f32(q[(long long)(q0 + r) * a.q_ss + e]) : 0.f;
  }

  int row_end[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_end[i] = row < a.SQ ? ref_kv_end(row, a) : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  // rows' ranges grow with the row, so the block's last row bounds them
  const int last = min(q0 + kBQ, a.SQ) - 1;
  int n_keys = ref_kv_end(last, a);
  if (a.causal && a.q_off + q0 >= a.kv_off)  // no dead row in the block
    n_keys = min(n_keys, a.q_off + last - a.kv_off + 1);

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // Qs written; the previous tile fully consumed
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int c = i / D, e = i - c * D;
      const bool in = k0 + c < a.SK;
      Ks[c * QS + e] = in ? to_f32(k[(long long)(k0 + c) * a.k_ss + e]) : 0.f;
      Vs[c * D + e] = in ? to_f32(v[(long long)(k0 + c) * a.v_ss + e]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * QS + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = a.q_off + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float sc = s[i][j] * a.sm_scale;
        if (key >= row_end[i])
          sc = -INFINITY;  // a tile the reference never runs for this row
        else if (key >= a.SK || (a.causal && qpos < a.kv_off + key))
          sc = kNegInf;
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* out = (T*)a.out + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.SQ) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[(long long)row * a.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    if (tx == 0)
      a.lse[((long long)b * a.HQ + h) * a.SQ + row] =
          l[i] <= 1e-30f ? kNegInf : m[i] + logf(den);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.SQ + kBQ - 1) / kBQ, a.HQ, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 192: return launch<T, 192>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. q, k, v and out are device pointers with unit stride along
// head_dim and the given element strides along batch, head and row; lse
// is a contiguous fp32 [B, HQ, SQ]. bq_ref / bk_ref are the reference's
// block sizes for these lengths (min(128, max(s, 8))). The Python wrapper
// checks shapes, types and devices. Returns the cudaError_t of the launch.
extern "C" int ptt_flash_fwd(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* lse, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int B, int HQ, int HK, int SQ, int SK, int D, int q_off,
    int kv_off, int causal, int bq_ref, int bk_ref, float sm_scale,
    void* stream) {
  if (B <= 0 || SQ <= 0 || HQ <= 0) return (int)cudaSuccess;
  Args a{q, k, v, out, lse,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss,
         HQ, HK, SQ, SK, q_off, kv_off, causal,
         bq_ref, bk_ref, (SK + bk_ref - 1) / bk_ref, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_d<float>(a, B, D, s);
    case 1: return (int)launch_d<__nv_bfloat16>(a, B, D, s);
    case 2: return (int)launch_d<__half>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
