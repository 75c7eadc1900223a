// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of exact
// softmax attention, recomputing the weights from the forward's per-row
// log-sum-exp instead of storing them.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
//   _bwd_dq_kernel  (:232, pallas_call :369): grid (b, hq, q_blocks,
//                   kv_blocks), the kv axis sequential, dq in VMEM scratch;
//   _bwd_dkv_kernel (:277, pallas_call :393): grid (b, hq, kv_blocks,
//                   q_blocks), the q axis sequential, dk and dv per query
//                   head in fp32, summed over the GQA group afterwards
//                   (:412-416).
// Both compute, per (query row r, key c) pair, in fp32:
//   s = (q_r . k_c) * sm_scale,  p = valid ? exp(s - lse_r) : 0,
//   dp = do_r . v_c,  ds = p * (dp - delta_r) * sm_scale,
//   dq_r += ds k_c,  dk_c += ds q_r,  dv_c += p do_r,
// where delta_r = rowsum(do_r * out_r) (minus the lse cotangent, when lse
// is differentiated) comes from the wrapper, and key c of row r is valid
// iff c < sk and (not causal, or q_offset + r >= kv_offset + c). A row with
// no valid key therefore gets dq = 0 and adds nothing to dk or dv, whatever
// its forward returned (the mean of V over its tiles, C10). The reference
// skips a (q-block, kv-block) tile when its last query cannot see its first
// key; every valid pair lies in a tile it runs, so skipping by validity, as
// here, visits the same pairs and changes no term.
//
// What bounds it on an H100: per visible pair, dQ does three dots of width
// d (s, dp, ds k) and dK/dV four (s, dp, p do, ds q), 6 d and 8 d flops;
// at a causal 2 x 2048 tokens with 32 heads of 128 that is ~1e11 and
// ~1.4e11 flops against ~100 MB of bf16 tensors, so both are compute-bound
// on the tensor cores (989 TFLOP/s, ~0.1 ms). These first kernels reach for
// neither bound: they compute every dot with scalar fp32 FMAs from shared
// memory (67 TFLOP/s at best for the fp32 pipes, less for the shared-memory
// loads). The design is the simple one that is right first:
// * dQ (flash_bwd_dq_kernel): one block of 256 threads per (batch, query
//   head, tile of BQ query rows). Q and dO of the tile stay in shared
//   memory; the block walks the key tiles up to the tile's causal limit,
//   staging K and V. Each thread owns a (BQ/16) x (BK/16) patch of s and dp
//   (rows ty + 16 i, keys tx + 16 j) and a (BQ/16) x (D/16) patch of dq in
//   registers; ds goes through shared memory to the ds k product.
// * dK/dV (flash_bwd_dkv_kernel): one block per (batch, kv head, tile of BK
//   keys). K and V stay in shared memory; the block walks every query head
//   of the kv head's group and, for each, the query tiles from the first
//   one that can see the tile's first key, staging Q, dO, lse and delta.
//   Each thread owns a patch of the transposed s and dp (keys ty + 16 i,
//   rows tx + 16 j) and (BK/16) x (D/16) patches of dk and dv in registers.
//   The GQA sum happens in those registers: no atomics, no [b, hq, sk, d]
//   fp32 scratch, and a deterministic result. Its order differs from the
//   reference's (per head, then over the group), which moves the sums by a
//   few fp32 ulp.
// Tiles are 64 x 64 up to d = 128 and 32 x 32 above, so that the staged
// tiles fit the 227 KB of shared memory a block may have (d = 128: 148,736
// bytes for dQ, 165,888 for dK/dV). Left for later work: wgmma products
// with bf16 operands, TMA or cp.async double buffering, and more than one
// block per SM.

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16

template <int D>
struct BwdTile {
  static constexpr int kRows = D <= 128 ? 64 : 32;  // BQ = BK
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, HQ, SQ]
  const float* delta;   // [B, HQ, SQ]
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;   // element strides: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;   // dout
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int HQ, HK, SQ, SK;
  int q_off, kv_off, causal;
  float sm_scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int row, int key) {
  return row < a.SQ && key < a.SK &&
         (!a.causal || a.q_off + row >= a.kv_off + key);
}

// Stage rows [r0, r0 + R) of a [rows, D] slice with row stride `ss` as
// fp32 into `dst` (row stride D + 1); rows at or past `n` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int R, int n) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    dst[r * (D + 1) + e] =
        r0 + r < n ? to_f32(src[(long long)(r0 + r) * ss + e]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int BQ = BwdTile<D>::kRows, BK = BQ;
  constexpr int RI = BQ / 16, KJ = BK / 16, NC = D / 16;
  constexpr int QS = D + 1, SS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* dOs = Qs + BQ * QS;   // [BQ][QS]
  float* Ks = dOs + BQ * QS;   // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* dSs = Vs + BK * QS;   // [BQ][SS]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.HQ / a.HK);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* dout = (const T*)a.dout + b * a.o_sb + h * a.o_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const long long row_base = ((long long)b * a.HQ + h) * a.SQ;

  stage<T, D>(Qs, q, a.q_ss, q0, BQ, a.SQ);
  stage<T, D>(dOs, dout, a.o_ss, q0, BQ, a.SQ);

  float lse[RI], delta[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < a.SQ ? a.lse[row_base + row] : 0.f;
    delta[i] = row < a.SQ ? a.delta[row_base + row] : 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }
  // keys past the block's last row's causal limit are invalid for all rows
  const int last = min(q0 + BQ, a.SQ) - 1;
  const int n_keys =
      a.causal ? min(a.SK, a.q_off + last - a.kv_off + 1) : a.SK;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // Q/dO staged; the previous tile fully consumed
    stage<T, D>(Ks, k, a.k_ss, k0, BK, a.SK);
    stage<T, D>(Vs, v, a.v_ss, k0, BK, a.SK);
    __syncthreads();

    float s[RI][KJ], dp[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qa[RI], oa[RI], kb[KJ], vb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qa[i] = Qs[(ty + 16 * i) * QS + e];
        oa[i] = dOs[(ty + 16 * i) * QS + e];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kb[j] = Ks[(tx + 16 * j) * QS + e];
        vb[j] = Vs[(tx + 16 * j) * QS + e];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int row = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
        const float p =
            visible(a, row, key) ? expf(s[i][j] * a.sm_scale - lse[i]) : 0.f;
        dSs[(ty + 16 * i) * SS + tx + 16 * j] =
            p * (dp[i][j] - delta[i]) * a.sm_scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RI], kc[NC];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) kc[n] = Ks[c * QS + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(ds[i], kc[n], acc[i][n]);
    }
  }

  T* dq = (T*)a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.SQ) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      dq[(long long)row * a.dq_ss + tx + 16 * n] = from_f32<T>(acc[i][n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int BK = BwdTile<D>::kRows, BQ = BK;
  constexpr int KI = BK / 16, QJ = BQ / 16, NC = D / 16;
  constexpr int QS = D + 1, PS = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* Qs = Vs + BK * QS;    // [BQ][QS]
  float* dOs = Qs + BQ * QS;   // [BQ][QS]
  float* Ps = dOs + BQ * QS;   // [BK][PS] weights, keys by rows
  float* dSs = Ps + BK * PS;   // [BK][PS]
  float* lse_s = dSs + BK * PS;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.HQ / a.HK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  stage<T, D>(Ks, k, a.k_ss, k0, BK, a.SK);
  stage<T, D>(Vs, v, a.v_ss, k0, BK, a.SK);

  float dk[KI][NC], dv[KI][NC];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[i][n] = dv[i][n] = 0.f;
  // the first query row that can see the tile's first key
  int r_first = a.causal ? max(0, a.kv_off + k0 - a.q_off) : 0;
  r_first = (r_first / BQ) * BQ;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
    const T* dout = (const T*)a.dout + b * a.o_sb + h * a.o_sh;
    const long long row_base = ((long long)b * a.HQ + h) * a.SQ;
    for (int q0 = r_first; q0 < a.SQ; q0 += BQ) {
      __syncthreads();  // K/V staged; the previous tile fully consumed
      stage<T, D>(Qs, q, a.q_ss, q0, BQ, a.SQ);
      stage<T, D>(dOs, dout, a.o_ss, q0, BQ, a.SQ);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < a.SQ;
        lse_s[r] = in ? a.lse[row_base + q0 + r] : 0.f;
        delta_s[r] = in ? a.delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[KI][QJ], dp[KI][QJ];
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        float ka[KI], va[KI], qb[QJ], ob[QJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          ka[i] = Ks[(ty + 16 * i) * QS + e];
          va[i] = Vs[(ty + 16 * i) * QS + e];
        }
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          qb[j] = Qs[(tx + 16 * j) * QS + e];
          ob[j] = dOs[(tx + 16 * j) * QS + e];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
            s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
            dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int key = k0 + ty + 16 * i, r = tx + 16 * j;
          const float p = visible(a, q0 + r, key)
                              ? expf(s[i][j] * a.sm_scale - lse_s[r])
                              : 0.f;
          Ps[(ty + 16 * i) * PS + r] = p;
          dSs[(ty + 16 * i) * PS + r] =
              p * (dp[i][j] - delta_s[r]) * a.sm_scale;
        }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pr[KI], ds[KI], qc[NC], oc[NC];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pr[i] = Ps[(ty + 16 * i) * PS + c];
          ds[i] = dSs[(ty + 16 * i) * PS + c];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          qc[n] = Qs[c * QS + tx + 16 * n];
          oc[n] = dOs[c * QS + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            dv[i][n] = fmaf(pr[i], oc[n], dv[i][n]);
            dk[i][n] = fmaf(ds[i], qc[n], dk[i][n]);
          }
      }
    }
  }

  T* dkp = (T*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  T* dvp = (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.SK) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dkp[(long long)key * a.dk_ss + tx + 16 * n] = from_f32<T>(dk[i][n]);
      dvp[(long long)key * a.dv_ss + tx + 16 * n] = from_f32<T>(dv[i][n]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int R = BwdTile<D>::kRows;
  const size_t smem = (size_t)(4 * R * (D + 1) + R * (R + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.SQ + R - 1) / R, a.HQ, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int R = BwdTile<D>::kRows;
  const size_t smem =
      (size_t)(4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.SK + R - 1) / R, a.HK, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool DKV>
cudaError_t launch_d(const BwdArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 64: return DKV ? launch_dkv<T, 64>(a, B, s) : launch_dq<T, 64>(a, B, s);
    case 128: return DKV ? launch_dkv<T, 128>(a, B, s) : launch_dq<T, 128>(a, B, s);
    case 192: return DKV ? launch_dkv<T, 192>(a, B, s) : launch_dq<T, 192>(a, B, s);
    case 256: return DKV ? launch_dkv<T, 256>(a, B, s) : launch_dq<T, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int launch_typed(int dtype, const BwdArgs& a, int B, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_d<float, DKV>(a, B, D, s);
    case 1: return (int)launch_d<__nv_bfloat16, DKV>(a, B, D, s);
    case 2: return (int)launch_d<__half, DKV>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. q, k, v, dout and the gradients are device pointers with unit
// stride along head_dim and the given element strides along batch, head and
// row (q, dout and dq [B, HQ, SQ, D]; k, v, dk and dv [B, HK, SK, D] in that
// index order); lse and delta are contiguous fp32 [B, HQ, SQ]. The Python
// wrapper checks shapes, types and devices. Each returns the cudaError_t of
// its shared-memory request and launch.
extern "C" int ptt_flash_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    int B, int HQ, int HK, int SQ, int SK, int D, int q_off, int kv_off,
    int causal, float sm_scale, void* stream) {
  if (B <= 0 || SQ <= 0 || HQ <= 0) return (int)cudaSuccess;
  BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
            o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss, 0, 0, 0, 0, 0, 0,
            HQ, HK, SQ, SK, q_off, kv_off, causal, sm_scale};
  return launch_typed<false>(dtype, a, B, D, stream);
}

extern "C" int ptt_flash_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int B, int HQ, int HK, int SQ, int SK, int D, int q_off, int kv_off,
    int causal, float sm_scale, void* stream) {
  if (B <= 0 || SK <= 0 || HK <= 0) return (int)cudaSuccess;
  BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
            o_sb, o_sh, o_ss, 0, 0, 0, dk_sb, dk_sh, dk_ss,
            dv_sb, dv_sh, dv_ss,
            HQ, HK, SQ, SK, q_off, kv_off, causal, sm_scale};
  return launch_typed<true>(dtype, a, B, D, stream);
}
