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
// on the tensor cores (989 TFLOP/s, ~0.1 ms). Two pairs of kernels;
// ops/flash_attention.py:bwd_variant picks one.
//
// The tensor-core kernels (bf16 and fp16 at head_dim 64 and 128),
// flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel: a producer
// warpgroup whose first thread issues TMA copies into 128-byte-swizzled
// shared memory (from the tensors as the wrapper gets them, [b, s, h, d]
// views or the kernel layout; TMA's zero fill covers rows past sq and keys
// past sk) and NWG consumer warpgroups of 64 rows each (setmaxnreg 24 /
// 240 with two). Every product is a wgmma with fp32 accumulators:
// * dQ: one block per (batch, query head, NWG * 64 query rows), heaviest
//   causal blocks first. Q and dO stay resident; K and V stream through a
//   three-stage ring of 64-key tiles up to the block's causal limit. Per
//   tile, S = Q K^T and dP = dO V^T (m64n64k16, both operands K-major),
//   then p and ds on the accumulator registers (lse and delta are per
//   row, two rows a thread, read once), ds rounded to q's type as the
//   register A operand of dQ += dS K (K read MN-major). Tile j's dS K runs
//   while tile j + 1's S and dP become dS. dQ leaves the registers once.
// * dK/dV: one block per (batch, kv head, NWG * 64 keys), the first key
//   blocks (the most query rows under causal masking) first. K and V stay
//   resident; for each query head of the group, the query tiles of 64 rows
//   from the first that can see the block's first key stream through the
//   ring with their lse and delta rows (staged by the producer's second
//   warp: each thread needs those of its fragment's columns). In the
//   transposed orientation (keys are a warpgroup's M rows): S^T = K Q^T,
//   dP^T = V dO^T, p^T and ds^T in registers (p while dP^T still runs),
//   then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to the
//   type as register A operands and dO, Q read MN-major. The GQA sum stays
//   in the dK and dV registers: no atomics, no fp32 scratch, deterministic.
// Rounding p and ds to bf16 or fp16 before those three products is a
// departure from the reference, which dots in fp32 (ROADMAP C17): each
// rounded value moves by at most u (2^-8 bf16, 2^-11 fp16) of itself, so
// dv moves by at most u |P|^T |dO|, dq by u |dS| |K|, dk by u |dS|^T |Q|.
// Validity is tested per pair before the exp only on tiles where some pair
// may be invalid (the causal diagonal, the ragged edge); a row past sq gets
// lse = +inf, so its p is 0. Left for later work: the second consumer
// warpgroup's products overlapped with the first's exp (ping-pong), a
// persistent grid, and FA3's single kernel (dQ by fp32 atomics; ROADMAP).
//
// The scalar kernels (fp32 at every head_dim, bf16 and fp16 at 192 and
// 256), the simple kernels that were right first; they keep fp32 exact to
// the reference (1e-5, ROADMAP C1). Every dot is a scalar fp32 FMA from
// shared memory (67 TFLOP/s at best for the fp32 pipes, less for the
// shared-memory loads):
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
// bytes for dQ, 165,888 for dK/dV).

#include "attention_common.cuh"
#include "hopper_common.cuh"

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

template <typename T, int D, bool DKV>
cudaError_t launch_one(const BwdArgs& a, int B, cudaStream_t s) {
  return DKV ? launch_dkv<T, D>(a, B, s) : launch_dq<T, D>(a, B, s);
}

// The instantiations the dispatch sends here: fp32 at every head_dim,
// bf16 and fp16 only where the tensor-core kernels have none (192, 256).
template <typename T, bool DKV>
cudaError_t launch_d(const BwdArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 192: return launch_one<T, 192, DKV>(a, B, s);
    case 256: return launch_one<T, 256, DKV>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float, false>(const BwdArgs& a, int B, int D,
                                   cudaStream_t s) {
  switch (D) {
    case 64: return launch_one<float, 64, false>(a, B, s);
    case 128: return launch_one<float, 128, false>(a, B, s);
    case 192: return launch_one<float, 192, false>(a, B, s);
    case 256: return launch_one<float, 256, false>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float, true>(const BwdArgs& a, int B, int D,
                                  cudaStream_t s) {
  switch (D) {
    case 64: return launch_one<float, 64, true>(a, B, s);
    case 128: return launch_one<float, 128, true>(a, B, s);
    case 192: return launch_one<float, 192, true>(a, B, s);
    case 256: return launch_one<float, 256, true>(a, B, s);
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

// ---------------------------------------------------- tensor-core kernels

constexpr int kTcTile = 64;      // keys a dQ tile; query rows a dK/dV tile
constexpr int kTcStages = 3;     // depth of the streamed-tile ring
constexpr float kLog2e = 1.4426950408889634f;

struct TcBwdArgs {
  const float* lse;              // [B, HQ, SQ]
  const float* delta;            // [B, HQ, SQ]
  void* g0;                      // dq (B2) or dk (B3)
  void* g1;                      // dv (B3)
  long long g0_sb, g0_sh, g0_ss; // element strides of g0 and g1
  long long g1_sb, g1_sh, g1_ss;
  int HQ, HK, SQ, SK;
  int q_off, kv_off, causal;
  float sm_scale;
  int q_order, k_order, v_order, o_order;  // axis orders of the maps
};

// Shared memory of one block, in bytes from a 1024-aligned base: the two
// resident operands (D / 64 boxes of NWG * 64 rows each), then a ring of
// kTcStages stages of the two streamed operands (D / 64 boxes of 64 rows
// each), `extra` bytes a stage (B3's lse and delta rows), the barriers.
template <int D, int NWG, int EXTRA>
struct TcBwdSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kResBox = NWG * 64 * 128;
  static constexpr int kTileBox = kTcTile * 128;
  static constexpr int kRes = kBoxes * kResBox;     // one resident operand
  static constexpr int kTile = kBoxes * kTileBox;   // one streamed tile
  static constexpr int kRes0 = 0, kRes1 = kRes;
  static constexpr int kStr0 = 2 * kRes;            // stage st at + st * kTile
  static constexpr int kStr1 = kStr0 + kTcStages * kTile;
  static constexpr int kExtra = kStr1 + kTcStages * kTile;
  static constexpr int kBars = kExtra + kTcStages * EXTRA;
  // full_res, full[stages], empty[stages]
  static constexpr int kBytes = kBars + (1 + 2 * kTcStages) * 8 + 1024;
};

// S = A B^T over head_dim for one warpgroup: A its 64 rows of a resident
// operand (K-major), B a 64-row streamed tile (K-major); D / 16 steps of
// k16, 32 bytes apart in a swizzled row, the next 64-column box after four.
template <typename T, int D, int NWG>
__device__ __forceinline__ void issue_ss(float (&acc)[32], const uint8_t* res,
                                         const uint8_t* tile) {
  using L = TcBwdSmem<D, NWG, 0>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    Wgmma<T>::ss64(acc,
                   smem_desc(res + (kk / 4) * L::kResBox + off, 16, 1024),
                   smem_desc(tile + (kk / 4) * L::kTileBox + off, 16, 1024),
                   kk);
  }
}

// acc += F X for one warpgroup: F the 64 x 64 fragment packed to T (four
// k16 A fragments), X a 64-row streamed tile read MN-major (16 rows, 2048
// bytes, a step; its 64-column boxes kTileBox apart).
template <typename T, int D, int NWG>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&f)[16],
                                         const uint8_t* tile) {
  using L = TcBwdSmem<D, NWG, 0>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<T>::rs(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3],
                 smem_desc(tile + kk * 2048, L::kTileBox, 1024), 1);
}

template <typename T>
__device__ __forceinline__ void pack_frag(const float (&x)[32],
                                          uint32_t (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = Wgmma<T>::pack(x[2 * i], x[2 * i + 1]);
}

// Writes a warpgroup's fp32 accumulator of rows r_a and r_a + 8 (those
// below n) in T: columns 8 jj + col + {0, 1} of each.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], T* base,
                                           long long ss, int r_a, int col,
                                           int n) {
  T* pa = base + (long long)r_a * ss + col;
  T* pb = pa + 8 * ss;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (r_a < n)
      *reinterpret_cast<uint32_t*>(pa + 8 * jj) =
          Wgmma<T>::pack(acc[4 * jj], acc[4 * jj + 1]);
    if (r_a + 8 < n)
      *reinterpret_cast<uint32_t*>(pb + 8 * jj) =
          Wgmma<T>::pack(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          const TcBwdArgs a) {
  using L = TcBwdSmem<D, NWG, 0>;
  constexpr int BQ = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_res = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_res + 1;
  uint64_t* empty = full + kTcStages;

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest q-blocks first under causal masking
  const int q0 = (a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int hk = h / (a.HQ / a.HK);
  // keys past the block's last row's causal limit are invalid for all rows
  const int last = min(q0 + BQ, a.SQ) - 1;
  const int n_keys =
      a.causal ? min(a.SK, a.q_off + last - a.kv_off + 1) : a.SK;
  const int n_tiles = n_keys > 0 ? (n_keys + kTcTile - 1) / kTcTile : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_res, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NWG * 4) {
    // producer warpgroup: one thread issues every copy (Q and dO once,
    // then K and V tile by tile through the ring)
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (threadIdx.x == NWG * 128 && n_tiles > 0) {
      mbar_expect_tx(full_res, 2 * L::kRes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_rows(smem + L::kRes0 + c * L::kResBox, &tm_q, full_res,
                      64 * c, q0, h, b, a.q_order);
        tma_load_rows(smem + L::kRes1 + c * L::kResBox, &tm_o, full_res,
                      64 * c, q0, h, b, a.o_order);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        mbar_wait(empty + st, ((j / kTcStages) & 1) ^ 1);
        uint8_t* ks = smem + L::kStr0 + st * L::kTile;
        uint8_t* vs = smem + L::kStr1 + st * L::kTile;
        mbar_expect_tx(full + st, 2 * L::kTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_rows(ks + c * L::kTileBox, &tm_k, full + st, 64 * c,
                        j * kTcTile, hk, b, a.k_order);
          tma_load_rows(vs + c * L::kTileBox, &tm_v, full + st, 64 * c,
                        j * kTcTile, hk, b, a.v_order);
        }
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<240>();
  // consumers: warpgroup wg owns query rows wrow0 .. wrow0 + 63; this
  // thread rows row_a and row_a + 8, keys kcol + {0, 1} of every 8
  const int wg = warp / 4;
  const int wrow0 = q0 + wg * 64;
  const int row_a = wrow0 + (warp % 4) * 16 + lane / 4, row_b = row_a + 8;
  const int kcol = 2 * (lane % 4);
  const long long rb0 = ((long long)b * a.HQ + h) * a.SQ;
  // lse in log2 units; a row past SQ gets +inf, so its p is exactly 0
  const float ls_a = row_a < a.SQ ? a.lse[rb0 + row_a] * kLog2e : INFINITY;
  const float ls_b = row_b < a.SQ ? a.lse[rb0 + row_b] * kLog2e : INFINITY;
  const float dl_a = row_a < a.SQ ? a.delta[rb0 + row_a] : 0.f;
  const float dl_b = row_b < a.SQ ? a.delta[rb0 + row_b] : 0.f;
  const float c2 = a.sm_scale * kLog2e;
  const uint8_t* qs = smem + L::kRes0 + wg * 64 * 128;
  const uint8_t* dos = smem + L::kRes1 + wg * 64 * 128;

  // S = Q K^T and dP = dO V^T of stage st, one commit group
  auto issue_sdp = [&](float (&s)[32], float (&dp)[32], int st) {
    issue_ss<T, D, NWG>(s, qs, smem + L::kStr0 + st * L::kTile);
    issue_ss<T, D, NWG>(dp, dos, smem + L::kStr1 + st * L::kTile);
    wgmma_commit();
  };
  // p = valid ? exp(s scale - lse) : 0 and ds = p (dp - delta) scale, in
  // the dp registers; the per-pair test only where some pair of the
  // warpgroup's rows and the tile's keys may be invalid
  auto grad_tile = [&](const float (&s)[32], float (&dp)[32], int k0) {
    const bool masked =
        k0 + kTcTile > a.SK ||
        (a.causal && a.kv_off + k0 + kTcTile - 1 > a.q_off + wrow0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool rb = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], c2, -(rb ? ls_b : ls_a)));
      if (masked) {
        const int key = k0 + 8 * (i / 4) + kcol + (i & 1);
        if (key >= a.SK ||
            (a.causal && a.q_off + (rb ? row_b : row_a) < a.kv_off + key))
          p = 0.f;
      }
      dp[i] = p * (dp[i] - (rb ? dl_b : dl_a)) * a.sm_scale;
    }
  };

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t ds[16];
  if (n_tiles > 0) {
    mbar_wait(full_res, 0);
    mbar_wait(full, 0);
    wgmma_fence();
    issue_sdp(s, dp, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grad_tile(s, dp, 0);
    pack_frag<T>(dp, ds);
    // tile j's dQ += dS K runs while tile j + 1's scores and dP, issued
    // just before it, become dS; those become the A fragments only once
    // the product is done with the registers. The last tile's product is
    // peeled off so that no product sits in a branch.
    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int st = j % kTcStages, st1 = (j + 1) % kTcStages;
      mbar_wait(full + st1, ((j + 1) / kTcStages) & 1);
      wgmma_fence();
      issue_sdp(s, dp, st1);
      issue_rs<T, D, NWG>(dq, ds, smem + L::kStr0 + st * L::kTile);
      wgmma_commit();
      wgmma_wait<1>();  // S and dP; dQ's product may still run
      fence_regs(s);
      fence_regs(dp);
      grad_tile(s, dp, (j + 1) * kTcTile);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with it
      pack_frag<T>(dp, ds);
    }
    const int jl = n_tiles - 1;
    wgmma_fence();
    issue_rs<T, D, NWG>(dq, ds, smem + L::kStr0 + (jl % kTcStages) * L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
  }
  T* g = (T*)a.g0 + (long long)b * a.g0_sb + (long long)h * a.g0_sh;
  store_rows<T, D>(dq, g, a.g0_ss, row_a, kcol, a.SQ);
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const TcBwdArgs a) {
  // a stage also holds the tile's 64 lse (log2 units) and 64 delta values
  using L = TcBwdSmem<D, NWG, 2 * kTcTile * 4>;
  constexpr int BK = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_res = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = full_res + 1;
  uint64_t* empty = full + kTcStages;
  float* rows = reinterpret_cast<float*>(smem + L::kExtra);

  const int hk = blockIdx.x, b = blockIdx.y;
  // the first key blocks see the most query rows under causal masking,
  // and blocks start in order of their index
  const int k0 = blockIdx.z * BK;
  const int G = a.HQ / a.HK;
  // the first query tile that can see the block's first key
  int r_first = a.causal ? max(0, a.kv_off + k0 - a.q_off) : 0;
  r_first = (r_first / kTcTile) * kTcTile;
  const int n_q = r_first < a.SQ ? (a.SQ - r_first + kTcTile - 1) / kTcTile : 0;
  const int n_tiles = G * n_q;   // (head g, q tile t) at j = g n_q + t

  if (threadIdx.x == 0) {
    mbar_init(full_res, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 1 + 32);     // the copies, and the rows' warp
      mbar_init(empty + s, NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NWG * 4) {
    // producer warpgroup: its first thread issues the copies (K and V
    // once, then Q and dO tile by tile through the ring); its second warp
    // stages each tile's lse and delta rows
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (threadIdx.x == NWG * 128 && n_tiles > 0) {
      mbar_expect_tx(full_res, 2 * L::kRes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_rows(smem + L::kRes0 + c * L::kResBox, &tm_k, full_res,
                      64 * c, k0, hk, b, a.k_order);
        tma_load_rows(smem + L::kRes1 + c * L::kResBox, &tm_v, full_res,
                      64 * c, k0, hk, b, a.v_order);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        const int h = hk * G + j / n_q, r0 = r_first + (j % n_q) * kTcTile;
        mbar_wait(empty + st, ((j / kTcStages) & 1) ^ 1);
        uint8_t* qs = smem + L::kStr0 + st * L::kTile;
        uint8_t* os = smem + L::kStr1 + st * L::kTile;
        mbar_expect_tx(full + st, 2 * L::kTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_rows(qs + c * L::kTileBox, &tm_q, full + st, 64 * c, r0, h,
                        b, a.q_order);
          tma_load_rows(os + c * L::kTileBox, &tm_o, full + st, 64 * c, r0, h,
                        b, a.o_order);
        }
      }
    } else if (warp == NWG * 4 + 1) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        const int h = hk * G + j / n_q, r0 = r_first + (j % n_q) * kTcTile;
        const long long rb0 = ((long long)b * a.HQ + h) * a.SQ;
        mbar_wait(empty + st, ((j / kTcStages) & 1) ^ 1);
        float* ls = rows + st * 2 * kTcTile;
        // rows past SQ: lse +inf (p exactly 0), delta 0
        for (int r = lane; r < kTcTile; r += 32) {
          const bool in = r0 + r < a.SQ;
          ls[r] = in ? a.lse[rb0 + r0 + r] * kLog2e : INFINITY;
          ls[kTcTile + r] = in ? a.delta[rb0 + r0 + r] : 0.f;
        }
        mbar_arrive(full + st);  // releases this lane's stores
      }
    }
    return;
  }
  if constexpr (NWG == 2) reg_alloc<240>();
  // consumers, in the transposed orientation: warpgroup wg owns keys
  // wk0 .. wk0 + 63 as its M rows; this thread keys key_a and key_a + 8,
  // query rows rcol + {0, 1} of every 8 of a tile
  const int wg = warp / 4;
  const int wk0 = k0 + wg * 64;
  const int key_a = wk0 + (warp % 4) * 16 + lane / 4, key_b = key_a + 8;
  const int rcol = 2 * (lane % 4);
  const float c2 = a.sm_scale * kLog2e;
  const uint8_t* ks = smem + L::kRes0 + wg * 64 * 128;
  const uint8_t* vs = smem + L::kRes1 + wg * 64 * 128;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
  uint32_t pf[16], dsf[16];
  if (n_tiles > 0) mbar_wait(full_res, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kTcStages;
    const int r0 = r_first + (j % n_q) * kTcTile;
    const uint8_t* qt = smem + L::kStr0 + st * L::kTile;
    const uint8_t* ot = smem + L::kStr1 + st * L::kTile;
    const float* ls = rows + st * 2 * kTcTile;
    const float* dl = ls + kTcTile;
    mbar_wait(full + st, (j / kTcStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T, two commit groups: p is computed
    // while dP^T runs
    wgmma_fence();
    issue_ss<T, D, NWG>(s, ks, qt);
    wgmma_commit();
    issue_ss<T, D, NWG>(dp, vs, ot);
    wgmma_commit();
    const bool masked =
        wk0 + 64 > a.SK || (a.causal && a.kv_off + wk0 + 63 > a.q_off + r0);
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + rcol + (i & 1);
      float p = exp2f(fmaf(s[i], c2, -ls[c]));
      if (masked) {
        const int key = ((i >> 1) & 1) ? key_b : key_a;
        if (key >= a.SK || (a.causal && a.q_off + r0 + c < a.kv_off + key))
          p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + rcol + (i & 1);
      dp[i] = s[i] * (dp[i] - dl[c]) * a.sm_scale;
    }
    pack_frag<T>(s, pf);
    pack_frag<T>(dp, dsf);
    // dV += P^T dO and dK += dS^T Q, the tile's dO and Q read MN-major
    wgmma_fence();
    issue_rs<T, D, NWG>(dv, pf, ot);
    issue_rs<T, D, NWG>(dk, dsf, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pf);
    fence_regs(dsf);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with it
  }
  // the group's sum over its query heads is in the registers
  T* gk = (T*)a.g0 + (long long)b * a.g0_sb + (long long)hk * a.g0_sh;
  T* gv = (T*)a.g1 + (long long)b * a.g1_sb + (long long)hk * a.g1_sh;
  store_rows<T, D>(dk, gk, a.g0_ss, key_a, rcol, a.SK);
  store_rows<T, D>(dv, gv, a.g1_ss, key_a, rcol, a.SK);
}

// SMs of each device, asked once
inline cudaError_t sm_count(int dev, int* out) {
  static int sms[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = sms[dev];
  return cudaSuccess;
}

// Host work per call is kept to the four tensor maps and the launch: the
// shared-memory limit is raised once per device and instantiation.
template <typename T, int D, int NWG, bool DKV>
cudaError_t launch_tc(const CUtensorMap (&m)[4], const TcBwdArgs& a, int B,
                      int dev, cudaStream_t stream) {
  constexpr int bytes =
      DKV ? TcBwdSmem<D, NWG, 2 * kTcTile * 4>::kBytes
          : TcBwdSmem<D, NWG, 0>::kBytes;
  auto kernel = DKV ? flash_bwd_dkv_wgmma_kernel<T, D, NWG>
                    : flash_bwd_dq_wgmma_kernel<T, D, NWG>;
  static unsigned long long raised = 0;  // bit d: done on device d
  if (!(raised >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  const int rows = DKV ? a.SK : a.SQ;
  const dim3 grid(DKV ? a.HK : a.HQ, B, (rows + NWG * 64 - 1) / (NWG * 64));
  kernel<<<grid, (NWG + 1) * 128, bytes, stream>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <typename T, bool DKV>
cudaError_t launch_tc_d(const CUtensorMap (&m)[4], const TcBwdArgs& a, int B,
                        int D, int nwg, int dev, cudaStream_t s) {
  if (D == 64)
    return nwg == 2 ? launch_tc<T, 64, 2, DKV>(m, a, B, dev, s)
                    : launch_tc<T, 64, 1, DKV>(m, a, B, dev, s);
  return nwg == 2 ? launch_tc<T, 128, 2, DKV>(m, a, B, dev, s)
                  : launch_tc<T, 128, 1, DKV>(m, a, B, dev, s);
}

// Both tensor-core kernels: checks, the tensor maps (q, k, v, dout; the
// resident operands' boxes NWG * 64 rows, the streamed ones' 64), the
// variant and the launch.
template <bool DKV>
int launch_tc_typed(int dtype, const void* const (&ptr)[4],
                    const long long (&st)[12], TcBwdArgs a, int B, int D,
                    void* stream) {
  if ((dtype != 1 && dtype != 2) || (D != 64 && D != 128) || a.SK <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return (int)err;
  // 128-row blocks unless they would leave part of the first wave idle
  const long long blocks128 = (long long)B * (DKV ? a.HK : a.HQ) *
                              (((DKV ? a.SK : a.SQ) + 127) / 128);
  const int nwg = blocks128 >= sms ? 2 : 1;
  const int res_rows = 64 * nwg;
  const CUtensorMapDataType dt = dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap m[4];
  int* order[4] = {&a.q_order, &a.k_order, &a.v_order, &a.o_order};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const bool q_side = i == 0 || i == 3;
    const bool resident = q_side != DKV;
    err = encode_rows_map(&m[i], dt, ptr[i], D, q_side ? a.SQ : a.SK,
                          q_side ? a.HQ : a.HK, B, st[3 * i + 2],
                          st[3 * i + 1], st[3 * i],
                          resident ? res_rows : kTcTile, order[i]);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? (int)launch_tc_d<__nv_bfloat16, DKV>(m, a, B, D, nwg, dev, s)
             : (int)launch_tc_d<__half, DKV>(m, a, B, D, nwg, dev, s);
}

}  // namespace

// Plain C interface, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. q, k, v, dout and the gradients are device pointers with unit
// stride along head_dim and the given element strides along batch, head and
// row (q, dout and dq [B, HQ, SQ, D]; k, v, dk and dv [B, HK, SK, D] in that
// index order); lse and delta are contiguous fp32 [B, HQ, SQ]. The Python
// wrapper checks shapes, types and devices. Each returns the cudaError_t of
// its shared-memory request and launch (cudaErrorInvalidValue for a dtype or
// head_dim it does not take).

// The scalar kernels: fp32 at head_dim 64, 128, 192, 256; bf16 and fp16 at
// 192 and 256.
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

// The tensor-core kernels: bf16 and fp16 at head_dim 64 and 128, the same
// arguments as the scalar ones. q, k, v and dout need a 16-byte-aligned
// base and strides of a multiple of 16 bytes (the TMA's rule; the wrapper
// copies what has not); dq, dk and dv a 4-byte-aligned base and even
// strides; SK >= 1.
extern "C" int ptt_flash_bwd_dq_wgmma(
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
  TcBwdArgs a{lse, delta, dq, nullptr, dq_sb, dq_sh, dq_ss, 0, 0, 0,
              HQ, HK, SQ, SK, q_off, kv_off, causal, sm_scale, 0, 0, 0, 0};
  const void* const ptr[4] = {q, k, v, dout};
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch_tc_typed<false>(dtype, ptr, st, a, B, D, stream);
}

extern "C" int ptt_flash_bwd_dkv_wgmma(
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
  TcBwdArgs a{lse, delta, dk, dv, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
              HQ, HK, SQ, SK, q_off, kv_off, causal, sm_scale, 0, 0, 0, 0};
  const void* const ptr[4] = {q, k, v, dout};
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  return launch_tc_typed<true>(dtype, ptr, st, a, B, D, stream);
}
