// Flash attention forward for Hopper (sm_90a): exact softmax attention
// over dense Q, K, V without materialising the score matrix, returning
// the output and the per-row log-sum-exp. Two hand-written kernels:
// flash_fwd_wgmma_kernel (tensor cores; bf16 and fp16 at head_dim 64 and
// 128) and flash_fwd_kernel (scalar fp32; fp32 at every head_dim, bf16 and
// fp16 at 192 and 256). ops/flash_attention.py:fwd_variant picks one.
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
// Which keys a row visits is the reference's, not this file's tiling:
// the reference runs a (128-row, 128-key) tile iff its last query can see
// its first key, so a row visits every key of the reference tiles up to
// the last one its reference q-block runs (padded keys past sk included).
// A row with no valid key then gets p = exp(-1e30 - -1e30) = 1 on every
// visited key, and its output is the mean of V over them, not zero. Both
// kernels reproduce that: keys past the row's reference range score -inf
// (weight exactly 0, whatever m is), keys inside it that are masked score
// -1e30. When no row of a block is dead, keys past the last row's causal
// limit are skipped outright: once key 0 has made m a real score, a -1e30
// key adds exp(-1e30 - m) = 0 and corrects by exp(0) = 1, so stopping
// there changes no bit. The mask is applied after sm_scale, and m is
// subtracted before any log2(e) factor, so a dead row still gets exp(0).
//
// What bounds it on an H100: a causal prefill of s tokens does on average
// 2 s d flops per query row (two dots of width d for each of ~s/2 visible
// keys) against ~5 d bytes of q, out and its share of K/V in bf16. At
// s = 512, d = 128 with four query heads per kv head that is ~200
// flops/byte, near the ~295 where bf16 tensor cores become the limit; at
// s = 2048 (training) the FLOP floor (989 TFLOP/s) bounds it.
//
// flash_fwd_wgmma_kernel: one block owns BQ = 64 NWG query rows of one
// (batch, query head) and walks key tiles of 128, which for sq, sk >= 128
// are the reference's own tiles, so only the diagonal and the ragged last
// tile need per-element masks. NWG consumer warpgroups (64 rows each) and
// one producer warpgroup, whose first thread issues TMA copies (Q once; K
// and V through a three-stage ring with full/empty mbarriers) from the
// tensors as the wrapper gets them, [b, s, h, d] views with element
// strides or the kernel layout, into 128-byte-swizzled shared memory;
// TMA's zero fill covers rows past sq and keys past sk. With two consumer
// warpgroups the producer hands its registers over (setmaxnreg: 24 a
// thread for it, 240 for the consumers, against 168 for all at launch).
// Each consumer warpgroup computes
// S = Q K^T with wgmma m64n128k16 (both operands K-major in shared
// memory, fp32 accumulators), runs the online softmax on the accumulator
// registers (a row lives in one quad: shuffles xor 1, 2), rounds P to
// q's type in registers and feeds it as the register A operand of
// m64n{D}k16 with V as an MN-major B operand. l sums the fp32 p, as the
// reference does. Rounding P before P.V is a departure from the
// reference, which dots in fp32 (ROADMAP C15): each weight moves by at
// most u (2^-8 in bf16, 2^-11 in fp16) of itself, so out moves by at most
// u max|V|; lse does not see it. Inside a warpgroup, tile j's P V runs
// on the tensor cores while tile j + 1's scores (issued just before it)
// are turned into weights. Q-blocks run heaviest first under causal
// masking; the host takes 64-row blocks (NWG = 1) when 128-row blocks
// would not fill one wave of the card. What it leaves on the table, for
// later work: ordering the two warpgroups' softmax phases, TMA stores of
// out, a persistent grid.
//
// flash_fwd_kernel, the simple kernel that was right first: one block of
// 256 threads holds 64 query rows; each thread owns a 4 x 4 tile of
// scores and a 4 x D/16 tile of the output in registers; K and V tiles of
// 64 keys are staged in shared memory as fp32 and both products run as
// scalar fp32 FMAs (bounded by shared-memory loads and the fp32 pipes).
// It keeps fp32 exact to the reference (1e-5, ROADMAP C1), which TF32
// tensor cores could not.

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF

// End (exclusive, local key index) of the keys the reference visits for
// query row `row`: all of its q-block's tiles that run.
template <typename A>
__device__ __forceinline__ int ref_kv_end(int row, const A& a) {
  if (!a.causal) return a.kv_blocks_ref * a.bk_ref;
  const int last_q = a.q_off + (row / a.bq_ref) * a.bq_ref + a.bq_ref - 1;
  const int span = last_q - a.kv_off;   // tile j runs iff j * bk_ref <= span
  if (span < 0) return 0;
  return min(span / a.bk_ref + 1, a.kv_blocks_ref) * a.bk_ref;
}

// Keys a block of `rows` query rows from q0 must walk: its last row's
// reference range (rows' ranges grow with the row), cut at the last row's
// causal limit when no row of the block is dead.
template <typename A>
__device__ __forceinline__ int block_kv_end(int q0, int rows, const A& a) {
  const int last = min(q0 + rows, a.SQ) - 1;
  int n_keys = ref_kv_end(last, a);
  if (a.causal && a.q_off + q0 >= a.kv_off)
    n_keys = min(n_keys, a.q_off + last - a.kv_off + 1);
  return n_keys;
}

// ------------------------------------------------- scalar fp32 kernel

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16

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
  const int n_keys = block_kv_end(q0, kBQ, a);

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

// The instantiations the dispatch sends here: fp32 at every head_dim,
// bf16 and fp16 only where the tensor-core kernel has none (192, 256).
template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 192: return launch<T, 192>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float>(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<float, 64>(a, B, stream);
    case 128: return launch<float, 128>(a, B, stream);
    case 192: return launch<float, 192>(a, B, stream);
    case 256: return launch<float, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------- tensor-core kernel

constexpr int kTileK = 128;        // keys per tile
constexpr int kStages = 3;         // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  void* out;
  float* lse;                      // [B, HQ, SQ]
  long long o_sb, o_sh, o_ss;      // element strides of out
  int HQ, HK, SQ, SK;
  int q_off, kv_off, causal;
  int bq_ref, bk_ref, kv_blocks_ref;  // the reference's tiling
  float sm_scale;
  int q_order, k_order, v_order;   // axis orders of the tensor maps
};

// Shared memory of one block, in bytes from a 1024-aligned base: Q (D/64
// boxes of BQ rows), the K and V rings (D/64 boxes of 128 rows a stage),
// then the barriers.
template <int D, int NWG>
struct TcSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = NWG * 64 * 128;
  static constexpr int kKVBox = kTileK * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKV = kBoxes * kKVBox;   // one stage of K (or V)
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;  // full_q, full_k/v, empty
  static constexpr int kBytes = kBars + (1 + 3 * kStages) * 8 + 1024;  // + slack
};

// The online-softmax step of one tile on the S accumulators of a
// warpgroup (register i holds row b iff bit 1 of i is set): scale, mask,
// new row maxima over the quad that owns a row (shuffles xor 1, 2),
// p = exp(s - m) in place, the per-thread partial l, and the corrections
// c_a, c_b that the output still has to take.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], const TcArgs& a, int k0, bool masked, int row_a,
    int row_b, int kcol, int row_end, float& m_a, float& m_b, float& l_a,
    float& l_b, float& c_a, float& c_b) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const bool rb = (i >> 1) & 1;
    float sc = s[i] * a.sm_scale;
    if (masked) {
      const int key = k0 + 8 * (i / 4) + kcol + (i & 1);
      if (key >= row_end)
        sc = -INFINITY;  // a tile the reference never runs for this row
      else if (key >= a.SK ||
               (a.causal && a.q_off + (rb ? row_b : row_a) < a.kv_off + key))
        sc = kNegInf;
    }
    s[i] = sc;
    if (rb) mx_b = fmaxf(mx_b, sc);
    else mx_a = fmaxf(mx_a, sc);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  c_a = exp2f((m_a - mn_a) * kLog2e);
  c_b = exp2f((m_b - mn_b) * kLog2e);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const bool rb = (i >> 1) & 1;
    const float p = exp2f((s[i] - (rb ? mn_b : mn_a)) * kLog2e);
    s[i] = p;
    if (rb) sum_b += p;
    else sum_a += p;
  }
  // per-thread partial sums; the quad's are added in the epilogue
  l_a = l_a * c_a + sum_a;
  l_b = l_b * c_b + sum_b;
}

// P in the kernel's type, as the A fragments of eight k16 steps over the
// tile's keys: fragment kk takes accumulator registers 8 kk .. 8 kk + 7.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = Wgmma<T>::pack(s[2 * i], s[2 * i + 1]);
}

template <typename T, int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const TcArgs a) {
  using L = TcSmem<D, NWG>;
  constexpr int BQ = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest q-blocks first under causal masking
  const int qb = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qb * BQ;
  const int hk = h / (a.HQ / a.HK);
  const int n_tiles = (block_kv_end(q0, BQ, a) + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, NWG * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NWG * 4) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread issues every copy
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (threadIdx.x == NWG * 128 && n_tiles > 0) {
      mbar_expect_tx(full_q, L::kQ);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_rows(smem + c * L::kQBox, &tm_q, full_q, 64 * c, q0, h, b,
                      a.q_order);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
        uint8_t* ks = smem + L::kK + st * L::kKV;
        uint8_t* vs = smem + L::kV + st * L::kKV;
        mbar_expect_tx(full_k + st, L::kKV);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_rows(ks + c * L::kKVBox, &tm_k, full_k + st, 64 * c,
                        j * kTileK, hk, b, a.k_order);
        mbar_expect_tx(full_v + st, L::kKV);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_rows(vs + c * L::kKVBox, &tm_v, full_v + st, 64 * c,
                        j * kTileK, hk, b, a.v_order);
      }
    }
  } else {
    if constexpr (NWG == 2) reg_alloc<240>();
    // consumers: warpgroup wg owns rows wrow0 .. wrow0 + 63; this thread
    // rows row_a and row_a + 8, columns kcol + {0, 1} of every 8
    const int wg = warp / 4;
    const int wrow0 = q0 + wg * 64;
    const int row_a = wrow0 + (warp % 4) * 16 + lane / 4, row_b = row_a + 8;
    const int kcol = 2 * (lane % 4);
    // every row of the block lies in one reference q-block (the host
    // sizes BQ so), hence one reference key range
    const int row_end = ref_kv_end(q0, a);
    const uint8_t* qs = smem + wg * 64 * 128;
    // per-element masks only where a key may be invalid for some row
    auto masked = [&](int k0) {
      return k0 + kTileK > min(a.SK, row_end) ||
             (a.causal && a.kv_off + k0 + kTileK - 1 > a.q_off + wrow0);
    };
    // S = Q K^T of stage st: D / 16 steps of k16, 32 bytes apart inside a
    // 128-byte swizzled row, the next 64-column box after four
    auto issue_qk = [&](float (&s)[64], int st) {
      const uint8_t* ks = smem + L::kK + st * L::kKV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        Wgmma<T>::ss128(s, smem_desc(qs + (kk / 4) * L::kQBox + off, 16, 1024),
                        smem_desc(ks + (kk / 4) * L::kKVBox + off, 16, 1024),
                        kk);
      }
      wgmma_commit();
    };

    // O += P V of stage st: V MN-major, 16 keys (2048 bytes) a step, its
    // 64-column boxes kKVBox apart
    auto issue_pv = [&](float (&o)[D / 2], uint32_t (&p)[32], int st) {
      const uint8_t* vs = smem + L::kV + st * L::kKV;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        Wgmma<T>::rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                     smem_desc(vs + kk * 2048, L::kKVBox, 1024), 1);
      wgmma_commit();
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[64];
    uint32_t p[32];
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    float c_a, c_b;
    if (n_tiles > 0) {
      mbar_wait(full_q, 0);
      mbar_wait(full_k, 0);
      wgmma_fence();
      issue_qk(s, 0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, a, 0, masked(0), row_a, row_b, kcol, row_end, m_a, m_b,
                   l_a, l_b, c_a, c_b);
      pack_p<T>(s, p);
      // tile j's P V runs while tile j + 1's scores, issued just before
      // it, are turned into weights; those become the A fragments only
      // once P V is done with the registers. The last tile's P V is
      // peeled off so that no product sits in a branch.
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int st = j % kStages, st1 = (j + 1) % kStages;
        mbar_wait(full_k + st1, ((j + 1) / kStages) & 1);
        mbar_wait(full_v + st, (j / kStages) & 1);
        wgmma_fence();
        issue_qk(s, st1);
        issue_pv(o, p, st);
        wgmma_wait<1>();  // the scores; P V may still run
        fence_regs(s);
        const int k1 = (j + 1) * kTileK;
        softmax_tile(s, a, k1, masked(k1), row_a, row_b, kcol, row_end, m_a,
                     m_b, l_a, l_b, c_a, c_b);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(empty + st);  // this warp is done with it
        pack_p<T>(s, p);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= ((i >> 1) & 1) ? c_b : c_a;
      }
      const int jl = n_tiles - 1;
      mbar_wait(full_v + jl % kStages, (jl / kStages) & 1);
      wgmma_fence();
      issue_pv(o, p, jl % kStages);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    T* out = (T*)a.out + (long long)b * a.o_sb + (long long)h * a.o_sh;
    T* out_a = out + (long long)row_a * a.o_ss + kcol;
    T* out_b = out + (long long)row_b * a.o_ss + kcol;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if (row_a < a.SQ)
        *reinterpret_cast<uint32_t*>(out_a + 8 * jj) =
            Wgmma<T>::pack(o[4 * jj] / den_a, o[4 * jj + 1] / den_a);
      if (row_b < a.SQ)
        *reinterpret_cast<uint32_t*>(out_b + 8 * jj) =
            Wgmma<T>::pack(o[4 * jj + 2] / den_b, o[4 * jj + 3] / den_b);
    }
    if (lane % 4 == 0) {
      float* lse = a.lse + ((long long)b * a.HQ + h) * a.SQ;
      if (row_a < a.SQ) lse[row_a] = l_a <= 1e-30f ? kNegInf : m_a + logf(den_a);
      if (row_b < a.SQ) lse[row_b] = l_b <= 1e-30f ? kNegInf : m_b + logf(den_b);
    }
  }
}

// Host work per call is kept to the three tensor maps and the launch:
// the shared-memory limit is raised once per device and instantiation.
template <typename T, int D, int NWG>
cudaError_t launch_tc(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const TcArgs& a, int B, int dev,
                      cudaStream_t stream) {
  constexpr int bytes = TcSmem<D, NWG>::kBytes;
  static unsigned long long raised = 0;  // bit d: done on device d
  if (!(raised >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<T, D, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  const dim3 grid(a.HQ, B, (a.SQ + NWG * 64 - 1) / (NWG * 64));
  flash_fwd_wgmma_kernel<T, D, NWG>
      <<<grid, (NWG + 1) * 128, bytes, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_d(const CUtensorMap& mq, const CUtensorMap& mk,
                        const CUtensorMap& mv, const TcArgs& a, int B, int D,
                        int nwg, int dev, cudaStream_t stream) {
  if (D == 64)
    return nwg == 2 ? launch_tc<T, 64, 2>(mq, mk, mv, a, B, dev, stream)
                    : launch_tc<T, 64, 1>(mq, mk, mv, a, B, dev, stream);
  return nwg == 2 ? launch_tc<T, 128, 2>(mq, mk, mv, a, B, dev, stream)
                  : launch_tc<T, 128, 1>(mq, mk, mv, a, B, dev, stream);
}

}  // namespace

// Plain C interface, bound with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16. q, k, v and out are device pointers with unit stride along
// head_dim and the given element strides along batch, head and row; lse
// is a contiguous fp32 [B, HQ, SQ]. bq_ref / bk_ref are the reference's
// block sizes for these lengths (min(128, max(s, 8))). The Python wrapper
// checks shapes, types and devices. Each returns the cudaError_t of its
// launch (cudaErrorInvalidValue for a dtype or head_dim it does not take).

// The scalar kernel: fp32 at head_dim 64, 128, 192, 256; bf16 and fp16
// at 192 and 256.
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

// The tensor-core kernel: bf16 and fp16 at head_dim 64 and 128. q, k and
// v need a 16-byte-aligned base and strides of a multiple of 16 bytes
// (the TMA's rule; the wrapper copies what has not), and SK >= 1.
extern "C" int ptt_flash_fwd_wgmma(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* lse, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int B, int HQ, int HK, int SQ, int SK, int D, int q_off,
    int kv_off, int causal, int bq_ref, int bk_ref, float sm_scale,
    void* stream) {
  if (B <= 0 || SQ <= 0 || HQ <= 0) return (int)cudaSuccess;
  if ((dtype != 1 && dtype != 2) || (D != 64 && D != 128) || SK <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  static int sms[64];  // SMs of each device, 0 until asked
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // 128-row blocks unless they would leave part of the first wave idle
  const int nwg = (long long)B * HQ * ((SQ + 127) / 128) >= sms[dev] ? 2 : 1;
  // a block must lie inside one reference q-block (one key range)
  if (SQ > bq_ref && bq_ref % (64 * nwg) != 0) return (int)cudaErrorInvalidValue;
  TcArgs a{out, lse, o_sb, o_sh, o_ss, HQ, HK, SQ, SK, q_off, kv_off, causal,
           bq_ref, bk_ref, (SK + bk_ref - 1) / bk_ref, sm_scale, 0, 0, 0};
  const CUtensorMapDataType dt = dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  err = encode_rows_map(&mq, dt, q, D, SQ, HQ, B, q_ss, q_sh, q_sb, 64 * nwg,
                        &a.q_order);
  if (err == cudaSuccess)
    err = encode_rows_map(&mk, dt, k, D, SK, HK, B, k_ss, k_sh, k_sb, kTileK,
                          &a.k_order);
  if (err == cudaSuccess)
    err = encode_rows_map(&mv, dt, v, D, SK, HK, B, v_ss, v_sh, v_sb, kTileK,
                          &a.v_order);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? (int)launch_tc_d<__nv_bfloat16>(mq, mk, mv, a, B, D, nwg, dev, s)
             : (int)launch_tc_d<__half>(mq, mk, mv, a, B, D, nwg, dev, s);
}
