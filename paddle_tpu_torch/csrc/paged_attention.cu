// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends its context through a block table over KV pages.
//
// Replaces two Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py
// (grid (batch, kv_heads, pages_per_seq), the page axis sequential):
//   * _decode_kernel (:55, pallas_call :218), native pages (B4)
//   * _decode_kernel_quant (:97, pallas_call :175), int8 pages with one
//     fp32 scale per (kv head, page, slot) row (B5)
// Both compute, per (sequence, query head), softmax(q K^T * sm_scale) V
// over the positions below the sequence's context length (the others
// score -inf, the reference's constant), in fp32 whatever the input
// type, int8 values dequantised as code * scale before both dots, and
// write acc / max(l, 1e-30) in q's type.
//
// What bounds it on an H100: a decode step does ~4 flops per KV byte (one
// dot and one axpy per key for each of the group's query heads), far under
// the ~295 flops/byte where bf16 tensor cores become the limit, so the
// floor is the bytes of the K/V pages the contexts cover, read once at
// 3.35 TB/s. int8 pages halve those bytes against bf16 (plus 4 bytes of
// scale per 128-byte row): B5's floor is (d + 4) / 2d of B4's. At the
// serving shapes (8 sequences of 33-39 pages, 8 kv heads) those bytes are
// a few MB: the floor is microseconds, and what sets the time is latency,
// so the design keeps bytes in flight and the dependent chains short.
//
// Two variants, the wrapper choosing by rule (ops/paged_attention.py,
// decode_variant):
//
// "cluster", paged_decode_split_kernel<T, PT> (page size 16, D % 16 == 0,
// D <= 256, 16-byte aligned pools and scales):
//   * The context is split (flash-decoding) across S blocks per (sequence,
//     kv head), S from shapes alone on the host (never from context_lens,
//     which would cost a device-to-host sync). Pages go to splits in chunks
//     of two consecutive pages dealt round-robin (chunk k to split k mod
//     S), so every split of a long sequence has work whatever the table's
//     width. A split with no chunk leaves an empty state.
//   * The S blocks form one thread-block cluster. Each leaves its partial
//     (m, l, acc) in its own shared memory; after a cluster barrier every
//     block merges a slice of the outputs, reading all S partials through
//     distributed shared memory in split order (M = max m_s, L = sum l_s
//     e^(m_s - M), out = sum acc_s e^(m_s - M) / max(L, 1e-30), empty
//     splits skipped). One launch, no workspace, no atomics: two launches
//     give the same bits.
//   * Pages are staged raw: each K and V slab of a (kv head, page) (and an
//     int8 page's two scale rows) is one bulk copy (TMA) completing on the
//     chunk's mbarrier, issued a copy a lane by warp 0, into a ring of up
//     to 4 two-page chunks. The block's table entries are read once, at
//     the start, beside q and the context length. Values convert to fp32
//     at use (Staged, code_f32: int8 codes exactly, one scale per row).
//   * The chunks resident in the ring form a round (at the serving shapes
//     a split's whole share): the scores of each chunk as it lands, one
//     online-softmax update of each query row over the round (a warp a
//     row, a key a lane), one pass of acc = acc corr + w V, then the ring
//     refilled. A key's score is a lane-split dot: 8 columns a lane (q's
//     in registers), each lane dotting two keys with four query rows,
//     the 8 sums reduced over the key's lanes by a transposing butterfly
//     (8 shuffles where 8 plain reductions take 32). PV gives each
//     thread two columns of two rows, four chains over the round's keys.
//   Bit-identity with the ragged per-token kernel 8 (ROADMAP C21, which
//   covers kernels 6/8 and B7/B9 only) is not kept: the split, the merge
//   and the lane-split dots sum in another order than a row's single
//   recurrence. The plain-version rules bind it (1e-5 in fp32, one ulp of
//   the rounded fp32 plain version in bf16 and fp16).
//
// "block", paged_decode_kernel<T, PT> (every other shape): the parent
// design, one thread block per (sequence, kv head) holding the group of
// query heads that share the kv head, one page at a time staged in shared
// memory as fp32, scalar FMAs, the TPU grid's sequential page axis a loop
// inside the block that stops at ceil(ctx / P) pages.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// ------------------------------------------------------------ "block"

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
cudaError_t launch_block(const void* q, const Pages<PT>& pg, void* out,
                         const int* tables, const int* ctx, int B, int H,
                         int KVH, int D, int NP, int P, int pages_per_seq,
                         float sm_scale, cudaStream_t stream) {
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

// ---------------------------------------------------------- "cluster"

constexpr int kPage = 16;                  // the page size it takes
constexpr int kChunkPages = 2;             // consecutive pages dealt together
constexpr int kChunkKeys = kChunkPages * kPage;   // 32: a key a lane
constexpr int kMaxSplits = 8;              // the portable cluster size
constexpr int kMaxD = 256;                 // 8 columns a lane, 32 lanes a key
constexpr int kMaxStages = 4;
// Query rows, and keys, whose dot products a lane runs side by side.
constexpr int kRowTile = 4;
constexpr int kKeyTile = 2;
// The sums a lane holds before the reduction, and their log2.
constexpr int kSums = kKeyTile * kRowTile;
constexpr int kSumBits = 3;
static_assert(kSums == 1 << kSumBits, "a power of two of sums");
static_assert(kChunkPages * 4 <= 32, "one bulk copy a lane of warp 0");

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Dynamic shared memory of one split block, laid out as the top of
// paged_decode_split_kernel carves it: the stages' mbarriers, the ring of
// stages (each: kChunkPages K slabs, then kChunkPages V slabs of P x D
// values), the int8 scale rows of each stage (K then V, kChunkKeys each),
// q (G x D fp32, lane-interleaved), acc (G x D), a round's scores (G x
// stages x kChunkKeys), m, l and corr (G each), and the split's table
// entries (two per chunk the split can hold).
// ops/paged_attention.py:split_smem_bytes is the same formula.
__host__ __device__ inline size_t split_smem_bytes(int el, bool quant, int G,
                                                   int D, int pages_per_seq,
                                                   int splits, int stages) {
  const size_t slab = (size_t)kPage * D * el;
  const int chunks = (pages_per_seq + kChunkPages - 1) / kChunkPages;
  const int cap = kChunkPages * ((chunks + splits - 1) / splits);
  return round16(sizeof(uint64_t) * stages) +
         (size_t)stages * 2 * kChunkPages * slab +
         (quant ? (size_t)stages * 2 * kChunkKeys * sizeof(float) : 0) +
         ((size_t)2 * G * D + (size_t)G * stages * kChunkKeys +
          3 * (size_t)G) * sizeof(float) +
         (size_t)cap * sizeof(int);
}

// Eight values of a staged row from `p` (columns c0 .. c0 + 7), in fp32:
// one 16-byte load (bf16, fp16), two (fp32) or one 8-byte load of int8
// codes, each then times its row's scale.
template <typename PT>
__device__ __forceinline__ void row8(const unsigned char* p, float scale,
                                     float (&x)[8]) {
  Staged<PT>::cvt(*reinterpret_cast<const uint4*>(p), scale, x);
}
template <>
__device__ __forceinline__ void row8<float>(const unsigned char* p, float,
                                            float (&x)[8]) {
  Staged<float>::cvt(*reinterpret_cast<const uint4*>(p), 0.f, x);
  Staged<float>::cvt(*reinterpret_cast<const uint4*>(p + 16), 0.f, x + 4);
}
template <>
__device__ __forceinline__ void row8<int8_t>(const unsigned char* p,
                                             float scale, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t w0 = raw.x ^ 0x80808080u, w1 = raw.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = dequant(code_f32(w0, i), scale);
    x[4 + i] = dequant(code_f32(w1, i), scale);
  }
}

// Where column e of a query row goes in shared memory: lane t's eight
// columns 8t .. 8t + 7 as two float4s, the first halves of all lanes
// side by side, then the second halves, so that the lanes of a key read
// q without bank conflicts.
__device__ __forceinline__ int q_slot(int e, int D) {
  const int t = e >> 3, i = e & 7;
  return (i >> 2) * (D >> 1) + 4 * t + (i & 3);
}

// Grid (S, kv_heads, batch), clusters of (S, 1, 1): block s of a cluster
// is split s of sequence b's kv head h. tables [batch, pages_per_seq],
// ctx_lens [batch]. PT is the page type: T (B4) or int8_t (B5).
template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const Pages<PT> pg,
                          T* __restrict__ out, const int* __restrict__ tables,
                          const int* __restrict__ ctx_lens, int H, int KVH,
                          int D, int NP, int pages_per_seq, float sm_scale,
                          int stages) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int P = kPage;
  extern __shared__ __align__(16) unsigned char split_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, s = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  // the warp index and the context through a shuffle from lane 0: values
  // the compiler then knows to be the same across the warp
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const size_t row_bytes = (size_t)D * sizeof(PT);
  const size_t slab = (size_t)P * row_bytes;
  const size_t stage_bytes = 2 * kChunkPages * slab;

  const int tbl_chunks = (pages_per_seq + kChunkPages - 1) / kChunkPages;
  const int cap = kChunkPages * ((tbl_chunks + S - 1) / S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(split_smem);
  unsigned char* ring = split_smem + round16(sizeof(uint64_t) * stages);
  float* scl = reinterpret_cast<float*>(ring + stages * stage_bytes);
  float* qs = scl + (kQuant ? stages * 2 * kChunkKeys : 0);   // [G][D]
  float* acc = qs + (size_t)G * D;                            // [G][D]
  float* sw = acc + (size_t)G * D;                  // [G][stages * 32]
  float* m = sw + (size_t)G * stages * kChunkKeys;
  float* l = m + G;
  float* corr = l + G;
  int* pages = reinterpret_cast<int*>(corr + G);              // [cap]

  // The split's table entries (local page 2j + i is page 2 (s + S j) + i),
  // its context, q and the empty state, all loads in flight together.
  const int* trow = tables + (size_t)b * pages_per_seq;
  for (int i = tid; i < cap; i += kThreads) {
    const int p = kChunkPages * (s + S * (i / kChunkPages)) + i % kChunkPages;
    pages[i] = p < pages_per_seq ? trow[p] : 0;
  }
  const int ctx = __shfl_sync(0xffffffffu, ctx_lens[b], 0);
  const int n_pages = min((ctx + P - 1) / P, pages_per_seq);
  const int limit = min(ctx, n_pages * P);       // keys below it are live
  const int n_chunks = (n_pages + kChunkPages - 1) / kChunkPages;
  const int mine = s < n_chunks ? (n_chunks - s + S - 1) / S : 0;
  const T* qrow = q + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int r = i / D, e = i - r * D;
    qs[r * D + q_slot(e, D)] = to_f32(qrow[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < G; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Warp 0: stage local chunk j (its one or two live pages) into buffer
  // j % stages, one bulk copy a lane (K and V slabs, int8 scale rows), the
  // barrier's one arrival with the chunk's bytes from lane 0. A copy may
  // land before that arrival: the phase cannot complete without it.
  auto issue = [&](int j) {
    const int st = j % stages;
    unsigned char* buf = ring + st * stage_bytes;
    float* sbuf = scl + st * 2 * kChunkKeys;
    const int first = kChunkPages * (s + S * j);
    const int cnt = min(kChunkPages, n_pages - first);
    if (lane == 0)
      mbar_expect_tx(bars + st,
                     cnt * (2 * (uint32_t)slab + (kQuant ? 2 * P * 4 : 0)));
    const int i = lane >> 2, what = lane & 3;   // page, piece
    if (i < cnt && (what < 2 || kQuant)) {
      const size_t page0 = ((size_t)h * NP + pages[kChunkPages * j + i]) * P;
      if (what == 0)
        bulk_copy(buf + i * slab, pg.k + page0 * D, (uint32_t)slab, bars + st);
      else if (what == 1)
        bulk_copy(buf + (kChunkPages + i) * slab, pg.v + page0 * D,
                  (uint32_t)slab, bars + st);
      else if (what == 2)
        bulk_copy(sbuf + i * P, pg.ks + page0, P * 4, bars + st);
      else
        bulk_copy(sbuf + kChunkKeys + i * P, pg.vs + page0, P * 4, bars + st);
    }
  };
  if (warp == 0)
    for (int j = 0; j < min(stages, mine); ++j) issue(j);

  // lanes a key: the power of two, at least kSums, that covers D / 8 lanes
  // of 8 columns; a warp holds 32 / lk keys side by side, the block kWarps
  // times that
  int lk = kSums;
  while (lk * 8 < D) lk <<= 1;
  const int per_warp = 32 / lk, grp = lane / lk, t = lane % lk;
  const int stride = kWarps * per_warp;
  const bool col_live = t * 8 < D;
  // after the transposing reduction below, lane t holds the sum of value
  // `vt` of its key's lanes (reduction round r adds kSums >> r where the
  // lane's bit lk >> r is set); one lane of each such group writes it
  int vt = 0;
#pragma unroll
  for (int round = 1; round <= kSumBits; ++round)
    vt += (t & (lk >> round)) ? kSums >> round : 0;
  const bool writer = (t & ((lk >> kSumBits) - 1)) == 0;
  const int sw_stride = stages * kChunkKeys;     // a row of sw: one round
  // live keys of local chunk j
  auto keys_of = [&](int j) {
    return min(kChunkKeys, limit - kChunkPages * (s + S * j) * P);
  };

  // Rounds of up to `stages` chunks, all resident in the ring: the scores
  // of every chunk as it lands, one online-softmax update over the round,
  // one pass of acc = acc corr + w V, then the ring refilled.
  for (int j0 = 0; j0 < mine; j0 += stages) {
    const int nr = min(stages, mine - j0);

    // scores: a lane's 8 columns of kRowTile query rows stay in registers
    // while it dots kKeyTile keys with them; the kSums partial sums (key
    // u, row k at u * kRowTile + k) are reduced over the key's lanes by a
    // transposing butterfly: each of the first kSumBits rounds sends half
    // of the sums the lane still holds and keeps the other half, any
    // further round is a plain xor
    for (int r0 = 0; r0 < G; r0 += kRowTile) {
      float qv[kRowTile][8];
#pragma unroll
      for (int k = 0; k < kRowTile; ++k) {
        if (r0 + k < G && col_live) {
          const float* qr = qs + (r0 + k) * D;
          const float4 a = *reinterpret_cast<const float4*>(qr + 4 * t);
          const float4 c =
              *reinterpret_cast<const float4*>(qr + (D >> 1) + 4 * t);
          qv[k][0] = a.x; qv[k][1] = a.y; qv[k][2] = a.z; qv[k][3] = a.w;
          qv[k][4] = c.x; qv[k][5] = c.y; qv[k][6] = c.z; qv[k][7] = c.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) qv[k][i] = 0.f;
        }
      }
      for (int jj = 0; jj < nr; ++jj) {
        const int j = j0 + jj, st = j % stages, nk = keys_of(j);
        // returns at once for a row group after the first
        mbar_wait(bars + st, (j / stages) & 1);
        const unsigned char* kbuf = ring + st * stage_bytes;
        const float* sbuf = scl + st * 2 * kChunkKeys;
#pragma unroll 2
        for (int c0 = warp * per_warp; c0 < nk; c0 += kKeyTile * stride) {
          float d[kSums];
#pragma unroll
          for (int u = 0; u < kKeyTile; ++u) {
            const int c = c0 + grp + u * stride;
            float kv[8];
            if (c < nk && col_live) {
              row8<PT>(kbuf + c * row_bytes + t * 8 * sizeof(PT),
                       kQuant ? sbuf[c] : 0.f, kv);
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) kv[i] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < kRowTile; ++k) {
              float dot = 0.f;
#pragma unroll
              for (int i = 0; i < 8; ++i) dot = fmaf(qv[k][i], kv[i], dot);
              d[u * kRowTile + k] = dot;
            }
          }
#pragma unroll
          for (int n = kSums / 2, round = 1; n > 0; n >>= 1, ++round) {
            const bool hi = t & (lk >> round);
#pragma unroll
            for (int i = 0; i < n; ++i) {
              const float send = hi ? d[i] : d[i + n];
              const float keep = hi ? d[i + n] : d[i];
              d[i] = keep + __shfl_xor_sync(0xffffffffu, send, lk >> round);
            }
          }
          for (int o = lk >> (kSumBits + 1); o > 0; o >>= 1)
            d[0] += __shfl_xor_sync(0xffffffffu, d[0], o);
          const int c = c0 + grp + (vt / kRowTile) * stride;
          const int r = r0 + vt % kRowTile;
          if (writer && c < nk && r < G)
            sw[r * sw_stride + jj * kChunkKeys + c] = score_of(d[0], sm_scale);
        }
      }
    }
    __syncthreads();

    // the online-softmax update of each query row over the round: one
    // warp, the round's keys lane, lane + 32, ...
    for (int r = warp; r < G; r += kWarps) {
      float* swr = sw + r * sw_stride;
      float sv[kMaxStages];
      float mc = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kMaxStages; ++jj) {
        sv[jj] = jj < nr && lane < keys_of(j0 + jj)
                     ? swr[jj * kChunkKeys + lane] : -INFINITY;
        mc = fmaxf(mc, sv[jj]);
      }
      for (int o = 16; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mc);      // finite: a key is live
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kMaxStages; ++jj) {
        if (jj < nr) {
          const float w = sv[jj] == -INFINITY ? 0.f : weight_of(sv[jj], m_new);
          swr[jj * kChunkKeys + lane] = w;
          sum += w;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float cr = rescale(m_prev, m_new);
        corr[r] = cr;
        l[r] = l_update(l[r], cr, sum);
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc corr + w V over the round's keys: a thread takes two
    // columns of two rows, four chains, eight keys' loads issued together
    const int half = D >> 1;
    for (int i = tid; i < half * ((G + 1) >> 1); i += kThreads) {
      const int r0 = 2 * (i / half), e = 2 * (i % half);
      const bool two = r0 + 1 < G;
      float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
      for (int jj = 0; jj < nr; ++jj) {
        const int j = j0 + jj, st = j % stages, nk = keys_of(j);
        const unsigned char* vbuf =
            ring + st * stage_bytes + kChunkPages * slab;
        const float* vsc = scl + st * 2 * kChunkKeys + kChunkKeys;
        const float* w0 = sw + r0 * sw_stride + jj * kChunkKeys;
        const float* w1 = two ? w0 + sw_stride : w0;
        int c = 0;
        for (; c + 8 <= nk; c += 8) {
          const float4 a0 = *reinterpret_cast<const float4*>(w0 + c);
          const float4 a1 = *reinterpret_cast<const float4*>(w0 + c + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(w1 + c);
          const float4 b1 = *reinterpret_cast<const float4*>(w1 + c + 4);
          const float wa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float wb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          float v[8][2];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            staged2<PT>(vbuf + (c + u) * row_bytes, e,
                        kQuant ? vsc[c + u] : 0.f, v[u]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            p00 = fmaf(wa[u], v[u][0], p00);
            p01 = fmaf(wa[u], v[u][1], p01);
            p10 = fmaf(wb[u], v[u][0], p10);
            p11 = fmaf(wb[u], v[u][1], p11);
          }
        }
        for (; c < nk; ++c) {
          float v[2];
          staged2<PT>(vbuf + c * row_bytes, e, kQuant ? vsc[c] : 0.f, v);
          p00 = fmaf(w0[c], v[0], p00);
          p01 = fmaf(w0[c], v[1], p01);
          p10 = fmaf(w1[c], v[0], p10);
          p11 = fmaf(w1[c], v[1], p11);
        }
      }
      float2* a0 = reinterpret_cast<float2*>(acc + r0 * D + e);
      const float c0 = corr[r0];
      float2 av = *a0;
      av.x = acc_update(av.x, c0, p00);
      av.y = acc_update(av.y, c0, p01);
      *a0 = av;
      if (two) {
        float2* a1 = reinterpret_cast<float2*>(acc + (r0 + 1) * D + e);
        const float c1 = corr[r0 + 1];
        av = *a1;
        av.x = acc_update(av.x, c1, p10);
        av.y = acc_update(av.y, c1, p11);
        *a1 = av;
      }
    }
    __syncthreads();
    // every thread is done with the round's buffers: refill them (the
    // barrier orders the reads before the copies, as in CUTLASS's TMA
    // pipelines)
    if (warp == 0)
      for (int jj = 0; jj < nr; ++jj)
        if (j0 + stages + jj < mine) issue(j0 + stages + jj);
  }

  // Merge: after every split's partial is in its shared memory, block s
  // finishes its slice of the G x D outputs from all S partials, in split
  // order, skipping empty splits.
  cluster.sync();
  const int n = G * D, per = (n + S - 1) / S;
  const int lo = s * per, hi = min(n, lo + per);
  T* orow = out + ((size_t)b * H + (size_t)h * G) * D;
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int r = i / D;
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
    float M = -INFINITY;
#pragma unroll
    for (int u = 0; u < kMaxSplits; ++u) {
      if (u < S) {
        ms[u] = cluster.map_shared_rank(m, u)[r];
        ls[u] = cluster.map_shared_rank(l, u)[r];
        as[u] = cluster.map_shared_rank(acc, u)[i];
        M = fmaxf(M, ms[u]);
      }
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxSplits; ++u) {
      if (u < S && ms[u] != -INFINITY) {
        const float f = rescale(ms[u], M);
        L = fmaf(ls[u], f, L);
        A = fmaf(as[u], f, A);
      }
    }
    orow[i] = from_f32<T>(finish(A, L));
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T, typename PT>
cudaError_t launch_split(const void* q, const Pages<PT>& pg, void* out,
                         const int* tables, const int* ctx, int B, int H,
                         int KVH, int D, int NP, int P, int pages_per_seq,
                         float sm_scale, int splits, int stages,
                         cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  if (P != kPage || D % 16 || D > kMaxD || splits < 1 ||
      splits > kMaxSplits || stages < 1 || stages > kMaxStages ||
      H % KVH || pages_per_seq < 1)
    return cudaErrorInvalidValue;
  const size_t smem = split_smem_bytes(sizeof(PT), kQuant, H / KVH, D,
                                       pages_per_seq, splits, stages);
  auto kernel = paged_decode_split_kernel<T, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, pg, (T*)out, tables, ctx,
                           H, KVH, D, NP, pages_per_seq, sm_scale, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. dtype (of q and out): 0 float32,
// 1 bfloat16, 2 float16; the native-page functions also take 3 (bfloat16
// q and out over float32 pages) and 4 (float16 over float32), the pools
// of a 16-bit model under AMP's O2. Every pointer is a device pointer of a
// contiguous tensor; the Python wrapper checks shapes, types and devices
// and picks the variant. Returns the cudaError_t of the launch (0 on
// success).
extern "C" {

// "block": kp/vp [KVH, NP, P, D] of q's type (float32 for codes 3, 4).
int ptt_paged_decode(int dtype, const void* q, const void* kp, const void* vp,
                     void* out, const int* tables, const int* ctx_lens, int B,
                     int H, int KVH, int D, int NP, int P, int pages_per_seq,
                     float sm_scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_block<float>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch_block<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch_block<__half>(q, native_pages<__half>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 3: return (int)launch_block<__nv_bfloat16>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 4: return (int)launch_block<__half>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// "block" over int8 pages: kp/vp int8 [KVH, NP, P, D], ks/vs float32
// [KVH, NP, P].
int ptt_paged_decode_q8(int dtype, const void* q, const void* kp,
                        const void* vp, const float* ks, const float* vs,
                        void* out, const int* tables, const int* ctx_lens,
                        int B, int H, int KVH, int D, int NP, int P,
                        int pages_per_seq, float sm_scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_block<float>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 1: return (int)launch_block<__nv_bfloat16>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 2: return (int)launch_block<__half>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// "cluster": the operands of ptt_paged_decode, then the splits S (1..8)
// and the ring's stages (1..4).
int ptt_paged_decode_split(int dtype, const void* q, const void* kp,
                           const void* vp, void* out, const int* tables,
                           const int* ctx_lens, int B, int H, int KVH, int D,
                           int NP, int P, int pages_per_seq, float sm_scale,
                           int splits, int stages, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_split<float>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 1: return (int)launch_split<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 2: return (int)launch_split<__half>(q, native_pages<__half>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 3: return (int)launch_split<__nv_bfloat16>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 4: return (int)launch_split<__half>(q, native_pages<float>(kp, vp), out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// "cluster" over int8 pages: the operands of ptt_paged_decode_q8, then the
// splits and stages.
int ptt_paged_decode_split_q8(int dtype, const void* q, const void* kp,
                              const void* vp, const float* ks,
                              const float* vs, void* out, const int* tables,
                              const int* ctx_lens, int B, int H, int KVH,
                              int D, int NP, int P, int pages_per_seq,
                              float sm_scale, int splits, int stages,
                              void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_split<float>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 1: return (int)launch_split<__nv_bfloat16>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    case 2: return (int)launch_split<__half>(q, pg, out, tables, ctx_lens, B, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one "cluster" block (the wrapper's rule
// computes the same in Python; chip_smoke.py holds the two equal).
int ptt_paged_decode_split_smem(int el, int quant, int G, int D,
                                int pages_per_seq, int splits, int stages) {
  return (int)split_smem_bytes(el, quant != 0, G, D, pages_per_seq, splits,
                               stages);
}

}  // extern "C"
