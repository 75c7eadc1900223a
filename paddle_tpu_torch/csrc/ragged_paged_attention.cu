// Ragged paged attention for Hopper (sm_90a): a tick's mixed prefill and
// decode tokens attend their own context through the shared KV page pool.
//
// Replaces the four Pallas TPU kernels of
// paddle_tpu/ops/pallas/ragged_paged_attention.py:
//   * _qblock_kernel (:215, grid (q_blocks, kv_heads, jobs))
//       -> qblock_unit_kernel<T, T, kP>  (kernel 6 "unit", pages of 4, 8,
//                                         16 and 32, ptt_ragged_qblock_p<kP>
//                                         in qblock_unit_p<kP>.cu)
//          qblock_runtime_kernel<T, T>   (kernel 6 "runtime", every other
//                                         shape, ptt_ragged_qblock_rt in
//                                         qblock_runtime.cu)
//   * _qblock_kernel_quant (:258, same call :374 with two scale operands)
//       -> qblock_unit_kernel<T, int8_t, kP> (B7 "unit",
//                                         ptt_ragged_qblock_p<kP>_q8)
//          qblock_runtime_kernel<T, int8_t> (B7 "runtime",
//                                         ptt_ragged_qblock_rt_q8)
// The q-block kernels live in qblock.cuh, built by translation units of
// their own (nvcc compiles them side by side); this file holds the
// per-token kernels, which share qblock.cuh's `dots`.
//   * _ragged_kernel (:389, grid (tokens, kv_heads, pages))
//       -> token_split_kernel<T, T, 16>  (kernel 8 "cluster",
//                                         ptt_ragged_token_split)
//          token_kernel<T, T>            (kernel 8 "block", ptt_ragged_token)
//   * _ragged_kernel_quant (:431, call :510)
//       -> token_split_kernel<T, int8_t, 16> (B9 "cluster",
//                                         ptt_ragged_token_split_q8)
//          token_kernel<T, int8_t>       (B9 "block", ptt_ragged_token_q8)
// The int8 variants take pages of int8 codes with one fp32 scale per
// (kv head, page, slot) row and dequantise each value (int8 * scale, in
// fp32) before both dots, as the reference does. All compute, per query
// row, the online-softmax recurrence
//   m' = max(m, max_p s), w = exp(s - m'), c = exp(m - m'),
//   l' = l c + sum w, acc' = acc c + w V,   out = acc / max(l, 1e-30)
// over the row's own KV pages in ascending order, in fp32 whatever the
// input type, and write the output in q's type. A key past the row's
// causal bound scores -inf (the reference's constant).
//
// What bounds it on an H100: a decode-heavy tick does ~4 flops per KV byte
// it reads (one dot and one axpy per key for each of the group's query
// heads), far under the ~295 flops/byte where bf16 tensor cores become the
// limit, so the floor is the bytes of K/V pages read at 3.35 TB/s (int8
// pages: (d + 4) / 2d of the bf16 bytes, with their scales). A large
// prefill span is still bytes-bound at these tile sizes.
//
// The q-block kernels (ROADMAP C21). The reference's q-block grid walks,
// for every (q-block, kv head), the union of the pages of every sequence
// in the block, and masks another owner's keys with the finite BIG_NEG so
// that those jobs are exact no-ops for a row (ragged_paged_attention.py
// :72-81). A row's arithmetic is therefore its own pages' recurrence, in
// ascending order, which is what the per-token kernel computes. So the
// q-block kernel here walks only that: one thread block per work unit
// (q-block b, owner slot s) and kv head, built on the host from the
// schedule (qblock_units in ops/ragged_paged_attention.py): the unit's
// pages are slot s's run of block b's job list, its rows the rows of
// block b whose slot is s. No alien page is read, no merge is needed
// (each row has one owner), and a pure-decode tick of 8 sequences runs
// 8 x KVH blocks instead of KVH. Each row stops at its own
// ceil(ctx / P) pages, exactly where the per-token kernel stops, so the
// two grids give a real row the same bits (ROADMAP C21), and the same
// row-level helpers of attention_common.cuh fix every rounding point.
//
// Within a block: the unit's pages are staged raw (in their own type, not
// converted) into a double buffer of kChunk pages, the next chunk in
// flight while this one computes: K rows by 16-byte cp.async into rows
// padded by 16 bytes, so that lanes scoring different keys at one column
// hit different banks; V pages (and int8 scales) by one bulk copy each,
// completing on an mbarrier, since the lanes of one V row read
// neighbouring columns.
//
// A chunk runs three phases, each ended by a barrier, that spread a row's
// serial recurrence over threads without changing one operation of it
// (see qblock_unit_kernel): the scores of all the chunk's pages at once
// (they do not depend on the recurrence; a thread runs one key's fmaf
// chains over e for one or four query rows, the q rows staged once per
// unit as fp32), with each page's max; the weights of every (page, row)
// at once, since the running max at a page is an exact fmaxf over the
// page maxima before it; then acc' = acc c + w V page after page, two
// columns of one or four rows a thread, and l' = l c + sum. No tensor
// cores: their products sum e in another order, which C21 forbids, and
// the work is bytes-bound anyway. On an H100 a pure-decode unit (4 rows)
// is latency-bound: each phase leaves most of the block's threads idle
// and pays its chains' latency once a chunk.
//
// The per-token kernels come in two variants, the wrapper choosing by rule
// (ops/ragged_paged_attention.py, token_variant):
//
// "cluster", token_split_kernel<T, PT, 16> (page size 16, D % 16 == 0,
// 16-byte aligned pools and scales, shared memory that fits):
//   * Grid (S, kv_heads, tokens), clusters of (S, 1, 1): the S blocks of a
//     cluster share one (token, kv head), whose rows are the group's G
//     query heads. S comes from shapes alone (token_splits: tokens x kv
//     heads against the SMs, at most 8), never from the contexts on the
//     device: 1 at a mixed tick of 256 tokens, 5 at a pure-decode tick of
//     8 on 132 SMs. With S = 1 it runs as one block, with no cluster.
//   * The token's own ceil(ctx / P) pages are walked in rounds of S x c
//     pages (c = round_pages), block s taking the round's s-th run of c
//     consecutive pages. They are staged raw, each part a round ahead of
//     the barrier before its readers: the K rows (read only by the scores)
//     by 16-byte cp.async into padded rows right after the previous
//     round's scores, the V pages and int8 scales (read only by the
//     values) by bulk copies on an mbarrier at the start of the round. So
//     one buffer of c pages serves: six pages a round fit beside two more
//     blocks an SM, four pages a round beside three.
//   * A row's recurrence has only two serial chains across pages, acc' =
//     acc corr + pv and l' = l corr + sum. Everything else of a page
//     depends only on the page and on the running max before it, which is
//     an exact fmaxf over the carried max and the page maxima before it.
//     So per round: (a) each block scores its pages (one fmaf chain over e
//     a key, as `dots`) and stores each page's max into every block of
//     the cluster (distributed shared memory); a cluster barrier; (b, c)
//     each block's pages' running maxima before and after them, weights,
//     sum in key order, corr (stored into every block) and pv (stored into
//     the block whose slice of the G x D outputs it belongs to); a second
//     cluster barrier; (d) one ordered fold: block s folds its slice with
//     acc_update over all the round's pages in page order, and every
//     block folds l with l_update in the same order. With S = 1 the
//     values fold each page's pv as they compute it, as the q-block
//     kernel does. No operation of C21 is reordered, split or merged: the
//     kernel gives the q-block kernel's bits on every row (ROADMAP C21).
//     Every read is of the block's own shared memory, and a block stores
//     into another's only after that block has passed the barrier that
//     follows its last read of the buffer.
//   * No tensor cores: their products sum e in another order (C21).
//
// "block", token_kernel<T, PT> (every other shape): the simple first
// design, one block per (token, kv head) staging one page at a time in
// shared memory as fp32.
//
// Schedules (units, jobs, row descriptors; per-token slots and contexts)
// are built on the host in ops/ragged_paged_attention.py and copied to the
// device; the kernels only read them.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "qblock.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // per-token kernels, "block"

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
        from_f32<T>(finish(t.acc[i], t.l[r]));
  }
}

// ---------------------------------------------------------- "cluster"

constexpr int kSplitThreads = 128;
constexpr int kMaxSplits = 8;        // the portable cluster size
constexpr int kMaxRoundPages = 8;    // c, the pages a block takes a round

// The G x D outputs of a (token, kv head) that each of S blocks folds: an
// even count, so that a thread's two columns never straddle two blocks.
__host__ __device__ inline int token_slice(int G, int D, int S) {
  return 2 * ((G * D + 2 * S - 1) / (2 * S));
}

// A key's weights for the G rows in shared memory: G rounded up to four,
// so that four rows' weights are one 16-byte load.
__host__ __device__ inline int token_rows(int G) { return (G + 3) & ~3; }

// Dynamic shared memory of one split block with G rows, laid out as the
// top of token_split_kernel carves it: an mbarrier, the block's c staged
// pages of a round (K rows padded, V rows packed) and their int8 scales,
// then fp32: q rows, the block's scores of a round, and what the round's
// S x c pages leave in every block (their maxima, corr and sums for every
// row) and, with S > 1, in the block that folds them (their pv over its
// slice), the slice's acc, m and l; and the block's table entries.
// ops/ragged_paged_attention.py:token_smem_bytes is the same formula.
__host__ __device__ inline size_t token_split_smem_bytes(
    int el, bool quant, int G, int P, int D, int pages_per_seq, int splits,
    int round_pages) {
  const size_t page = (size_t)P * (staged_row(D, el) + (size_t)D * el);
  const size_t ring = (size_t)round_pages * page;
  const size_t scales =
      quant ? (size_t)round_pages * 2 * P * sizeof(float) : 0;
  const int per_round = splits * round_pages;
  const int slice = token_slice(G, D, splits);
  // with S = 1 the block folds each page's pv as it computes it
  const size_t pv = splits > 1 ? (size_t)per_round * slice : 0;
  const size_t floats = (size_t)G * (D + 4) +
                        (size_t)round_pages * P * token_rows(G) +
                        3 * (size_t)per_round * G + pv + (size_t)slice +
                        2 * (size_t)G;
  const int cap = round_pages * ((pages_per_seq + per_round - 1) / per_round);
  return 2 * sizeof(uint64_t) + ring + scales + floats * sizeof(float) +
         (size_t)cap * sizeof(int);
}

// Block `rank`'s copy of the shared buffer at p (p itself without
// clusters: S = 1 never touches the cluster API).
__device__ __forceinline__ float* in_block(float* p, int rank, int S) {
  return S > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// What the phases of one round of a split block share.
struct SplitRound {
  const float* qs;            // [G][D + 4] fp32 query rows
  const unsigned char* buf;   // the block's staged pages of the round
  const float* sbuf;          // their int8 row scales, [page][K, V][P]
  float* sw;                  // [page][P][GS] scores, then weights
  float* xm;                  // [S c][G] the round's page maxima, every block
  float* xcorr;               // [S c][G] their corr, in every block
  float* xsum;                // [S c][G] their sums, in every block
  float* xpv;                 // [S c][slice] their pv over a block's slice
  const float* m;             // [G] the running max carried into the round
  size_t page_bytes;          // a staged page: K rows padded, V rows packed
  int stride, row_bytes, D, G, GS, S, s, C, first, cnt, live, ctx, slice;
  int rot;                    // the warp a phase's first item goes to
};

// The thread that takes a phase's item 0: warp `rot`, so that the blocks
// sharing an SM, whose phases may fill one to three warps, spread them
// over its four schedulers.
__device__ __forceinline__ int item_thread(const SplitRound& u) {
  return (threadIdx.x + (kSplitThreads - 32 * u.rot)) % kSplitThreads;
}

// (a) thread (page p, rows r0 .. r0 + kRows - 1, key c): the keys' chains
// (`dots`, as the q-block kernel runs them), masked at the token's causal
// bound, and each row's page maximum by fmaxf across the page's P
// neighbouring lanes (exact in any order; all in or all out), stored in
// every block of the cluster.
template <typename PT, int kP, int kRows>
__device__ __forceinline__ void split_scores(const SplitRound& u,
                                             float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const unsigned page_lanes = ((1u << kP) - 1) << (lane & ~(kP - 1));
  const int RQ = (u.G + kRows - 1) / kRows;
  for (int i = item_thread(u); i < u.cnt * RQ * kP; i += kSplitThreads) {
    const int c = i % kP, pr = i / kP, rq = pr % RQ, p = pr / RQ;
    const int r0 = rq * kRows;
    const float* qr[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      qr[j] = u.qs + (size_t)min(r0 + j, u.G - 1) * (u.D + 4);
    float dot[kRows];
    dots<PT, kRows>(qr, u.buf + p * u.page_bytes + (size_t)c * u.stride,
                    kQuant ? u.sbuf[(size_t)p * 2 * kP + c] : 0.f, u.D, dot);
    const bool live = (u.first + p) * kP + c < u.ctx;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j;
      const float sc = live ? score_of(dot[j], sm_scale) : -INFINITY;
      if (r < u.G) u.sw[((size_t)p * kP + c) * u.GS + r] = sc;
      float mx = sc;
#pragma unroll
      for (int o = 1; o < kP; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(page_lanes, mx, o));
      if (r < u.G && c < u.S) {
        // lane c of the page stores to block c, for S <= P blocks
        in_block(u.xm, c, u.S)[(u.s * u.C + p) * u.G + r] = mx;
      }
    }
  }
}

// (b, c) thread (page p, row r, key c): the running max before and after
// the page, an exact fmaxf over the carried max and the maxima of the
// round's pages up to it in page order; the key's weight; the page's sum
// in key order gathered by shuffles across its P neighbouring lanes
// (softmax_weights' order), and corr. Sum and corr go to every block.
template <int kP>
__device__ __forceinline__ void split_weights(const SplitRound& u) {
  const int lane = threadIdx.x & 31;
  const unsigned page_lanes = ((1u << kP) - 1) << (lane & ~(kP - 1));
  for (int i = threadIdx.x; i < u.cnt * u.G * kP; i += kSplitThreads) {
    const int c = i % kP, pr = i / kP, p = pr / u.G, r = pr - p * u.G;
    const int j = u.s * u.C + p;                 // the page's index in the round
    float m_prev = u.m[r];
    for (int jj = 0; jj < j; ++jj) m_prev = fmaxf(m_prev, u.xm[jj * u.G + r]);
    const float m_new = fmaxf(m_prev, u.xm[j * u.G + r]);
    float* sr = u.sw + ((size_t)p * kP + c) * u.GS + r;
    const float w = weight_of(*sr, m_new);
    *sr = w;
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < kP; ++cc)
      sum = __fadd_rn(sum, __shfl_sync(page_lanes, w, (lane & ~(kP - 1)) + cc));
    if (c < u.S) {
      // lane c of the page stores to block c
      in_block(u.xsum, c, u.S)[j * u.G + r] = sum;
      in_block(u.xcorr, c, u.S)[j * u.G + r] = rescale(m_prev, m_new);
    }
  }
}

// A key's weights for rows row[0 .. kRows): four consecutive rows (row[0]
// a multiple of four) in one 16-byte load.
template <int kRows>
__device__ __forceinline__ void weights_of(const float* key,
                                           const int (&row)[kRows],
                                           float (&w)[kRows]) {
  if constexpr (kRows == 4) {
    const float4 x = *reinterpret_cast<const float4*>(key + row[0]);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) w[j] = key[row[j]];
  }
}

// (b, c) as split_weights, thread (page p, row r) running the page's
// keys one after another (softmax_weights' order: the same bits).
template <int kP>
__device__ __forceinline__ void split_weights_rows(const SplitRound& u) {
  for (int i = item_thread(u); i < u.cnt * u.G; i += kSplitThreads) {
    const int p = i / u.G, r = i - p * u.G;
    const int j = u.s * u.C + p;                 // the page's index in the round
    float m_prev = u.m[r];
    for (int jj = 0; jj < j; ++jj) m_prev = fmaxf(m_prev, u.xm[jj * u.G + r]);
    const float m_new = fmaxf(m_prev, u.xm[j * u.G + r]);
    float* sr = u.sw + (size_t)p * kP * u.GS + r;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kP; ++c) {
      const float w = weight_of(sr[c * u.GS], m_new);
      sr[c * u.GS] = w;
      sum = __fadd_rn(sum, w);
    }
    const float corr = rescale(m_prev, m_new);
    for (int b = 0; b < u.S; ++b) {
      in_block(u.xsum, b, u.S)[j * u.G + r] = sum;
      in_block(u.xcorr, b, u.S)[j * u.G + r] = corr;
    }
  }
}

// (c) thread (page p, rows r0 .. r0 + kRows - 1, columns e, e + 1): the
// page's pv chains over its keys from 0.f, stored in the block whose
// slice holds the two outputs.
template <typename PT, int kP, int kRows>
__device__ __forceinline__ void split_values(const SplitRound& u) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int half = u.D / 2;
  const int RQ = (u.G + kRows - 1) / kRows;
  for (int i = threadIdx.x; i < u.cnt * RQ * half; i += kSplitThreads) {
    const int e = 2 * (i % half), pr = i / half, rq = pr % RQ, p = pr / RQ;
    const int r0 = rq * kRows;
    int row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) row[j] = min(r0 + j, u.G - 1);
    const unsigned char* vpage =
        u.buf + p * u.page_bytes + (size_t)kP * u.stride;
    float pv[kRows][2];
#pragma unroll
    for (int j = 0; j < kRows; ++j) pv[j][0] = pv[j][1] = 0.f;
#pragma unroll
    for (int c = 0; c < kP; ++c) {
      float v[2];
      staged2<PT>(vpage + (size_t)c * u.row_bytes, e,
                  kQuant ? u.sbuf[((size_t)p * 2 + 1) * kP + c] : 0.f, v);
      float w[kRows];
      weights_of<kRows>(u.sw + ((size_t)p * kP + c) * u.GS, row, w);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        pv[j][0] = fmaf(w[j], v[0], pv[j][0]);
        pv[j][1] = fmaf(w[j], v[1], pv[j][1]);
      }
    }
    const int jr = u.s * u.C + p;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j >= u.G) break;
      const int o = (r0 + j) * u.D + e, owner = o / u.slice;
      *reinterpret_cast<float2*>(
          in_block(u.xpv, owner, u.S) + (size_t)jr * u.slice + o -
          owner * u.slice) = make_float2(pv[j][0], pv[j][1]);
    }
  }
}

// Value e of a staged V row, as staged2 converts it.
template <typename PT>
__device__ __forceinline__ float staged1(const unsigned char* row, int e,
                                         float scale);
template <>
__device__ __forceinline__ float staged1<float>(const unsigned char* row,
                                                int e, float) {
  return *reinterpret_cast<const float*>(row + 4 * e);
}
template <>
__device__ __forceinline__ float staged1<__nv_bfloat16>(
    const unsigned char* row, int e, float) {
  return to_f32(*reinterpret_cast<const __nv_bfloat16*>(row + 2 * e));
}
template <>
__device__ __forceinline__ float staged1<__half>(const unsigned char* row,
                                                 int e, float) {
  return to_f32(*reinterpret_cast<const __half*>(row + 2 * e));
}
template <>
__device__ __forceinline__ float staged1<int8_t>(const unsigned char* row,
                                                 int e, float scale) {
  return dequant(code_f32((uint32_t)row[e] ^ 0x80u, 0), scale);
}

// (c, d) with S = 1, where the block holds all of the round's pages:
// thread (rows r0 .. r0 + kRows - 1, column e) runs each page's pv chains
// and folds them into acc in page order, as the q-block kernel's values
// phase does; `acc` is the whole G x D.
template <typename PT, int kP, int kRows>
__device__ __forceinline__ void split_values_fold(const SplitRound& u,
                                                  float* acc) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int RQ = (u.G + kRows - 1) / kRows;
  for (int i = item_thread(u); i < RQ * u.D; i += kSplitThreads) {
    const int e = i % u.D, r0 = (i / u.D) * kRows;
    int row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) row[j] = min(r0 + j, u.G - 1);
    float a[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) a[j] = acc[(size_t)row[j] * u.D + e];
    for (int p = 0; p < u.cnt; ++p) {
      const unsigned char* vpage =
          u.buf + p * u.page_bytes + (size_t)kP * u.stride;
      float pv[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) pv[j] = 0.f;
#pragma unroll
      for (int c = 0; c < kP; ++c) {
        const float v = staged1<PT>(
            vpage + (size_t)c * u.row_bytes, e,
            kQuant ? u.sbuf[((size_t)p * 2 + 1) * kP + c] : 0.f);
        float w[kRows];
        weights_of<kRows>(u.sw + ((size_t)p * kP + c) * u.GS, row, w);
#pragma unroll
        for (int j = 0; j < kRows; ++j) pv[j] = fmaf(w[j], v, pv[j]);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        a[j] = acc_update(a[j], u.xcorr[p * u.G + row[j]], pv[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (r0 + j >= u.G) break;
      acc[(size_t)(r0 + j) * u.D + e] = a[j];
    }
  }
}

// Kernel 8 (PT = T) and B9 (PT = int8_t), "cluster": grid (S, kv_heads,
// tokens), clusters of (S, 1, 1) when S > 1; block s of a cluster is split
// s of token `tok`'s kv head h. Its rows are the G query heads sharing kv
// head h. The token's pages, ceil(ctx / P) capped at pages_per_seq, go in
// rounds of S x c: round k covers pages k S c .. (k + 1) S c - 1, block s
// the c of them from k S c + s c. Every block of a cluster runs the same
// rounds and barriers; one with no page in a round only takes part. Block
// s folds the outputs s slice .. (s + 1) slice - 1 of the G x D.
// What a round's pages leave for other blocks (maxima, corr, sums, pv) is
// stored straight into those blocks' shared memory, so every read is
// local: a cluster barrier after the scores (the maxima) and one after the
// values (the rest) order them. Before a block overwrites another's copy
// in the next round, that block has passed the barrier that follows its
// last read of it.
template <typename T, typename PT, int kP>
__global__ void __launch_bounds__(kSplitThreads, 4)
token_split_kernel(const T* __restrict__ q, const Pages<PT> pg,
                   T* __restrict__ out, const int* __restrict__ tok_slot,
                   const int* __restrict__ tok_ctx,
                   const int* __restrict__ tables, int H, int KVH, int D,
                   int NP, int pages_per_seq, int round_pages,
                   float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int P = kP;
  static_assert(kP < 32 && (kP & (kP - 1)) == 0, "page size");
  static_assert(kMaxSplits <= kP, "a page's lanes store to every block");
  extern __shared__ __align__(16) unsigned char token_smem[];
  const int S = gridDim.x, s = blockIdx.x;
  const int h = blockIdx.y, tok = blockIdx.z;
  const int G = H / KVH, C = round_pages, per_round = S * C;
  const int tid = threadIdx.x;

  const int row_bytes = D * (int)sizeof(PT);
  const int stride = staged_row(D, sizeof(PT));
  const size_t page_bytes = (size_t)P * (stride + row_bytes);
  const int cap = C * ((pages_per_seq + per_round - 1) / per_round);
  const int slice = token_slice(G, D, S);
  uint64_t* bar = reinterpret_cast<uint64_t*>(token_smem);
  unsigned char* buf = token_smem + 2 * sizeof(uint64_t);   // [C] pages
  float* sbuf = reinterpret_cast<float*>(buf + C * page_bytes);
  const int GS = token_rows(G);
  float* qs = sbuf + (kQuant ? C * 2 * P : 0);      // [G][D + 4]
  float* sw = qs + (size_t)G * (D + 4);             // [C][P][GS], 16-aligned
  float* xpv = sw + (size_t)C * P * GS;             // [S C][slice], 16-aligned
  float* xm = xpv + (S > 1 ? (size_t)per_round * slice : 0);   // [S C][G]
  float* xcorr = xm + per_round * G;                // [S C][G]
  float* xsum = xcorr + per_round * G;              // [S C][G]
  float* acc = xsum + per_round * G;                // [slice]
  float* m = acc + slice;                           // [G]
  float* l = m + G;                                 // [G]
  int* upg = reinterpret_cast<int*>(l + G);         // [cap] own table entries

  const int slot = tok_slot[tok], ctx = tok_ctx[tok];
  const int npg = min((ctx + P - 1) / P, pages_per_seq);
  const int n_rounds = (npg + per_round - 1) / per_round;
  const int lo = min(G * D, s * slice), hi = min(G * D, lo + slice);

  // local page i is page (i / C) S C + s C + i % C of the token
  for (int i = tid; i < cap; i += kSplitThreads) {
    const int g = (i / C) * per_round + s * C + i % C;
    upg[i] = g < npg ? tables[(size_t)slot * pages_per_seq + g] : 0;
  }
  for (int i = tid; i < G * D; i += kSplitThreads) {
    const int r = i / D, e = i - r * D;
    qs[(size_t)r * (D + 4) + e] =
        to_f32(q[((size_t)tok * H + h * G + r) * D + e]);
  }
  for (int i = tid; i < slice; i += kSplitThreads) acc[i] = 0.f;
  for (int r = tid; r < G; r += kSplitThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  // every block's barriers are initialised before any block stores into
  // another's shared memory
  if (S > 1) cg::this_cluster().sync();
  else __syncthreads();

  auto count_of = [&](int k) {
    return max(0, min(C, npg - (k * per_round + s * C)));
  };
  // The block's pages of a round are staged in two parts, each a round
  // ahead of its readers' barrier: K rows (read only by the scores) by
  // 16-byte cp.async pieces into padded rows (lanes scoring different keys
  // at one column hit different banks), a thread's pieces kSplitThreads
  // apart, int8 K scales likewise; V pages and int8 V scales (read only by
  // the values) by one bulk copy each from the last warp, completing on
  // the mbarrier.
  const int row_chunks = row_bytes / 16;
  const int row0 = tid / row_chunks;
  const int ch0 = tid - row0 * row_chunks;
  const int step_rows = kSplitThreads / row_chunks;
  const int step_ch = kSplitThreads - step_rows * row_chunks;
  auto stage_k = [&](int k) {
    const int cnt = count_of(k);
    const int* pages = upg + k * C;
    for (int p = 0; p < cnt; ++p) {
      const size_t page0 = ((size_t)h * NP + pages[p]) * P;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(pg.k + page0 * D);
      unsigned char* dst = buf + p * page_bytes;
      int row = row0, ch = ch0;
      for (int i = tid; i < P * row_chunks; i += kSplitThreads) {
        cp_async16(dst + (size_t)row * stride + ch * 16, src + (size_t)i * 16);
        row += step_rows;
        ch += step_ch;
        if (ch >= row_chunks) {
          ch -= row_chunks;
          ++row;
        }
      }
      if (kQuant && tid < P / 4)
        cp_async16(sbuf + (size_t)p * 2 * P + 4 * tid, pg.ks + page0 + 4 * tid);
    }
    cp_async_commit();
  };
  // (lane p of the last warp copies page p; lane 0 announces the bytes, a
  // copy that lands first cannot complete the phase without it)
  auto stage_v = [&](int k) {
    const int cnt = count_of(k), lane = tid & 31;
    if (lane == 0)
      mbar_expect_tx(bar, cnt * P * (row_bytes + (kQuant ? 4 : 0)));
    for (int p = lane; p < cnt; p += 32) {
      const size_t page0 = ((size_t)h * NP + upg[k * C + p]) * P;
      fence_proxy_async();
      bulk_copy(buf + p * page_bytes + (size_t)P * stride, pg.v + page0 * D,
                P * row_bytes, bar);
      if (kQuant)
        bulk_copy(sbuf + (size_t)p * 2 * P + P, pg.vs + page0, P * 4, bar);
    }
  };

  // scores: four rows an item when the block is one of many (S = 1, the
  // SM's other blocks fill it) or that fills the block, else fewer
  const int RQ4 = (G + 3) / 4, RQ2 = (G + 1) / 2;
  const int rows_an_item =
      G >= 4 && (S == 1 || C * P * RQ4 >= kSplitThreads) ? 4
      : G >= 2 && (S == 1 || C * P * RQ2 >= kSplitThreads) ? 2 : 1;
  // values in a cluster: four rows an item when that fills the block, else
  // one (alone, four rows an item a column: split_values_fold)
  const bool quad_values = G % 4 == 0 && RQ4 * (D / 2) * C >= kSplitThreads;

  const int rot = (h + tok) & 3;
  if (n_rounds > 0) stage_k(0);
  for (int k = 0; k < n_rounds; ++k) {
    const int first = k * per_round;
    const int cnt = count_of(k);
    const SplitRound u{qs, buf, sbuf, sw, xm, xcorr, xsum, xpv, m,
                       page_bytes, stride, row_bytes, D, G, GS, S, s, C,
                       first + s * C, cnt, min(per_round, npg - first), ctx,
                       slice, rot};
    // the round's K rows: every thread's own pieces, then a block barrier
    // for the rows other threads copied; it also ends every read of the
    // previous round's V pages, which thread 0 then replaces
    cp_async_wait<0>();
    __syncthreads();
    if (tid >= kSplitThreads - 32) stage_v(k);

    // (a) scores and page maxima of the block's pages
    if (rows_an_item == 4) split_scores<PT, P, 4>(u, sm_scale);
    else if (rows_an_item == 2) split_scores<PT, P, 2>(u, sm_scale);
    else split_scores<PT, P, 1>(u, sm_scale);
    if (S > 1) cg::this_cluster().sync();
    else __syncthreads();
    // every K row of the round has been read: the next round's come in
    if (k + 1 < n_rounds) stage_k(k + 1);

    // (b, c) running maxima, weights, sums and corr of the block's pages:
    // a thread a (page, row) when the block is one of many (S = 1) or that
    // fills it, else a (page, row, key)
    if (S == 1 || cnt * G * 2 >= kSplitThreads) split_weights_rows<P>(u);
    else split_weights<P>(u);
    __syncthreads();
    if (cnt > 0) mbar_wait(bar, k & 1);
    // the carried max moves past the round (m is read again only in the
    // next round's weights, after two barriers)
    for (int r = tid; r < G; r += kSplitThreads) {
      float mr = m[r];
      for (int j = 0; j < u.live; ++j) mr = fmaxf(mr, xm[j * G + r]);
      m[r] = mr;
    }
    // every row's l, folded in page order once the round's sums and corr
    // are in this block
    auto fold_l = [&]() {
      for (int r = tid; r < G; r += kSplitThreads) {
        float lr = l[r];
        for (int j = 0; j < u.live; ++j)
          lr = l_update(lr, xcorr[j * G + r], xsum[j * G + r]);
        l[r] = lr;
      }
    };
    if (S == 1) {
      // (c, d) in one pass: the block holds every page of the round
      if (G % 4 == 0) split_values_fold<PT, P, 4>(u, acc);
      else split_values_fold<PT, P, 1>(u, acc);
      fold_l();
      continue;
    }
    // (c) the pages' pv, stored in the blocks that fold them
    if (quad_values) split_values<PT, P, 4>(u);
    else split_values<PT, P, 1>(u);
    cg::this_cluster().sync();
    fold_l();

    // (d) the ordered fold of the round's pages over the block's slice
    for (int i = lo + tid; i < hi; i += kSplitThreads) {
      const int r = i / D;
      const float* pv = xpv + (i - lo);
      float a = acc[i - lo];
      for (int j = 0; j < u.live; ++j)
        a = acc_update(a, xcorr[j * G + r], pv[(size_t)j * slice]);
      acc[i - lo] = a;
    }
  }
  __syncthreads();

  // the last stores into this block's shared memory came before the
  // round's second barrier: the blocks finish on their own
  for (int i = lo + tid; i < hi; i += kSplitThreads) {
    const int r = i / D, e = i - r * D;
    out[((size_t)tok * H + h * G + r) * D + e] =
        from_f32<T>(finish(acc[i - lo], l[r]));
  }
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

template <typename T, typename PT>
cudaError_t launch_token_split(const void* q, const Pages<PT>& pg, void* out,
                               const int* ts, const int* tc,
                               const int* tables, int T_tok, int H, int KVH,
                               int D, int NP, int P, int pages_per_seq,
                               float sm_scale, int splits, int round_pages,
                               cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const bool aligned =
      !((reinterpret_cast<uintptr_t>(pg.k) | reinterpret_cast<uintptr_t>(pg.v)
         | reinterpret_cast<uintptr_t>(pg.ks)
         | reinterpret_cast<uintptr_t>(pg.vs)) & 15);
  // one instantiation, for the page size every cache here uses (16)
  if (P != 16 || D % 16 || H % KVH || splits < 1 || splits > kMaxSplits ||
      round_pages < 1 || round_pages > kMaxRoundPages || pages_per_seq < 1 ||
      T_tok > 65535 || !aligned)
    return cudaErrorInvalidValue;
  const size_t smem = token_split_smem_bytes(sizeof(PT), kQuant, H / KVH, P,
                                             D, pages_per_seq, splits,
                                             round_pages);
  auto kernel = token_split_kernel<T, PT, 16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH, T_tok);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;   // S = 1: a plain launch
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, pg, (T*)out, ts, tc,
                           tables, H, KVH, D, NP, pages_per_seq, round_pages,
                           sm_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. dtype (of q and out): 0 float32,
// 1 bfloat16, 2 float16; the native-page functions also take 3 (bfloat16
// q and out over float32 pages) and 4 (float16 over float32). Every
// pointer is a device pointer of a
// contiguous tensor; the Python wrapper checks shapes, types and devices.
// The _q8 functions take int8 pages kp/vp [KVH, NP, P, D] and their fp32
// row scales ks/vs [KVH, NP, P]. (The q-block kernels' functions are in
// qblock.cuh, qblock_unit_p<kP>.cu and qblock_runtime.cu.) Returns the
// cudaError_t of the launch (0 on success).
extern "C" {

// Dynamic shared memory of a q-block launch, in bytes, for pages of
// `page_el` bytes a value (4 fp32, 2 bf16/fp16, 1 int8 with scales), J
// jobs a block and tables pps pages wide.
int ptt_ragged_qblock_smem(int page_el, int H, int KVH, int D, int P, int qb,
                           int J, int pps) {
  return (int)unit_smem_bytes(page_el, page_el == 1, qb * (H / KVH), P, D,
                              qb, J < pps ? J : pps);
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
    case 3: return (int)launch_token<__nv_bfloat16>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
    case 4: return (int)launch_token<__half>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, s);
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

// "cluster": the operands of ptt_ragged_token, then the splits S (1..8)
// and the pages c a block takes a round (1..8). Needs P == 16, D % 16 ==
// 0 and 16-byte aligned pools; refuses other shapes with
// cudaErrorInvalidValue.
int ptt_ragged_token_split(int dtype, const void* q, const void* kp,
                           const void* vp, void* out, const int* tok_slot,
                           const int* tok_ctx, const int* tables, int T_tok,
                           int H, int KVH, int D, int NP, int P,
                           int pages_per_seq, float sm_scale, int splits,
                           int round_pages, void* stream) {
  if (T_tok <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_token_split<float>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 1: return (int)launch_token_split<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 2: return (int)launch_token_split<__half>(q, native_pages<__half>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 3: return (int)launch_token_split<__nv_bfloat16>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 4: return (int)launch_token_split<__half>(q, native_pages<float>(kp, vp), out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// "cluster" over int8 pages: the operands of ptt_ragged_token_q8, then the
// splits and the round's pages a block.
int ptt_ragged_token_split_q8(int dtype, const void* q, const void* kp,
                              const void* vp, const float* ks,
                              const float* vs, void* out,
                              const int* tok_slot, const int* tok_ctx,
                              const int* tables, int T_tok, int H, int KVH,
                              int D, int NP, int P, int pages_per_seq,
                              float sm_scale, int splits, int round_pages,
                              void* stream) {
  if (T_tok <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_token_split<float>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 1: return (int)launch_token_split<__nv_bfloat16>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    case 2: return (int)launch_token_split<__half>(q, pg, out, tok_slot, tok_ctx, tables, T_tok, H, KVH, D, NP, P, pages_per_seq, sm_scale, splits, round_pages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one "cluster" block, for pages of `el`
// bytes a value (int8 with scales when quant); the wrapper's rule computes
// the same in Python, and chip_smoke.py holds the two equal.
int ptt_ragged_token_split_smem(int el, int quant, int G, int P, int D,
                                int pages_per_seq, int splits,
                                int round_pages) {
  return (int)token_split_smem_bytes(el, quant != 0, G, P, D, pages_per_seq,
                                     splits, round_pages);
}

}  // extern "C"
