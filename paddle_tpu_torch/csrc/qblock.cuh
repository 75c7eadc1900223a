// The q-block ragged paged attention kernels for Hopper (sm_90a): kernel 6
// (_qblock_kernel, paddle_tpu/ops/pallas/ragged_paged_attention.py:215)
// and B7 (_qblock_kernel_quant, :258) as two variants on one grid of
// (q-block, owner slot) units, and what the per-token cluster kernel
// (ragged_paged_attention.cu) shares with them (dots, staged_row, kQuad).
// The design and the rounding rule (ROADMAP C21) are described at the top
// of ragged_paged_attention.cu. Each variant builds in translation units
// of its own so that nvcc compiles them side by side:
//   qblock_unit_p{4,8,16,32}.cu  qblock_unit_kernel<T, PT, kP>, one page
//                                size each (PTT_QBLOCK_UNIT_ENTRIES);
//   qblock_runtime.cu            qblock_runtime_kernel<T, PT>.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kUnitThreads = 256;  // q-block unit kernels
// Pages a q-block unit stages, scores and steps through per chunk.
constexpr int kChunk = 4;
// Query rows whose score chains one thread runs side by side.
constexpr int kQuad = 4;

// Bytes of one staged K row: D values of `el` bytes, padded by 16 (V rows
// are staged packed).
__host__ __device__ inline int staged_row(int D, int el) { return D * el + 16; }

// Dynamic shared memory of a q-block unit block with up to R rows, qb
// tokens and units of at most `unit_pages` pages (min(J, the table's
// width): the schedule's jobs a block, or a slot's pages), laid out as the
// top of qblock_unit_kernel carves it.
__host__ __device__ inline size_t unit_smem_bytes(int el, bool quant, int R,
                                                  int P, int D, int qb,
                                                  int unit_pages) {
  const size_t ring = 2 * (size_t)kChunk * P * (staged_row(D, el) + D * el);
  const size_t scales = quant ? 2 * (size_t)kChunk * 2 * P * sizeof(float) : 0;
  const size_t floats = (size_t)R * (D + 4) + (size_t)kChunk * R * (P + 1) +
                        4 * (size_t)kChunk * R + (size_t)R * D + 2 * (size_t)R;
  return 2 * sizeof(uint64_t) + ring + scales + floats * sizeof(float) +
         (3 * (size_t)qb + 1 + (size_t)unit_pages) * sizeof(int);
}

// The 4-byte words of qblock_runtime_kernel's token lists, rounded up to
// 16 bytes.
__host__ __device__ inline int rt_int_words(int qb) {
  return (3 * qb + 1 + 3) & ~3;
}

// The most pages a qblock_runtime_kernel block stages and steps through
// at once, and the elements a thread loads before it stores them.
constexpr int kRtChunk = 8;
constexpr int kRtLoads = 16;

// Dynamic shared memory of a qblock_runtime_kernel block that takes rt
// rows a pass, chunks of c pages and, within a page, runs of kc keys
// (kc < P only with c == 1), laid out as the kernel carves it.
__host__ __device__ inline size_t rt_smem_bytes(int P, int D, int qb, int rt,
                                                int c, int kc) {
  const bool carried = kc < P;
  const size_t keys = carried ? (size_t)kc : (size_t)c * P;
  const size_t floats = (size_t)rt * (D + 1) + keys * (2 * D + 1) +
                        (size_t)c * rt * P + 4 * (size_t)c * rt +
                        (size_t)rt * D + (carried ? (size_t)rt * D : 0) +
                        2 * (size_t)rt;
  return (rt_int_words(qb) + floats) * sizeof(float);
}

// The plan of a qblock_runtime_kernel block with up to R rows: all R rows
// a pass, chunks of kRtChunk whole pages, where that fits `limit` bytes;
// else fewer pages a chunk, then one page in runs of fewer keys down to
// 16, then fewer rows a pass, then fewer keys. Writes {rt, c, kc}; returns false when not
// even one row and one key fit.
inline bool qblock_rt_plan(int R, int P, int D, int qb, size_t limit,
                           int* plan) {
  int rt = R, c = kRtChunk, kc = P;
  while (rt_smem_bytes(P, D, qb, rt, c, kc) > limit) {
    if (c > 1) c = (c + 1) / 2;
    else if (kc > 16) kc = (kc + 1) / 2;
    else if (rt > 1) rt = (rt + 1) / 2;
    else if (kc > 1) kc = (kc + 1) / 2;
    else return false;
  }
  plan[0] = rt;
  plan[1] = c;
  plan[2] = kc;
  return true;
}

// The dot products of the staged key row krow with kRows fp32 query rows
// qr[0..kRows), each one fmaf chain over e = 0..D-1 from 0.f. The key is
// converted once for the kRows rows.
template <typename PT, int kRows>
__device__ __forceinline__ void dots(const float* const (&qr)[kRows],
                                     const unsigned char* krow, float ks,
                                     int D, float (&dot)[kRows]) {
  constexpr int N = Staged<PT>::N;
#pragma unroll
  for (int j = 0; j < kRows; ++j) dot[j] = 0.f;
#pragma unroll 2
  for (int e0 = 0; e0 < D; e0 += N) {
    float kx[N];
    Staged<PT>::cvt(*reinterpret_cast<const uint4*>(krow + e0 * sizeof(PT)),
                    ks, kx);
#pragma unroll
    for (int i = 0; i < N; i += 4) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qr[j] + e0 + i);
        dot[j] = fmaf(qv.x, kx[i], dot[j]);
        dot[j] = fmaf(qv.y, kx[i + 1], dot[j]);
        dot[j] = fmaf(qv.z, kx[i + 2], dot[j]);
        dot[j] = fmaf(qv.w, kx[i + 3], dot[j]);
      }
    }
  }
}

// The lanes of the warp that hold the page of lane `lane`: a page's kP
// keys are neighbouring lanes (kP a power of two up to 32).
template <int kP>
__device__ __forceinline__ unsigned page_mask(int lane) {
  return kP == 32 ? 0xffffffffu
                  : ((1u << (kP & 31)) - 1) << (lane & ~(kP - 1));
}

// What the phases of one chunk of a q-block unit share.
struct UnitChunk {
  const float* qs;            // [R][D + 4] fp32 query rows
  const unsigned char* buf;   // the chunk's staged pages
  const float* sbuf;          // their int8 row scales, [page][K, V][P]
  float* sw;                  // [page][R][P + 1] scores, then weights
  float* mcur;                // [page][R] page maxima
  const float* mnew;          // [page][R] running maxima
  const float* corr;          // [page][R] rescale factors
  const float* sums;          // [page][R] sums of the weights
  float* acc;                 // [R][D]
  float* m;                   // [R]
  float* l;                   // [R]
  const int* ctx;             // [token] contexts of the unit's tokens
  const int* npg;             // [token] their own page counts
  size_t page_bytes;          // a staged page: K rows padded, V rows packed
  int stride, row_bytes, D, R, G, first, cnt;
};

// The scores phase: thread (page p, rows r0 .. r0 + kRows - 1, key c), the
// keys' chains masked at the causal bound, and each row's page maximum by
// fmaxf across the page's P lanes (exact in any order). An item's P
// lanes are neighbours, all in or all out.
template <typename PT, int kP, int kRows>
__device__ __forceinline__ void unit_scores(const UnitChunk& u,
                                            float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const unsigned page_lanes = page_mask<kP>(lane);
  const int RQ = (u.R + kRows - 1) / kRows;
  for (int i = threadIdx.x; i < u.cnt * RQ * kP; i += kUnitThreads) {
    const int c = i % kP, pr = i / kP, rq = pr % RQ, p = pr / RQ;
    const int r0 = rq * kRows;
    const float* qr[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      qr[j] = u.qs + (size_t)min(r0 + j, u.R - 1) * (u.D + 4);
    float dot[kRows];
    dots<PT, kRows>(qr, u.buf + p * u.page_bytes + (size_t)c * u.stride,
                    kQuant ? u.sbuf[(size_t)p * 2 * kP + c] : 0.f, u.D, dot);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j, tl = min(r, u.R - 1) / u.G;
      const bool own = r < u.R && u.first + p < u.npg[tl];
      const float sc = (u.first + p) * kP + c < u.ctx[tl]
                           ? score_of(dot[j], sm_scale) : -INFINITY;
      if (own) u.sw[((size_t)p * u.R + r) * (kP + 1) + c] = sc;
      float mx = own ? sc : -INFINITY;
#pragma unroll
      for (int o = 1; o < kP; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(page_lanes, mx, o));
      if (own && c == 0) u.mcur[p * u.R + r] = mx;
    }
  }
}

// The values phase: thread (rows r0 .. r0 + kRows - 1, columns e, e + 1).
// Each page's pv chains are computed for every page of the chunk (past a
// row's own pages from stale data, then dropped), so that they run side
// by side, then acc' = acc corr + pv page after page; the thread of
// column 0 also runs l' = l corr + sum page after page and keeps m.
template <typename PT, int kP, int kRows>
__device__ __forceinline__ void unit_values(const UnitChunk& u) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int half = u.D / 2;
  const int RQ = (u.R + kRows - 1) / kRows;
  for (int i = threadIdx.x; i < RQ * half; i += kUnitThreads) {
    const int rq = i / half, e = 2 * (i - rq * half), r0 = rq * kRows;
    int row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) row[j] = min(r0 + j, u.R - 1);
    float pv[kChunk][kRows][2];
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      const unsigned char* vpage =
          u.buf + p * u.page_bytes + (size_t)kP * u.stride;
#pragma unroll
      for (int j = 0; j < kRows; ++j) pv[p][j][0] = pv[p][j][1] = 0.f;
#pragma unroll
      for (int c = 0; c < kP; ++c) {
        float v[2];
        staged2<PT>(vpage + (size_t)c * u.row_bytes, e,
                    kQuant ? u.sbuf[((size_t)p * 2 + 1) * kP + c] : 0.f, v);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float w = u.sw[((size_t)p * u.R + row[j]) * (kP + 1) + c];
          pv[p][j][0] = fmaf(w, v[0], pv[p][j][0]);
          pv[p][j][1] = fmaf(w, v[1], pv[p][j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j;
      if (r >= u.R) break;
      const int cnt_r = min(u.cnt, u.npg[r / u.G] - u.first);
      float* a = u.acc + (size_t)r * u.D + e;
      float a0 = a[0], a1 = a[1];
#pragma unroll
      for (int p = 0; p < kChunk; ++p) {
        if (p < cnt_r) {
          a0 = acc_update(a0, u.corr[p * u.R + r], pv[p][j][0]);
          a1 = acc_update(a1, u.corr[p * u.R + r], pv[p][j][1]);
        }
      }
      a[0] = a0;
      a[1] = a1;
      if (e == 0 && cnt_r > 0) {
        float lr = u.l[r];
        for (int p = 0; p < cnt_r; ++p)
          lr = l_update(lr, u.corr[p * u.R + r], u.sums[p * u.R + r]);
        u.l[r] = lr;
        u.m[r] = u.mnew[(cnt_r - 1) * u.R + r];
      }
    }
  }
}

// Kernel 6 (PT = T) and B7 (PT = int8_t), for pages of kP keys. Grid
// (units, kv_heads), fixed by the tick's shape (a captured launch keeps
// its grid while the live unit count U = *live_units changes tick by
// tick): block L, in launch order, is unit L % U of kv head L / U, so the
// first U x kv_heads blocks are the live grid in its own order and the
// blocks past them return at once.
// Unit u is units[4u .. 4u + 3] = (q-block b, owner
// slot s, first job j0, job count n): its pages are job_page[b, j0 .. j0 +
// n), the pages 0..n-1 of slot s in order; its tokens are those of block
// b with row_slot == s, in order (not a range: bucket padding shares slot
// 0). Row r of the block is token r / G of the unit, query head h * G + r
// % G.
//
// The block stages chunk k + 1 while it computes chunk k. A chunk's steps
// per row, each one the per-token kernel's arithmetic (attention_common
// .cuh), spread over threads:
//   scores  thread (page, one or four rows, key): the rows' fmaf chains,
//           masked, and each row's page max m_cur (unit_scores);
//   weights thread (page, row), or (page, row, key) when that leaves
//           threads idle: m_prev and m_new by fmaxf over the row's m_cur
//           of the pages before (exact), the weights, their sum in key
//           order (gathered by shuffles in the second form), and corr;
//   values  thread (one or four rows, two columns): the pv chains of
//           every page, then acc', l' and m page after page (unit_values).
template <typename T, typename PT, int kP>
__global__ void __launch_bounds__(kUnitThreads, 2)
qblock_unit_kernel(const T* __restrict__ q, const Pages<PT> pg,
                   T* __restrict__ out, const int* __restrict__ row_slot,
                   const int* __restrict__ row_ctx,
                   const int* __restrict__ job_page,
                   const int* __restrict__ units,
                   const int* __restrict__ live_units, int H, int KVH, int D,
                   int NP, int qb, int J, float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int P = kP;
  // a page's keys are neighbouring lanes of one warp
  static_assert(kP <= 32 && (kP & (kP - 1)) == 0, "page size");
  extern __shared__ float4 unit_smem[];
  const int live = __ldg(live_units);
  const int L = blockIdx.y * gridDim.x + blockIdx.x;
  if (L >= live * KVH) return;               // the whole block, at once
  const int u = L % live, h = L / live;
  const int G = H / KVH, Rmax = qb * G;
  const int b = units[4 * u], slot = units[4 * u + 1];
  const int n = units[4 * u + 3];
  const int* pages = job_page + (size_t)b * J + units[4 * u + 2];
  const int lane = threadIdx.x & 31;

  // A staged page: its K rows padded to `stride` bytes (lanes scoring
  // different keys at one column hit different banks), then its V rows
  // packed (lanes of one row read neighbouring columns).
  const int row_bytes = D * (int)sizeof(PT);
  const int stride = staged_row(D, sizeof(PT));
  const size_t page_bytes = (size_t)P * (stride + row_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(unit_smem);   // [2]
  unsigned char* ring = reinterpret_cast<unsigned char*>(bars + 2);
  float* scl = reinterpret_cast<float*>(ring + 2 * kChunk * page_bytes);
  float* qs = scl + (kQuant ? 2 * kChunk * 2 * P : 0);   // [Rmax][D + 4]
  float* sw = qs + (size_t)Rmax * (D + 4);   // [kChunk][R][P + 1]
  float* mcur = sw + (size_t)kChunk * Rmax * (P + 1);   // [kChunk][R]
  float* mnew = mcur + kChunk * Rmax;        // [kChunk][R]
  float* corr = mnew + kChunk * Rmax;        // [kChunk][R]
  float* sums = corr + kChunk * Rmax;        // [kChunk][R]
  float* acc = sums + kChunk * Rmax;         // [R][D]
  float* m = acc + (size_t)Rmax * D;
  float* l = m + Rmax;
  int* tok = reinterpret_cast<int*>(l + Rmax);  // [qb] the unit's tokens
  int* ctx = tok + qb;                          // their contexts
  int* npg = ctx + qb;                          // their own page counts
  int* n_tok = npg + qb;
  int* upg = n_tok + 1;                         // [n] the unit's pages

  // K rows go by 16-byte cp.async pieces (into padded rows), a thread's
  // pieces kUnitThreads apart; V pages and int8 scales by one bulk copy
  // each, completing on the buffer's mbarrier.
  const int row_chunks = row_bytes / 16;
  const int row0 = threadIdx.x / row_chunks;
  const int ch0 = threadIdx.x - row0 * row_chunks;
  const int step_rows = kUnitThreads / row_chunks;
  const int step_ch = kUnitThreads - step_rows * row_chunks;

  // Stage the pages of chunk k (pages k * kChunk ..) into buffer k & 1.
  auto stage = [&](int k) {
    const int first = k * kChunk, cnt = min(kChunk, n - first);
    unsigned char* buf = ring + (size_t)(k & 1) * kChunk * page_bytes;
    float* sbuf = scl + (size_t)(k & 1) * kChunk * 2 * P;
    uint64_t* bar = bars + (k & 1);
    if (threadIdx.x == 0) {
      fence_proxy_async();
      mbar_expect_tx(bar, cnt * P * (row_bytes + (kQuant ? 8 : 0)));
      for (int p = 0; p < cnt; ++p) {
        const size_t page0 = ((size_t)h * NP + upg[first + p]) * P;
        bulk_copy(buf + p * page_bytes + (size_t)P * stride, pg.v + page0 * D,
                  P * row_bytes, bar);
        if (kQuant) {
          bulk_copy(sbuf + (size_t)p * 2 * P, pg.ks + page0, P * 4, bar);
          bulk_copy(sbuf + (size_t)p * 2 * P + P, pg.vs + page0, P * 4, bar);
        }
      }
    }
    for (int p = 0; p < cnt; ++p) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          pg.k + ((size_t)h * NP + upg[first + p]) * P * D);
      unsigned char* dst = buf + p * page_bytes;
      int row = row0, ch = ch0;
      for (int i = threadIdx.x; i < P * row_chunks; i += kUnitThreads) {
        cp_async16(dst + (size_t)row * stride + ch * 16, src + (size_t)i * 16);
        row += step_rows;
        ch += step_ch;
        if (ch >= row_chunks) {
          ch -= row_chunks;
          ++row;
        }
      }
    }
    cp_async_commit();
  };

  for (int i = threadIdx.x; i < n; i += kUnitThreads) upg[i] = pages[i];
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_fence_init();
    int nt = 0;
    for (int r = 0; r < qb; ++r) {
      const int t = b * qb + r;
      if (row_slot[t] != slot) continue;
      tok[nt] = t;
      ctx[nt] = row_ctx[t];
      npg[nt] = min((row_ctx[t] + P - 1) / P, n);
      ++nt;
    }
    *n_tok = nt;
  }
  __syncthreads();
  stage(0);
  const int R = *n_tok * G;
  for (int i = threadIdx.x; i < R * D; i += kUnitThreads) {
    const int r = i / D, e = i - r * D;
    qs[(size_t)r * (D + 4) + e] =
        to_f32(q[((size_t)tok[r / G] * H + h * G + r % G) * D + e]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kUnitThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  const unsigned page_lanes = page_mask<P>(lane);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  for (int k = 0; k < n_chunks; ++k) {
    // buffer (k + 1) & 1 was last read by chunk k - 1, before the barrier
    if (k + 1 < n_chunks) stage(k + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    mbar_wait(bars + (k & 1), (k >> 1) & 1);
    __syncthreads();
    const int first = k * kChunk, cnt = min(kChunk, n - first);
    const unsigned char* buf = ring + (size_t)(k & 1) * kChunk * page_bytes;
    const float* sbuf = scl + (size_t)(k & 1) * kChunk * 2 * P;
    const UnitChunk uc{qs, buf, sbuf, sw, mcur, mnew, corr, sums, acc, m, l,
                       ctx, npg, page_bytes, stride, row_bytes, D, R, G,
                       first, cnt};

    // scores: four rows an item when that fills the block, else one
    if (cnt * ((R + kQuad - 1) / kQuad) * P >= kUnitThreads)
      unit_scores<PT, P, kQuad>(uc, sm_scale);
    else
      unit_scores<PT, P, 1>(uc, sm_scale);
    __syncthreads();

    // weights: one thread a (page, row) when that fills the block, else
    // one a (page, row, key), the page's sum gathered in key order by
    // shuffles across its P neighbouring lanes (all in or all out)
    if (cnt * R >= kUnitThreads / 2) {
      for (int i = threadIdx.x; i < cnt * R; i += kUnitThreads) {
        const int p = i / R, r = i - p * R;
        if (first + p >= npg[r / G]) continue;
        float m_prev = m[r], m_new = fmaxf(m_prev, mcur[r]);
        for (int pp = 1; pp <= p; ++pp) {
          m_prev = m_new;
          m_new = fmaxf(m_prev, mcur[pp * R + r]);
        }
        sums[i] = softmax_weights(sw + (size_t)i * (P + 1), P, m_new);
        corr[i] = rescale(m_prev, m_new);
        mnew[i] = m_new;
      }
    } else {
      for (int i = threadIdx.x; i < cnt * R * P; i += kUnitThreads) {
        const int c = i % P, pr = i / P, p = pr / R, r = pr - p * R;
        if (first + p >= npg[r / G]) continue;
        float m_prev = m[r], m_new = fmaxf(m_prev, mcur[r]);
        for (int pp = 1; pp <= p; ++pp) {
          m_prev = m_new;
          m_new = fmaxf(m_prev, mcur[pp * R + r]);
        }
        float* sr = sw + (size_t)pr * (P + 1);
        const float w = weight_of(sr[c], m_new);
        sr[c] = w;
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < P; ++cc)
          sum = __fadd_rn(sum,
                          __shfl_sync(page_lanes, w, (lane & ~(P - 1)) + cc));
        if (c == 0) {
          sums[pr] = sum;
          corr[pr] = rescale(m_prev, m_new);
          mnew[pr] = m_new;
        }
      }
    }
    __syncthreads();

    // values: four rows an item when that fills the block, else one
    if (((R + kQuad - 1) / kQuad) * (D / 2) >= kUnitThreads)
      unit_values<PT, P, kQuad>(uc);
    else
      unit_values<PT, P, 1>(uc);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < R * D; i += kUnitThreads) {
    const int r = i / D, e = i - r * D;
    out[((size_t)tok[r / G] * H + h * G + r % G) * D + e] =
        from_f32<T>(finish(acc[i], l[r]));
  }
}

// Kernel 6 (PT = T) and B7 (PT = int8_t), the runtime-shaped variant: the
// same units, grid and live-unit count as qblock_unit_kernel, for every
// shape that kernel does not take (page sizes other than 4, 8, 16 and 32,
// head_dim % 16 != 0, pools or scales that are not 16-byte aligned, a
// unit block that outgrows shared memory). The page size is an argument.
// Pages go to shared memory by plain element loads, converted to fp32 as
// they land (to_f32, or dequant of an int8 code by its row's scale: the
// values qblock_unit_kernel's Staged gives), c pages at a time (a chunk),
// so that a chunk's loads are in flight together and its phases, each
// ended by a barrier, run over all its pages at once:
//   scores  thread (page, one or four rows, key): the rows' fmaf chains
//           over e, the key read once for them, masked at each row's
//           causal bound;
//   maxima  thread (page, row): the page's max m_cur by fmaxf;
//   weights thread (page, row): m_prev and m_new by fmaxf over the row's
//           m_cur of the chunk's pages before (exact), the weights and
//           their sum in key order (softmax_weights), corr;
//   values  thread (row, column): per page in order, one fmaf chain over
//           the page's keys (pv), then acc' = acc corr + pv; the column-0
//           thread runs l' = l corr + sum and keeps m.
// Each row thus runs the per-token "block" kernel's steps (softmax_row's
// split in two) over its own pages in ascending order with every rounding
// point of attention_common.cuh, and its bits are kernel 8's (ROADMAP
// C21). A row past its own ceil(ctx / P) pages skips the page, as kernel
// 8 stops there. A page too large for shared memory is taken alone, in
// runs of kc keys (its pv chains carried across the runs); a unit too
// large takes its rows rt at a time (qblock_rt_plan).
template <typename T, typename PT>
__global__ void __launch_bounds__(kUnitThreads)
qblock_runtime_kernel(const T* __restrict__ q, const Pages<PT> pg,
                      T* __restrict__ out, const int* __restrict__ row_slot,
                      const int* __restrict__ row_ctx,
                      const int* __restrict__ job_page,
                      const int* __restrict__ units,
                      const int* __restrict__ live_units, int H, int KVH,
                      int D, int NP, int P, int qb, int J, int rt, int C,
                      int kc, float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float4 unit_smem[];
  const int live = __ldg(live_units);
  const int L = blockIdx.y * gridDim.x + blockIdx.x;
  if (L >= live * KVH) return;               // the whole block, at once
  const int u = L % live, h = L / live;
  const int G = H / KVH;
  const int b = units[4 * u], slot = units[4 * u + 1];
  const int n = units[4 * u + 3];
  const int* pages = job_page + (size_t)b * J + units[4 * u + 2];
  const int runs = (P + kc - 1) / kc;        // > 1 only with C == 1
  const int keys = runs > 1 ? kc : C * P;    // staged key rows
  int* tok = reinterpret_cast<int*>(unit_smem);   // [qb] the unit's tokens
  int* ctx = tok + qb;                            // their contexts
  int* npg = ctx + qb;                            // their own page counts
  int* n_tok = npg + qb;
  float* qs = reinterpret_cast<float*>(unit_smem) + rt_int_words(qb);
  float* ks = qs + (size_t)rt * (D + 1);     // [keys][D + 1] fp32
  float* vs = ks + (size_t)keys * (D + 1);   // [keys][D] fp32
  float* sw = vs + (size_t)keys * D;         // [C][rt][P] scores, weights
  float* mcur = sw + (size_t)C * rt * P;     // [C][rt] page maxima
  float* mnew = mcur + (size_t)C * rt;       // [C][rt] running maxima
  float* corr = mnew + (size_t)C * rt;       // [C][rt]
  float* sums = corr + (size_t)C * rt;       // [C][rt]
  float* acc = sums + (size_t)C * rt;        // [rt][D]
  float* pvs = acc + (size_t)rt * D;         // [rt][D] pv across runs
  float* m = pvs + (runs > 1 ? (size_t)rt * D : 0);
  float* l = m + rt;

  if (threadIdx.x == 0) {
    int nt = 0;
    for (int r = 0; r < qb; ++r) {
      const int t = b * qb + r;
      if (row_slot[t] != slot) continue;
      tok[nt] = t;
      ctx[nt] = row_ctx[t];
      npg[nt] = min((row_ctx[t] + P - 1) / P, n);
      ++nt;
    }
    *n_tok = nt;
  }
  __syncthreads();
  const int R = *n_tok * G;

  // Key rows c0 .. c0 + cnt - 1 of each of the pages first .. first + np
  // - 1 (rows of page p at p * cnt), K into ks and/or V into vs, fp32. A
  // thread takes the elements kUnitThreads apart, its position (page p,
  // row c, column e) stepped without a division, and issues kRtLoads
  // elements' loads before it stores any, so that they are in flight
  // together.
  auto stage = [&](int first, int np, int c0, int cnt, bool k, bool v) {
    const int total = np * cnt * D;
    const int dq = kUnitThreads / D, dr = kUnitThreads - dq * D;
    int e = threadIdx.x % D, pc = threadIdx.x / D;
    int p = pc / cnt, c = pc - p * cnt;
    for (int base = threadIdx.x; base < total;
         base += kUnitThreads * kRtLoads) {
      PT kx[kRtLoads], vx[kRtLoads];
      float kscale[kRtLoads], vscale[kRtLoads];
      int at[kRtLoads], row_of[kRtLoads];
#pragma unroll
      for (int j = 0; j < kRtLoads; ++j) {
        if (base + j * kUnitThreads >= total) break;
        const size_t row =
            ((size_t)h * NP + pages[first + p]) * P + c0 + c;
        if (k) kx[j] = pg.k[row * D + e];
        if (v) vx[j] = pg.v[row * D + e];
        if (kQuant && k) kscale[j] = pg.ks[row];
        if (kQuant && v) vscale[j] = pg.vs[row];
        row_of[j] = p * cnt + c;
        at[j] = row_of[j] * D + e;
        e += dr;
        c += dq;
        if (e >= D) {
          e -= D;
          ++c;
        }
        while (c >= cnt) {
          c -= cnt;
          ++p;
        }
      }
#pragma unroll
      for (int j = 0; j < kRtLoads; ++j) {
        if (base + j * kUnitThreads >= total) break;
        if (k)
          ks[at[j] + row_of[j]] = kQuant       // rows padded to D + 1
              ? dequant(to_f32(kx[j]), kscale[j]) : to_f32(kx[j]);
        if (v)
          vs[at[j]] = kQuant ? dequant(to_f32(vx[j]), vscale[j])
                             : to_f32(vx[j]);
      }
    }
  };

  // The scores of keys 0 .. nk - 1 staged for each of the chunk's cnt
  // pages (pages first ..), rows r0 .. r0 + rr - 1: a thread runs one
  // key's chains for kRows rows side by side, the key read once for them.
  auto scores = [&](auto rows_tag, int first, int cnt, int c0, int nk,
                    int r0, int rr) {
    constexpr int kRows = decltype(rows_tag)::value;
    const int RQ = (rr + kRows - 1) / kRows;
    for (int i = threadIdx.x; i < cnt * RQ * nk; i += kUnitThreads) {
      const int c = i % nk, pr = i / nk, rq = pr % RQ, p = pr / RQ;
      const float* kr = ks + (size_t)(p * nk + c) * (D + 1);
      const float* qr[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        qr[j] = qs + (size_t)min(rq * kRows + j, rr - 1) * (D + 1);
      float dot[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) dot[j] = 0.f;
      for (int e = 0; e < D; ++e) {
        const float kv = kr[e];
#pragma unroll
        for (int j = 0; j < kRows; ++j) dot[j] = fmaf(qr[j][e], kv, dot[j]);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rq * kRows + j;
        if (r >= rr) break;
        const int t = (r0 + r) / G;
        if (first + p >= npg[t]) continue;
        sw[((size_t)p * rr + r) * P + c0 + c] =
            (first + p) * P + c0 + c < ctx[t] ? score_of(dot[j], sm_scale)
                                              : -INFINITY;
      }
    }
  };

  for (int r0 = 0; r0 < R; r0 += rt) {
    const int rr = min(rt, R - r0);
    int pmax = 0;                            // the pass's last own page
    for (int t = r0 / G; t <= (r0 + rr - 1) / G; ++t) pmax = max(pmax, npg[t]);
    for (int i = threadIdx.x; i < rr * D; i += kUnitThreads) {
      const int r = i / D, e = i - r * D, row = r0 + r;
      qs[(size_t)r * (D + 1) + e] =
          to_f32(q[((size_t)tok[row / G] * H + h * G + row % G) * D + e]);
      acc[i] = 0.f;
    }
    for (int r = threadIdx.x; r < rr; r += kUnitThreads) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    __syncthreads();

    for (int first = 0; first < pmax; first += C) {
      const int cnt = min(C, pmax - first);
      // scores of the chunk's pages (or of the one page's runs of keys),
      // masked at each row's causal bound
      for (int run = 0; run < runs; ++run) {
        const int c0 = run * kc, nk = runs > 1 ? min(kc, P - c0) : P;
        stage(first, cnt, c0, nk, true, runs == 1);
        __syncthreads();
        // four rows an item when that fills the block, else one
        if (cnt * ((rr + kQuad - 1) / kQuad) * nk >= kUnitThreads)
          scores(std::integral_constant<int, kQuad>(), first, cnt, c0, nk,
                 r0, rr);
        else
          scores(std::integral_constant<int, 1>(), first, cnt, c0, nk, r0,
                 rr);
        __syncthreads();
      }
      // each (page, row)'s max, in any order (exact)
      for (int i = threadIdx.x; i < cnt * rr; i += kUnitThreads) {
        const int p = i / rr, r = i - p * rr;
        if (first + p >= npg[(r0 + r) / G]) continue;
        const float* sr = sw + (size_t)i * P;
        float mx = -INFINITY;
        for (int c = 0; c < P; ++c) mx = fmaxf(mx, sr[c]);
        mcur[i] = mx;
      }
      __syncthreads();
      // the running max before and after each page, the weights, their
      // sum and corr
      for (int i = threadIdx.x; i < cnt * rr; i += kUnitThreads) {
        const int p = i / rr, r = i - p * rr;
        if (first + p >= npg[(r0 + r) / G]) continue;
        float m_prev = m[r], m_new = fmaxf(m_prev, mcur[r]);
        for (int pp = 1; pp <= p; ++pp) {
          m_prev = m_new;
          m_new = fmaxf(m_prev, mcur[pp * rr + r]);
        }
        sums[i] = softmax_weights(sw + (size_t)i * P, P, m_new);
        corr[i] = rescale(m_prev, m_new);
        mnew[i] = m_new;
      }
      __syncthreads();
      // pv, one fmaf chain over a page's keys a value (carried across the
      // runs), then acc' = acc corr + pv page after page; l and m
      for (int run = 0; run < runs; ++run) {
        const int c0 = run * kc, nk = runs > 1 ? min(kc, P - c0) : P;
        if (runs > 1) {
          stage(first, 1, c0, nk, false, true);
          __syncthreads();
        }
        for (int i = threadIdx.x; i < rr * D; i += kUnitThreads) {
          const int r = i / D, e = i - r * D;
          const int own = min(cnt, npg[(r0 + r) / G] - first);
          float a = acc[i];
          for (int p = 0; p < own; ++p) {
            const float* wr = sw + ((size_t)p * rr + r) * P + c0;
            const float* vc = vs + (size_t)p * nk * D + e;
            float pv = run == 0 ? 0.f : pvs[i];
            for (int c = 0; c < nk; ++c)
              pv = fmaf(wr[c], vc[(size_t)c * D], pv);
            if (run + 1 < runs) pvs[i] = pv;
            else a = acc_update(a, corr[p * rr + r], pv);
          }
          acc[i] = a;
          if (e == 0 && run + 1 == runs && own > 0) {
            float lr = l[r];
            for (int p = 0; p < own; ++p)
              lr = l_update(lr, corr[p * rr + r], sums[p * rr + r]);
            l[r] = lr;
            m[r] = mnew[(own - 1) * rr + r];
          }
        }
        __syncthreads();
      }
    }

    for (int i = threadIdx.x; i < rr * D; i += kUnitThreads) {
      const int r = i / D, e = i - r * D, row = r0 + r;
      out[((size_t)tok[row / G] * H + h * G + row % G) * D + e] =
          from_f32<T>(finish(acc[i], l[r]));
    }
    __syncthreads();
  }
}

template <typename T, typename PT, int kP>
cudaError_t launch_qblock_p(const void* q, const Pages<PT>& pg, void* out,
                            const int* rs, const int* rc, const int* jp,
                            const int* units, const int* live, int H,
                            int KVH, int D, int NP, int qb, int U, int J,
                            int pps, float sm_scale, cudaStream_t stream) {
  const size_t smem =
      unit_smem_bytes(sizeof(PT), std::is_same<PT, int8_t>::value,
                      qb * (H / KVH), kP, D, qb, min(J, pps));
  cudaError_t err = cudaFuncSetAttribute(
      qblock_unit_kernel<T, PT, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  qblock_unit_kernel<T, PT, kP><<<dim3(U, KVH), kUnitThreads, smem, stream>>>(
      (const T*)q, pg, (T*)out, rs, rc, jp, units, live, H, KVH, D, NP, qb,
      J, sm_scale);
  return cudaGetLastError();
}

// The unit kernel for pages of kP keys, after the checks its copies need:
// cp.async and bulk copies take 16-byte rows, pools and scales.
template <typename T, typename PT, int kP>
cudaError_t launch_qblock_unit(const void* q, const Pages<PT>& pg, void* out,
                               const int* rs, const int* rc, const int* jp,
                               const int* units, const int* live, int H,
                               int KVH, int D, int NP, int qb, int U, int J,
                               int pps, float sm_scale, cudaStream_t stream) {
  const bool aligned =
      !((reinterpret_cast<uintptr_t>(pg.k) | reinterpret_cast<uintptr_t>(pg.v)
         | reinterpret_cast<uintptr_t>(pg.ks)
         | reinterpret_cast<uintptr_t>(pg.vs)) & 15);
  if (D % 16 || H % KVH || pps <= 0 || !aligned) return cudaErrorInvalidValue;
  return launch_qblock_p<T, PT, kP>(q, pg, out, rs, rc, jp, units, live, H,
                                    KVH, D, NP, qb, U, J, pps, sm_scale,
                                    stream);
}

inline size_t smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)bytes;
}

template <typename T, typename PT>
cudaError_t launch_qblock_rt(const void* q, const Pages<PT>& pg, void* out,
                             const int* rs, const int* rc, const int* jp,
                             const int* units, const int* live, int H,
                             int KVH, int D, int NP, int P, int qb, int U,
                             int J, float sm_scale, cudaStream_t stream) {
  int plan[3];
  if (D <= 0 || P <= 0 || H % KVH ||
      !qblock_rt_plan(qb * (H / KVH), P, D, qb, smem_optin(), plan))
    return cudaErrorInvalidValue;
  const int rt = plan[0], C = plan[1], kc = plan[2];
  const size_t smem = rt_smem_bytes(P, D, qb, rt, C, kc);
  cudaError_t err = cudaFuncSetAttribute(
      qblock_runtime_kernel<T, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  qblock_runtime_kernel<T, PT><<<dim3(U, KVH), kUnitThreads, smem, stream>>>(
      (const T*)q, pg, (T*)out, rs, rc, jp, units, live, H, KVH, D, NP, P,
      qb, J, rt, C, kc, sm_scale);
  return cudaGetLastError();
}


}  // namespace

// The C entry points of the unit kernel for pages of P keys (P a literal):
// ptt_ragged_qblock_p<P> (native pages) and ptt_ragged_qblock_p<P>_q8
// (int8 pages with fp32 row scales), the operands of the runtime kernel's
// entry points plus the block table's width pps. dtype (of q and out): 0
// float32, 1 bfloat16, 2 float16; the native-page functions also take 3
// (bfloat16 q and out over float32 pages) and 4 (float16 over float32).
// Every pointer is a device pointer of a
// contiguous tensor. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for D % 16 != 0 or pools and scales that are not
// 16-byte aligned).
#define PTT_QBLOCK_UNIT_ENTRIES(P)                                            \
  extern "C" int ptt_ragged_qblock_p##P(                                      \
      int dtype, const void* q, const void* kp, const void* vp, void* out,    \
      const int* row_slot, const int* row_ctx, const int* job_page,           \
      const int* units, const int* n_units, int T_tok, int H, int KVH,        \
      int D, int NP, int qb, int U, int J, int pps, float sm_scale,           \
      void* stream) {                                                         \
    if (T_tok <= 0 || U <= 0) return (int)cudaSuccess;                        \
    cudaStream_t s = (cudaStream_t)stream;                                    \
    switch (dtype) {                                                          \
      case 0: return (int)launch_qblock_unit<float, float, P>(                \
          q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page,   \
          units, n_units, H, KVH, D, NP, qb, U, J, pps, sm_scale, s);         \
      case 1: return (int)launch_qblock_unit<__nv_bfloat16, __nv_bfloat16,    \
                                             P>(                              \
          q, native_pages<__nv_bfloat16>(kp, vp), out, row_slot, row_ctx,     \
          job_page, units, n_units, H, KVH, D, NP, qb, U, J, pps, sm_scale,   \
          s);                                                                 \
      case 2: return (int)launch_qblock_unit<__half, __half, P>(              \
          q, native_pages<__half>(kp, vp), out, row_slot, row_ctx, job_page,  \
          units, n_units, H, KVH, D, NP, qb, U, J, pps, sm_scale, s);         \
      case 3: return (int)launch_qblock_unit<__nv_bfloat16, float, P>(        \
          q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page,   \
          units, n_units, H, KVH, D, NP, qb, U, J, pps, sm_scale, s);         \
      case 4: return (int)launch_qblock_unit<__half, float, P>(               \
          q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page,   \
          units, n_units, H, KVH, D, NP, qb, U, J, pps, sm_scale, s);         \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  }                                                                           \
  extern "C" int ptt_ragged_qblock_p##P##_q8(                                 \
      int dtype, const void* q, const void* kp, const void* vp,               \
      const float* ks, const float* vs, void* out, const int* row_slot,       \
      const int* row_ctx, const int* job_page, const int* units,              \
      const int* n_units, int T_tok, int H, int KVH, int D, int NP, int qb,   \
      int U, int J, int pps, float sm_scale, void* stream) {                  \
    if (T_tok <= 0 || U <= 0) return (int)cudaSuccess;                        \
    cudaStream_t s = (cudaStream_t)stream;                                    \
    const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);                      \
    switch (dtype) {                                                          \
      case 0: return (int)launch_qblock_unit<float, int8_t, P>(               \
          q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH,    \
          D, NP, qb, U, J, pps, sm_scale, s);                                 \
      case 1: return (int)launch_qblock_unit<__nv_bfloat16, int8_t, P>(       \
          q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH,    \
          D, NP, qb, U, J, pps, sm_scale, s);                                 \
      case 2: return (int)launch_qblock_unit<__half, int8_t, P>(              \
          q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH,    \
          D, NP, qb, U, J, pps, sm_scale, s);                                 \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  }
