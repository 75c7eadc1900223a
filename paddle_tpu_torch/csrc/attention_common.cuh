// Device helpers shared by the paged attention kernels (ragged q-block,
// ragged per-token, paged decode, each over native or int8 pages):
// element conversion (of single values, and of page rows staged raw in
// shared memory: Staged, staged2, the exact int8 code_f32), the page
// operands, the per-row arithmetic of the online softmax, and the
// shared-memory tile that holds R query rows against one KV page and runs
// one online-softmax step over it.
//
// The recurrence, per query row, over KV pages in ascending order:
//   m' = max(m, max_p s), w = exp(s - m'), c = exp(m - m'),
//   l' = l c + sum w, acc' = acc c + w V,   out = acc / max(l, 1e-30)
// in fp32 whatever the input type.
//
// The per-row arithmetic below (score_of, weight_of, softmax_weights,
// rescale, l_update, acc_update, finish, dequant) is shared by every
// kernel that must give the same bits as another (ROADMAP C21: the
// q-block kernels and the per-token ones). Each rounding point is
// spelled out: an fmaf where a multiply feeds an add, __fmul_rn /
// __fsub_rn / __fadd_rn elsewhere, which nvcc never contracts into an
// fma, so two kernels that call these helpers on the same values in the
// same order produce the same bits whatever else the compiler does
// around them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// The score of a key: the dot product (one fmaf chain over e = 0..D-1
// from 0.f, in the caller) times the softmax scale.
__device__ __forceinline__ float score_of(float dot, float sm_scale) {
  return __fmul_rn(dot, sm_scale);
}

// An int8 page value: its code (as an fp32 value, which is exact) times
// its row's scale, one fp32 product (the reference's dequantisation
// before both dots).
__device__ __forceinline__ float dequant(float code, float scale) {
  return __fmul_rn(code, scale);
}

// The parts of one row's online-softmax step over a page's P masked
// scores s[0..P), in key order:
//   m_cur = fmaxf over s from -inf (exact: any order gives the same max),
//   m_new = fmaxf(m_prev, m_cur),
//   w = exp(s - m_new), written over the scores, and their sum from 0.f,
//   corr = exp(m_prev - m_new),   l = l corr + sum.
__device__ __forceinline__ float weight_of(float s, float m_new) {
  return expf(__fsub_rn(s, m_new));
}

__device__ __forceinline__ float softmax_weights(float* s, int P,
                                                 float m_new) {
  float sum = 0.f;
#pragma unroll 16
  for (int c = 0; c < P; ++c) {
    const float w = weight_of(s[c], m_new);
    s[c] = w;
    sum = __fadd_rn(sum, w);
  }
  return sum;
}

__device__ __forceinline__ float rescale(float m_prev, float m_new) {
  return expf(__fsub_rn(m_prev, m_new));
}

__device__ __forceinline__ float l_update(float l, float corr, float sum) {
  return fmaf(l, corr, sum);
}

// The whole step for one row, as one thread runs it: updates m and l and
// returns corr.
__device__ __forceinline__ float softmax_row(float* s, int P, float& m,
                                             float& l) {
  const float m_prev = m;
  float m_cur = -INFINITY;
  for (int c = 0; c < P; ++c) m_cur = fmaxf(m_cur, s[c]);
  const float m_new = fmaxf(m_prev, m_cur);
  const float sum = softmax_weights(s, P, m_new);
  const float corr = rescale(m_prev, m_new);
  l = l_update(l, corr, sum);
  m = m_new;
  return corr;
}

// acc' = acc corr + pv, where pv is the page's fmaf chain over its P keys
// from 0.f (in the caller).
__device__ __forceinline__ float acc_update(float acc, float corr, float pv) {
  return fmaf(acc, corr, pv);
}

// The output of a row: acc / max(l, 1e-30), before the cast to q's type.
__device__ __forceinline__ float finish(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-30f));
}

// The fp32 value of int8 code i (0..3) of a word whose bytes were XORed
// with 0x80 (code + 128, unsigned): the byte in the mantissa of 2^23, less
// 2^23 + 128. Exact, as (float)code is, in two full-rate instructions.
__device__ __forceinline__ float code_f32(uint32_t biased, int i) {
  return __fsub_rn(__int_as_float((int)__byte_perm(biased, 0x4B000000u,
                                                   0x7650u + i)),
                   8388736.0f);
}

// Converts 16 staged bytes of a page row into fp32 values, exactly as the
// per-token kernel stages them (to_f32, or dequant for int8 codes).
template <typename PT> struct Staged;
template <> struct Staged<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void cvt(uint4 raw, float, float* x) {
    x[0] = __uint_as_float(raw.x); x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z); x[3] = __uint_as_float(raw.w);
  }
};
template <> struct Staged<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void cvt(uint4 raw, float, float* x) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = to_f32(__ushort_as_bfloat16((unsigned short)(w[i] & 0xffffu)));
      x[2 * i + 1] = to_f32(__ushort_as_bfloat16((unsigned short)(w[i] >> 16)));
    }
  }
};
template <> struct Staged<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void cvt(uint4 raw, float, float* x) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = to_f32(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      x[2 * i + 1] = to_f32(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};
template <> struct Staged<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void cvt(uint4 raw, float scale, float* x) {
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                           raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = dequant(code_f32(w[i / 4], i % 4), scale);
  }
};

// Values e and e + 1 of a staged V row (e even), as the per-token kernel
// stages them.
template <typename PT>
__device__ __forceinline__ void staged2(const unsigned char* row, int e,
                                        float scale, float (&v)[2]);
template <>
__device__ __forceinline__ void staged2<float>(const unsigned char* row, int e,
                                               float, float (&v)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(row + 4 * e);
  v[0] = x.x;
  v[1] = x.y;
}
template <>
__device__ __forceinline__ void staged2<__nv_bfloat16>(const unsigned char* row,
                                                       int e, float,
                                                       float (&v)[2]) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(row + 2 * e);
  v[0] = to_f32(__ushort_as_bfloat16((unsigned short)(x & 0xffffu)));
  v[1] = to_f32(__ushort_as_bfloat16((unsigned short)(x >> 16)));
}
template <>
__device__ __forceinline__ void staged2<__half>(const unsigned char* row,
                                                int e, float, float (&v)[2]) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(row + 2 * e);
  v[0] = to_f32(__ushort_as_half((unsigned short)(x & 0xffffu)));
  v[1] = to_f32(__ushort_as_half((unsigned short)(x >> 16)));
}
template <>
__device__ __forceinline__ void staged2<int8_t>(const unsigned char* row,
                                                int e, float scale,
                                                float (&v)[2]) {
  const uint32_t x =
      (uint32_t)*reinterpret_cast<const unsigned short*>(row + e) ^ 0x8080u;
  v[0] = dequant(code_f32(x, 0), scale);
  v[1] = dequant(code_f32(x, 1), scale);
}

// Shared memory of one block: R query rows against one page of P keys of
// width D. q and k rows are padded to D + 1 floats so that lanes reading
// different rows at the same column hit different banks.
struct Tile {
  float* q;     // [R][D + 1]
  float* k;     // [P][D + 1]
  float* v;     // [P][D]
  float* s;     // [R][P] scores, then weights
  float* acc;   // [R][D]
  float* m;     // [R]
  float* l;     // [R]
  float* corr;  // [R]
};

__host__ __device__ inline size_t smem_floats(int R, int P, int D) {
  return (size_t)R * (D + 1) + (size_t)P * (D + 1) + (size_t)P * D +
         (size_t)R * P + (size_t)R * D + 3 * (size_t)R;
}

__device__ inline Tile carve(float* base, int R, int P, int D) {
  Tile t;
  t.q = base;
  t.k = t.q + (size_t)R * (D + 1);
  t.v = t.k + (size_t)P * (D + 1);
  t.s = t.v + (size_t)P * D;
  t.acc = t.s + (size_t)R * P;
  t.m = t.acc + (size_t)R * D;
  t.l = t.m + R;
  t.corr = t.l + R;
  return t;
}

// acc = 0, l = 0, m = -inf for every row.
__device__ inline void init_state(const Tile& t, int R, int D) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) t.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = -INFINITY;
    t.l[r] = 0.f;
  }
}

// Stage page `page` of kv head `h` (pages laid out [KVH, NP, P, D]).
template <typename T>
__device__ inline void load_page(const Tile& t, const T* __restrict__ kp,
                                 const T* __restrict__ vp, int h, int page,
                                 int NP, int P, int D) {
  const size_t base = ((size_t)h * NP + page) * (size_t)P * D;
  for (int i = threadIdx.x; i < P * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    t.k[r * (D + 1) + c] = to_f32(kp[base + i]);
    t.v[i] = to_f32(vp[base + i]);
  }
}

// The K and V page pools of a kernel, [KVH, NP, P, D]: native pages of
// type PT (the scales unused), or int8 codes with one fp32 scale per
// (kv head, page, slot) row, [KVH, NP, P].
template <typename PT>
struct Pages {
  const PT* k;
  const PT* v;
  const float* ks;
  const float* vs;
};

// Host side: native pages are of q's type T; int8 pages carry their scales.
template <typename T>
inline Pages<T> native_pages(const void* kp, const void* vp) {
  return Pages<T>{(const T*)kp, (const T*)vp, nullptr, nullptr};
}

inline Pages<int8_t> int8_pages(const void* kp, const void* vp,
                                const float* ks, const float* vs) {
  return Pages<int8_t>{(const int8_t*)kp, (const int8_t*)vp, ks, vs};
}

template <typename T>
__device__ inline void load_page(const Tile& t, const Pages<T>& pg, int h,
                                 int page, int NP, int P, int D) {
  load_page(t, pg.k, pg.v, h, page, NP, P, D);
}

// Stage an int8 page dequantised as the reference's quant kernels do
// (ragged_paged_attention.py:280-281, paged_attention.py:116-117): each
// row's codes times its scale, one fp32 product, before both dots.
__device__ inline void load_page_q8(const Tile& t,
                                    const int8_t* __restrict__ kp,
                                    const int8_t* __restrict__ vp,
                                    const float* __restrict__ ks,
                                    const float* __restrict__ vs, int h,
                                    int page, int NP, int P, int D) {
  const size_t row0 = ((size_t)h * NP + page) * (size_t)P;
  const size_t base = row0 * D;
  for (int i = threadIdx.x; i < P * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    t.k[r * (D + 1) + c] = dequant(to_f32(kp[base + i]), ks[row0 + r]);
    t.v[i] = dequant(to_f32(vp[base + i]), vs[row0 + r]);
  }
}

__device__ inline void load_page(const Tile& t, const Pages<int8_t>& pg,
                                 int h, int page, int NP, int P, int D) {
  load_page_q8(t, pg.k, pg.v, pg.ks, pg.vs, h, page, NP, P, D);
}

// Raw scaled dot product of query row r with key row c.
__device__ inline float score(const Tile& t, int r, int c, int D,
                              float sm_scale) {
  const float* qr = t.q + (size_t)r * (D + 1);
  const float* kr = t.k + (size_t)c * (D + 1);
  float dot = 0.f;
  for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kr[e], dot);
  return score_of(dot, sm_scale);
}

// One online-softmax step over the masked scores in t.s. Ends synchronised.
__device__ inline void online_step(const Tile& t, int R, int P, int D) {
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    t.corr[r] = softmax_row(t.s + (size_t)r * P, P, t.m[r], t.l[r]);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, e = i - r * D;
    const float* wr = t.s + (size_t)r * P;
    float pv = 0.f;
    for (int c = 0; c < P; ++c) pv = fmaf(wr[c], t.v[(size_t)c * D + e], pv);
    t.acc[i] = acc_update(t.acc[i], t.corr[r], pv);
  }
  __syncthreads();
}

}  // namespace

// Every kernel library exports this beside its kernels, for the wrapper's
// error messages.
extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
