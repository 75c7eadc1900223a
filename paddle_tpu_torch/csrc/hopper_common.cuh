// Hopper (sm_90a) building blocks for the tensor-core and paged-attention
// kernels, in raw PTX so that a source builds in seconds without CUTLASS:
//   - mbarrier init / arrive / expect_tx / parity wait;
//   - 16-byte cp.async copies with commit groups, and 1-D bulk copies
//     (TMA) completing on an mbarrier;
//   - TMA (cp.async.bulk.tensor) loads of one 64-column box of a rank-4
//     tensor, or of one 128-byte-wide box of a 2-D tensor of 1- or
//     2-byte elements, into 128-byte-swizzled shared memory, and the host
//     encoding of their tensor maps (cuTensorMapEncodeTiled, fetched
//     through cudaGetDriverEntryPoint so the library needs no -lcuda);
//   - setmaxnreg, to move registers from a producer warpgroup to the
//     consumers;
//   - wgmma shared-memory descriptors for 128-byte-swizzled tiles, and
//     the warpgroup products m64n{64,128}k16 with A and B both K-major in
//     shared memory, m64n{64,128}k16 with A in registers and B MN-major
//     in shared memory, and m64n{8,16,32,64,128}k16 with A in registers
//     and B K-major in shared memory, fp32 accumulators, for bf16 and
//     fp16.
//
// Shared-memory tile layout used throughout: a box of R rows x 64 columns
// of a 16-bit type, 128 bytes a row, rows consecutive, the 16-byte chunks
// of row r XOR-permuted by r % 8 (what TMA's CU_TENSOR_MAP_SWIZZLE_128B
// writes). A tile of D columns is D / 64 such boxes one after the other.
// A box of 1-byte elements is the same 128 bytes a row: 128 columns.
// Every box starts on a 1024-byte boundary (eight rows, one swizzle
// period), so descriptors carry base offset 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed. A fresh
// barrier is in phase 0, so waiting on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- cp.async

// One 16-byte copy from global to shared memory, cached in L2 only. Both
// addresses 16-byte aligned. Completes with the thread's commit group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Returns once at most N of this thread's commit groups are still in
// flight; a __syncthreads() after it makes every thread's copies visible.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One bulk copy (TMA, 1-D) of `bytes` from global to shared memory that
// completes on `bar` as transaction bytes. Addresses 16-byte aligned,
// bytes a multiple of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy (TMA) ones, e.g. a refill of a buffer just read.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Loads the box at (column `col`, row `row`) of (`head`, `batch`) of a map
// made by encode_rows_map; `order` says where its outer axes went.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int col, int row,
                                              int head, int batch, int order) {
  const int pr = order & 3, ph = (order >> 2) & 3;
  const int c1 = pr == 1 ? row : ph == 1 ? head : batch;
  const int c2 = pr == 2 ? row : ph == 2 ? head : batch;
  const int c3 = pr == 3 ? row : ph == 3 ? head : batch;
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

// Loads the box at (column `col`, row `row`) of a map made by
// encode_2d_map.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// Host: libcuda's cuTensorMapEncodeTiled, looked up through the CUDA
// runtime's entry-point query (no link against libcuda). Null if the
// installed libcuda lacks it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Host: a tensor map over a rank-4 tensor of 16-bit elements with unit
// stride along its D columns and element strides `ss`, `sh`, `sb` along
// its S rows, H heads and B batches (any order in memory, e.g. the
// [b, s, h, d] views SDPA passes). One box is 64 columns x `box_rows`
// rows of one (head, batch), 128-byte swizzled; rows past S read as zero.
// The outer axes go into the map in order of stride, axes of extent 1
// last with packed strides (their coordinate is always 0), and `order`
// gets the positions (1-3) of the row and head axes, two bits each, for
// tma_load_rows. Needs a 16-byte-aligned base and strides of a multiple of
// 16 bytes on every axis of extent > 1; returns cudaErrorInvalidValue
// otherwise or if cuTensorMapEncodeTiled refuses the map.
inline cudaError_t encode_rows_map(CUtensorMap* map, CUtensorMapDataType dt,
                                   const void* base, int D, int S, int H, int B,
                                   long long ss, long long sh, long long sb,
                                   int box_rows, int* order) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0)
    return cudaErrorInvalidValue;
  const long long ext[3] = {S, H, B};
  const long long stride[3] = {ss * 2, sh * 2, sb * 2};  // bytes
  int ax[3] = {0, 1, 2};
  // sort by (extent == 1, stride): three items, insertion order
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0; --j) {
      const int x = ax[j - 1], y = ax[j];
      const bool swap = (ext[x] == 1) != (ext[y] == 1)
                            ? ext[x] == 1
                            : (ext[x] != 1 && stride[x] > stride[y]);
      if (!swap) break;
      ax[j - 1] = y;
      ax[j] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  long long packed = (long long)D * 2;  // bytes spanned by the inner axes
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    const int x = ax[i];
    long long st = stride[x];
    if (ext[x] == 1) st = (packed + 15) / 16 * 16;
    if (st % 16 != 0 || st <= 0) return cudaErrorInvalidValue;
    dims[i + 1] = (cuuint64_t)ext[x];
    strides[i] = (cuuint64_t)st;
    if (x == 0) box[i + 1] = (cuuint32_t)box_rows;
    pos[x] = i + 1;
    packed = st * ext[x];
  }
  *order = pos[0] | (pos[1] << 2);
  const CUresult r = encode(
      map, dt, 4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a tensor map over a row-major 2-D tensor of `rows` rows of `cols`
// elements of `elem_bytes` (1: dt CU_TENSOR_MAP_DATA_TYPE_UINT8, e.g. int8
// codes; 2: bf16 or fp16), consecutive rows `row_bytes` apart. One box is
// the 128 bytes of a row that start at a multiple of 128 bytes (128
// 1-byte or 64 2-byte columns) x `box_rows` rows, 128-byte swizzled;
// elements past either edge read as zero (and still count in the
// barrier's transaction bytes). Needs a 16-byte-aligned base, `row_bytes`
// a positive multiple of 16 and 1 <= box_rows <= 256; returns
// cudaErrorInvalidValue otherwise or if cuTensorMapEncodeTiled refuses
// the map.
inline cudaError_t encode_2d_map(CUtensorMap* map, CUtensorMapDataType dt,
                                 int elem_bytes, const void* base,
                                 long long cols, long long rows,
                                 long long row_bytes, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      (elem_bytes != 1 && elem_bytes != 2) || cols <= 0 || rows <= 0 ||
      row_bytes <= 0 || row_bytes % 16 != 0 || box_rows < 1 || box_rows > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, dt, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand at `p` (layout type 1).
// K-major (rows of the K extent, 64 values a row): `sbo` = 1024, the
// stride between 8-row groups; `lbo` unused. MN-major (rows of the K
// extent holding 64 MN values): `sbo` = 1024 between groups of 8 K rows,
// `lbo` the stride between 64-wide MN boxes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products, and keeps an A fragment's registers
// allocated until the product that reads them has completed.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Moves registers between warpgroups (every thread of the warpgroup
// executes it): a producer gives its spare registers up, consumers take
// them, up to R a thread.
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

#define PTT_D32                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define PTT_D64                                                             \
  PTT_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"
#define PTT_F8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define PTT_F32 PTT_F8(0), PTT_F8(8), PTT_F8(16), PTT_F8(24)
#define PTT_F64 PTT_F32, PTT_F8(32), PTT_F8(40), PTT_F8(48), PTT_F8(56)

// Wgmma<T>: d (+)= A B for one k16 step, per warpgroup, fp32 accumulators
// in the standard fragment (thread t, warp w = t / 32, lane l: register i
// holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
// + i % 2). `scale_d` 0 overwrites d.
//   ss128: A (64 x 16) and B (16 x 128) both K-major in shared memory;
//   ss64:  the same with B 16 x 64 (32 accumulators a thread);
//   rs:    A from registers (the fragment of the accumulator's layout, two
//          values of T in each 32-bit register), B (16 x N) MN-major.
template <typename T> struct Wgmma;

#define PTT_WGMMA(T, TY, PACK)                                                \
  template <> struct Wgmma<T> {                                               \
    static __device__ __forceinline__ void ss128(float (&d)[64], uint64_t da,  \
                                                 uint64_t db, int scale_d) {   \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
          PTT_D64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                          \
          : PTT_F64 : "l"(da), "l"(db), "r"(scale_d));                        \
    }                                                                         \
    static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t da,   \
                                                uint64_t db, int scale_d) {    \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
          PTT_D32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                          \
          : PTT_F32 : "l"(da), "l"(db), "r"(scale_d));                        \
    }                                                                         \
    static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0,     \
                                              uint32_t a1, uint32_t a2,        \
                                              uint32_t a3, uint64_t db,        \
                                              int scale_d) {                   \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
          PTT_D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"            \
          : PTT_F64                                                           \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));       \
    }                                                                         \
    static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0,     \
                                              uint32_t a1, uint32_t a2,        \
                                              uint32_t a3, uint64_t db,        \
                                              int scale_d) {                   \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
          PTT_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"            \
          : PTT_F32                                                           \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));       \
    }                                                                         \
    /* two fp32 values rounded to T, `lo` in the low half */                  \
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {      \
      const auto h = PACK(lo, hi);                                            \
      return *reinterpret_cast<const uint32_t*>(&h);                          \
    }                                                                         \
  };

PTT_WGMMA(__nv_bfloat16, "bf16", __floats2bfloat162_rn)
PTT_WGMMA(__half, "f16", __floats2half2_rn)

// WgmmaRsK<T, N>::mma: d (+)= A B for one k16 step, m64nNk16, per
// warpgroup: A from registers (the fragment of `rs`: thread t, warp w,
// lane l holds rows 16 w + l / 4 (+ 8), columns 2 (l % 4) (+ 1, + 8, + 9)
// of the 64 x 16 step, two values of T in each 32-bit register: a0 row
// r columns c, c + 1; a1 row r + 8; a2 row r, columns c + 8, c + 9; a3
// row r + 8), B (16 x N) K-major in shared memory: N rows of the K
// extent, 128-byte swizzled, as ss128 reads its B (descriptor lbo 16, sbo
// 1024; a k16 step is 32 bytes into the row). N / 2 fp32 accumulators a
// thread in the standard fragment. N in {8, 16, 32, 64, 128}.
template <typename T, int N> struct WgmmaRsK;

#define PTT_D4 "%0, %1, %2, %3"
#define PTT_D8 PTT_D4 ", %4, %5, %6, %7"
#define PTT_D16 PTT_D8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define PTT_F4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define PTT_F16 PTT_F8(0), PTT_F8(8)
#define PTT_RSK(T, TY, N, DREGS, FOUT, AB, SD)                               \
  template <> struct WgmmaRsK<T, N> {                                        \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],            \
                                               uint32_t a0, uint32_t a1,     \
                                               uint32_t a2, uint32_t a3,     \
                                               uint64_t db, int scale_d) {   \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " SD ", 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"   \
          DREGS "}, " AB ", p, 1, 1, 0;\n}\n"                                \
          : FOUT                                                             \
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));      \
    }                                                                        \
  };
#define PTT_RSK_ALL(T, TY)                                                   \
  PTT_RSK(T, TY, 8, PTT_D4, PTT_F4, "{%4, %5, %6, %7}, %8", "%9")            \
  PTT_RSK(T, TY, 16, PTT_D8, PTT_F8(0), "{%8, %9, %10, %11}, %12", "%13")    \
  PTT_RSK(T, TY, 32, PTT_D16, PTT_F16, "{%16, %17, %18, %19}, %20", "%21")   \
  PTT_RSK(T, TY, 64, PTT_D32, PTT_F32, "{%32, %33, %34, %35}, %36", "%37")   \
  PTT_RSK(T, TY, 128, PTT_D64, PTT_F64, "{%64, %65, %66, %67}, %68", "%69")

PTT_RSK_ALL(__nv_bfloat16, "bf16")
PTT_RSK_ALL(__half, "f16")

#undef PTT_RSK_ALL
#undef PTT_RSK
#undef PTT_F16
#undef PTT_F4
#undef PTT_D16
#undef PTT_D8
#undef PTT_D4
#undef PTT_WGMMA
#undef PTT_F64
#undef PTT_F32
#undef PTT_F8
#undef PTT_D64
#undef PTT_D32

}  // namespace
