// Kernel 6 and B7, the "runtime" variant (qblock_runtime_kernel in
// qblock.cuh): every shape the unit kernel does not take. Plain C
// interface, bound with ctypes; the operands are those of the unit
// kernel's entry points (qblock.cuh, PTT_QBLOCK_UNIT_ENTRIES) but the table
// width; any P >= 1, any D, any alignment.
#include "qblock.cuh"

extern "C" {

// Refuses a unit no row of which fits shared memory.
int ptt_ragged_qblock_rt(int dtype, const void* q, const void* kp,
                         const void* vp, void* out, const int* row_slot,
                         const int* row_ctx, const int* job_page,
                         const int* units, const int* n_units, int T_tok,
                         int H, int KVH, int D, int NP, int P, int qb, int U,
                         int J, float sm_scale, void* stream) {
  if (T_tok <= 0 || U <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_qblock_rt<float>(q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 1: return (int)launch_qblock_rt<__nv_bfloat16>(q, native_pages<__nv_bfloat16>(kp, vp), out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 2: return (int)launch_qblock_rt<__half>(q, native_pages<__half>(kp, vp), out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 3: return (int)launch_qblock_rt<__nv_bfloat16>(q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 4: return (int)launch_qblock_rt<__half>(q, native_pages<float>(kp, vp), out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ptt_ragged_qblock_rt_q8(int dtype, const void* q, const void* kp,
                            const void* vp, const float* ks, const float* vs,
                            void* out, const int* row_slot,
                            const int* row_ctx, const int* job_page,
                            const int* units, const int* n_units, int T_tok,
                            int H, int KVH, int D, int NP, int P, int qb,
                            int U, int J, float sm_scale, void* stream) {
  if (T_tok <= 0 || U <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Pages<int8_t> pg = int8_pages(kp, vp, ks, vs);
  switch (dtype) {
    case 0: return (int)launch_qblock_rt<float>(q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 1: return (int)launch_qblock_rt<__nv_bfloat16>(q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    case 2: return (int)launch_qblock_rt<__half>(q, pg, out, row_slot, row_ctx, job_page, units, n_units, H, KVH, D, NP, P, qb, U, J, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The runtime-shaped kernel's plan on this device: the rows a pass, the
// pages a chunk and the keys a run go to plan[0..2]; returns the dynamic
// shared memory of a block in bytes (0: no plan fits).
int ptt_ragged_qblock_rt_smem(int H, int KVH, int D, int P, int qb,
                              int* plan) {
  if (!qblock_rt_plan(qb * (H / KVH), P, D, qb, smem_optin(), plan))
    return 0;
  return (int)rt_smem_bytes(P, D, qb, plan[0], plan[1], plan[2]);
}

}  // extern "C"
