// Kernel 6 and B7, the "unit" variant for pages of 32 keys
// (qblock_unit_kernel in qblock.cuh), built on its own so that nvcc
// compiles the page sizes side by side.
#include "qblock.cuh"

PTT_QBLOCK_UNIT_ENTRIES(32)
