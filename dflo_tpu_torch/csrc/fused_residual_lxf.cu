// Fused DG residual with the local Lax-Friedrichs flux, hand-written for
// Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual with
// flux_name="lxf" on the collocated nodal Qk basis, masked (the forward
// step's solid-cell mask, pallas_kernels.py:287-292, :472-533, :598-599)
// or not: the kernel of fused_residual.cu (residual.cuh) instantiated with
// FLUX = LXF.  Each face's dissipation speed is the larger |v.n| + c of
// the two cells' averages (src/assemble_explicit.cc:335-340), so every cell
// also forms its own average and each neighbor's, from the loads its traces
// make anyway; at a fluid|solid face the solid side's trace and average are
// the slip-wall mirror of the fluid side's.
//
// What bounds it on the H100: bytes, as fused_residual.cu (each cell reads
// its own 4K values and its four neighbors', about 5x the state through
// L1/L2, and writes 4K); LxF costs fewer operations per face point than
// HLLC.  Its own source so that nvcc builds it beside fused_residual.cu.
#include <stdint.h>

#include "residual.cuh"

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3} (collocated Qk).  Forms
// and mask as dflo_fused_residual.  Returns the cudaGetLastError() code
// after the launch (0 = launched), -1 for an unsupported case.
extern "C" int dflo_fused_residual_lxf(int dtype, int p, const void* u,
                                       const void* dfw, const void* dfe,
                                       const void* dfs, const void* dfn,
                                       const void* uold, const void* sc,
                                       const void* ops, const void* mask,
                                       void* out, int ny, int nx,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P)                                                      \
  return dflo::launch_residual<T, P, false, dflo::LXF>(                      \
      u, dfw, dfe, dfs, dfn, uold, sc, ops, mask, out, ny, nx, s)
#define DFLO_DEGREES(T)           \
  if (p == 1) DFLO_CASE(T, 1);    \
  if (p == 2) DFLO_CASE(T, 2);    \
  if (p == 3) DFLO_CASE(T, 3);
  if (uold != nullptr && sc == nullptr) return -1;
  if (dtype == 0) { DFLO_DEGREES(float) }
  if (dtype == 1) { DFLO_DEGREES(double) }
#undef DFLO_DEGREES
#undef DFLO_CASE
  return -1;
}
