// The MOOD cascade's candidate with the local Lax-Friedrichs flux,
// hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="lxf": the kernel of fused_mood_candidate.cu
// (candidate.cuh) instantiated with FLUX = LXF.  The dissipation speed of
// each face reads the cell averages (the avg row) of the {truncated ->
// positivity-limited} cell and neighbor, as the plain version averages the
// tp'd state (pallas_kernels.py:340, :368, :380; positivity keeps the mean
// only up to rounding).
//
// What bounds it on the H100: as fused_mood_candidate.cu, operations on the
// recomputed cells; the averages add 8K operations per cell and neighbor.
// Its own source so that nvcc builds it beside fused_mood_candidate.cu.
#include "candidate.cuh"

// Arguments as dflo::candidate_entry.
extern "C" int dflo_fused_mood_candidate_lxf(
    int dtype, int p, int K, int nq, int qp, const void* u, const void* deg,
    const void* cells, const void* flags, const void* dfw, const void* dfe,
    const void* dfs, const void* dfn, const void* dt, const void* ops,
    const void* Pm, double avg0, int ny, int nx, void* out, void* stream) {
  return dflo::candidate_entry<dflo::LXF>(
      dtype, p, K, nq, qp, u, deg, cells, flags, dfw, dfe, dfs, dfn, dt, ops,
      Pm, avg0, ny, nx, out, stream);
}
