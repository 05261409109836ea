// The MOOD cascade's candidate with the KFVS flux, hand-written for
// Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="kfvs": the kernel of fused_mood_candidate.cu
// (candidate.cuh) instantiated with FLUX = KFVS.
// The flux is the kinetic flux-vector splitting (src/equation.h:756-782)
// with the Abramowitz-Stegun erf, as the reference's kernel
// (pallas_kernels.py:272-273).
//
// What bounds it on the H100: as fused_mood_candidate.cu, operations on the
// recomputed cells; each split adds one exp in the erf and one in B.
// Its own source so that nvcc builds it beside the other candidates.
#include "candidate.cuh"

// Arguments as dflo::candidate_entry.
extern "C" int dflo_fused_mood_candidate_kfvs(
    int dtype, int p, int K, int nq, int qp, const void* u, const void* deg,
    const void* cells, const void* flags, const void* dfw, const void* dfe,
    const void* dfs, const void* dfn, const void* dt, const void* ops,
    const void* Pm, double avg0, int ny, int nx, void* out, void* stream) {
  return dflo::candidate_entry<dflo::KFVS>(
      dtype, p, K, nq, qp, u, deg, cells, flags, dfw, dfe, dfs, dfn, dt, ops,
      Pm, avg0, ny, nx, out, stream);
}
