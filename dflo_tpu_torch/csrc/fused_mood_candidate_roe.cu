// The MOOD cascade's candidate with the Roe flux, hand-written for
// Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="roe": the kernel of fused_mood_candidate.cu
// (candidate.cuh) instantiated with FLUX = ROE.
// The flux is the Roe flux with Harten's entropy fix
// (src/equation.h:469-556).
//
// What bounds it on the H100: as fused_mood_candidate.cu, operations on the
// recomputed cells; Roe carries more live values per face point than HLLC
// (the Roe averages, three wave strengths, the dissipation sums), so
// registers press harder (PERF.md records ptxas' registers and spills).
// Its own source so that nvcc builds it beside the other candidates.
#include "candidate.cuh"

// Arguments as dflo::candidate_entry.
extern "C" int dflo_fused_mood_candidate_roe(
    int dtype, int p, int K, int nq, int qp, const void* u, const void* deg,
    const void* cells, const void* flags, const void* dfw, const void* dfe,
    const void* dfs, const void* dfn, const void* dt, const void* ops,
    const void* Pm, double avg0, int ny, int nx, void* out, void* stream) {
  return dflo::candidate_entry<dflo::ROE>(
      dtype, p, K, nq, qp, u, deg, cells, flags, dfw, dfe, dfs, dfn, dt, ops,
      Pm, avg0, ny, nx, out, stream);
}
