// The MOOD cascade's candidate with the KFVS flux, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="kfvs": the tile kernel of candidate.cuh
// instantiated with FLUX = KFVS.  The flux is the kinetic flux-vector
// splitting (src/equation.h:756-782) with the Abramowitz-Stegun erf, as the
// reference's kernel (pallas_kernels.py:272-273).
//
// What bounds it and what the design does about it: as
// fused_mood_candidate.cu; each split adds one exp in the erf and one in B.
// Its own source so that nvcc builds it beside the other candidates.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate_kfvs, dflo::KFVS)
