// The MOOD cascade's candidate with the Roe flux, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="roe": the tile kernel of candidate.cuh
// instantiated with FLUX = ROE.  The flux is the Roe flux with Harten's
// entropy fix (src/equation.h:469-556).
//
// What bounds it and what the design does about it: as
// fused_mood_candidate.cu; Roe costs about twice HLLC's operations per face
// point, computed once per face.  Its own source so that nvcc builds it
// beside the other candidates.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate_roe, dflo::ROE)
