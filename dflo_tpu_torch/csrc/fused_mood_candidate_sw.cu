// The MOOD cascade's candidate with the Steger-Warming flux, hand-written for
// Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="sw": the tile kernel of candidate.cuh
// instantiated with FLUX = SW.  The flux is the Steger-Warming flux-vector
// splitting (src/equation.h:382-464).
//
// What bounds it and what the design does about it: as
// fused_mood_candidate.cu.  Its own source so that nvcc builds it beside
// the other candidates.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate_sw, dflo::SW)
