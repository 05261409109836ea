// The MOOD cascade's candidate with the local Lax-Friedrichs flux,
// hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="lxf": the tile kernel of candidate.cuh
// instantiated with FLUX = LXF.  The dissipation speed of each face reads
// the cell averages (the avg row) of the {truncated -> positivity-limited}
// cell and neighbor, as the plain version averages the tp'd state
// (pallas_kernels.py:340, :368, :380), staged once per tile.
//
// What bounds it and what the design does about it: as
// fused_mood_candidate.cu.  Its own source so that nvcc builds it beside
// the other candidates.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate_lxf, dflo::LXF)
