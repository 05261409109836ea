// The MOOD cascade's candidate with the KEP flux, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (:945-1056) with flux_name="kep": the tile kernel of candidate.cuh
// instantiated with FLUX = KEP.  The flux is the kinetic-energy-preserving
// entropy-stable flux with its dissipation matrix on the two cells'
// averages (src_mpi/equation.h:748-920): as for LxF, the averages of the
// {truncated -> positivity-limited} cell and neighbor.
//
// What bounds it and what the design does about it: as
// fused_mood_candidate.cu; its logarithmic means make it the costliest flux
// per face point.  Its own source so that nvcc builds it beside the other
// candidates.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate_kep, dflo::KEP)
