// Fused DG residual with a source term, hand-written for Hopper: the force
// planes (FORCE_PLANES) with the KFVS flux, the launch table of one source
// arm, built beside the others (see fused_residual_src.cu for what it
// replaces, what it computes and what bounds it).
#include <stdint.h>

#include "residual.cuh"

namespace dflo {
template int launch_table<KFVS, FORCE_PLANES>(int, int, int, int, int,
                                              const ResArgs&, cudaStream_t);
}  // namespace dflo
