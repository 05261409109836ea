// Fused DG residual with isothermal well-balanced gravity, hand-written for
// Hopper: the launch tables of the WB_ISO arm with the HLLC and the LxF flux
// on the collocated bases (GLL, as iso_xing_shu runs, and Gauss Qk), built
// beside the force arms; see fused_residual_src.cu for what it replaces,
// computes and what bounds it.
#include <stdint.h>

#include "residual.cuh"

namespace dflo {
template int launch_table<HLLC, WB_ISO>(int, int, int, int, int,
                                        const ResArgs&, cudaStream_t);
template int launch_table<LXF, WB_ISO>(int, int, int, int, int,
                                       const ResArgs&, cudaStream_t);
}  // namespace dflo
