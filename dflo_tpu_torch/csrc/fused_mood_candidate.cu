// The MOOD cascade's candidate, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (the sparse MOOD re-update, :945-1056, a 1-D pallas grid over a compact
// list of the affected 8 x 128 tiles, :945-953), and with every cell set
// its one-pass dense candidate (`fused(..., deg, dt_tp)` with modal_tp),
// with any of the six fluxes (this source: hllc;
// fused_mood_candidate_{lxf,roe,sw,kfvs,kep}.cu the others), on any modal
// Pk basis the residual takes: degrees 1-3 on their default quadrature with
// an instantiation each, degrees 4-6 and the over-integrated bases on the
// flux's general candidate (candidate.cuh).  Per cell: u_t + dt*R(u_t) with
// u_t = {Pk truncation to the cell's degree -> Zhang-Shu positivity}(u_pre),
// applied to the cell AND to each face neighbor with the neighbor's own
// degree before its trace; the residual is residual.cuh's with the caller's
// strips computed from the same u_t edge lines.  LxF's dissipation speed and
// KEP's dissipation matrix read the averages of the tp'd cell and neighbor.
//
// What bounds it on the H100: operations on the flagged tiles: the chain's
// QP positivity points x 4 components x K modes per staged cell, then the
// residual's products and fluxes (residual.cuh); bytes are u_pre's tiles
// and one write of the set cells.
//
// What the tile design does about it: the residual's tile kernel with
// TP = true over a device-built compact list of the flagged tiles
// (candidate.cuh): the chain runs once per staged cell of a tile, its
// positivity points on separate threads, and a tile without a set cell
// launches no work.  The result is written IN PLACE into u_prev on the set
// cells only (the kernel reads only u_pre, the analogue of the TPU's
// input_output_aliases, :1044).  Built with -fmad=false
// (ops/kernels.NVCC_FLAGS, as every source): the positivity branches at the
// pressure floor must decide as the plain version does.
#include "candidate.cuh"

DFLO_CANDIDATE_ENTRY(dflo_fused_mood_candidate, dflo::HLLC)

// The candidate's tile list alone (the same kernel its entry points launch
// first): cells uint8 [ny, nx]; list int32 [ceil(ny/ty) ceil(nx/tx)], the
// set tiles' row-major indices in its first count[0] slots, in no fixed
// order; count int32 [1].  Returns cudaGetLastError() after the launch.
extern "C" int dflo_tile_list(const void* cells, int ny, int nx, int ty,
                              int tx, void* list, void* count, void* stream) {
  return dflo::launch_tile_list((const uint8_t*)cells, ny, nx, ty, tx,
                                (int*)list, (int*)count,
                                (cudaStream_t)stream);
}
