// The MOOD cascade's candidate, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (the sparse MOOD re-update, :945-1056, a dynamic pallas grid over a list
// of 8 x 128 tiles), and with every cell set its one-pass dense candidate
// (`fused(..., deg, dt_tp)` with modal_tp), with any of the six fluxes
// (this source: hllc; fused_mood_candidate_{lxf,roe,sw,kfvs,kep}.cu the
// others), on any modal Pk basis the residual takes: degrees 1-3 on their
// default quadrature with an instantiation each, degrees 4-6 and the
// over-integrated bases on the flux's general candidate (candidate.cuh).
// Per cell: u_t + dt*R(u_t) with u_t = {Pk truncation to the cell's degree
// -> Zhang-Shu positivity}(u_pre) (modal.cuh modal_tp), applied to the cell
// AND to each face neighbor with the neighbor's own degree before its trace;
// the residual is residual.cuh's with the caller's strips computed from the
// same u_t edge lines.  LxF's dissipation speed and KEP's dissipation
// matrix read the averages of the tp'd cell and neighbor, as the plain
// version averages the tp'd state (positivity keeps the mean only up to
// rounding).
//
// Sparse form: the grid covers every 32 x 4 tile; a block reads its tile's
// flag (one byte of a device-side plane built by ops/kernels.tile_flags) and
// returns at once if no cell of its tile is set; within a flagged tile a
// thread computes its cell only if the cell's byte in `cells` is set.  The
// result is written IN PLACE into u_prev (`out`): safe because the kernel
// reads only u_pre, the analogue of the TPU's input_output_aliases (:1044).
// Cells not set keep u_prev, so tiles choose only how much is launched,
// never the result.
//
// What bounds it on the H100: operations on the recomputed cells.  Besides
// the residual's ~4,000 operations per P2 cell, the chain runs five times
// per cell (itself and four neighbors), each 18 positivity points x 4
// components x 6 modes plus a quadratic per point, ~8,000 more; bytes are
// u_pre's 4K values of the cell and its neighbors and one write.  The
// simple design recomputes the neighbors' chains instead of sharing them
// through shared memory (a later version stages the tile's u_t once).
// Built with -fmad=false (ops/kernels.NVCC_FLAGS, as every source): the
// positivity branches at the pressure floor must decide as the plain
// version does.
#include "candidate.cuh"

// The hllc candidate; arguments as dflo::candidate_entry.
extern "C" int dflo_fused_mood_candidate(
    int dtype, int p, int K, int nq, int qp, const void* u, const void* deg,
    const void* cells, const void* flags, const void* dfw, const void* dfe,
    const void* dfs, const void* dfn, const void* dt, const void* ops,
    const void* Pm, double avg0, int ny, int nx, void* out, void* stream) {
  return dflo::candidate_entry<dflo::HLLC>(
      dtype, p, K, nq, qp, u, deg, cells, flags, dfw, dfe, dfs, dfn, dt, ops,
      Pm, avg0, ny, nx, out, stream);
}
