// Fused DG residual, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual (the dense
// entry `fused`, kernel body _fused_kernel) in its hllc form, on the
// collocated nodal Qk and GLL bases, on the modal Pk basis and on a nodal
// basis off its nodes (over-integrated, nq != p + 1: "over-integrated Qk
// via an in-kernel V contraction", pallas_kernels.py:621-624, :661-662;
// the V contraction to quadrature-point values before the fluxes,
// :450-459), at degrees 1-6 (1-3 on their default quadrature with an
// instantiation each, the rest on the general dims of residual.cuh),
// with or without a solid-cell mask (its masked form, :287-292, :472-533,
// :598-599).  fused_residual_lxf.cu instantiates the same kernel with the
// LxF flux.  It computes M^{-1} R(u) (residual.cuh) and writes, by form: R;
// the SSP stage a*u_old + (1-a)*(u + dt*R) with [a, dt] read from a device
// pointer so the host never waits on dt; or the forward-Euler update
// u + dt*R (the MOOD cascade's first candidate, whose [dt] is read the same
// way).
//
// What bounds it on the H100: at f32 roughly bytes and operations alike.
// One thread per cell, adjacent threads on adjacent x, so every (c, k)
// plane of the [4, K, ny, nx] state loads coalesced; each cell reads its own
// 4K values and the 4K values of each of its four neighbors (roughly 5x the
// state through L1/L2 per call) and writes 4K values (a mask adds one byte
// for the cell and each neighbor).  The arithmetic (the
// V contraction and fluxes at Q points, two traces and one HLLC flux per
// face point, the lifts) is about 4,000 operations per P2 cell.
//
// What the simple design does about it: a 32 x 4 block keeps a warp on 32
// contiguous cells and puts the north/south neighbor rows of most cells in
// the same block, so those re-reads hit L1.  A later version stages a shared-
// memory tile with a one-cell halo (one read of the state per block) and
// bakes the sparse operator constants into the source.
#include <stdint.h>

#include "residual.cuh"

namespace dflo {
// this flux's general kernels (degrees 4-6 and any nq != p + 1), for every
// source arm: compiled here alone (residual.cuh launch_general)
template DFLO_GENERAL(HLLC);
}  // namespace dflo

// dtype: 0 = float32, 1 = float64; modal: 1 where the DoFs are contracted
// with V (modal Pk, or a nodal basis off its nodes), 0 for a collocated Qk or
// GLL basis; p the degree, K the DoFs per cell and nq the quadrature points
// per direction (dflo::launch_table: degrees 1-6, nq up to NQ_MAX).  Forms:
// uold and sc = [a, dt] -> the SSP stage; uold NULL and sc = [dt] -> u +
// dt*R; both NULL -> R.  mask: uint8 [ny, nx] fluid flags, or NULL.  Returns
// the cudaGetLastError() code after the launch (0 = launched), -1 for an
// unsupported case.
extern "C" int dflo_fused_residual(
    int dtype, int modal, int p, int K, int nq, const void* u,
    const void* dfw, const void* dfe, const void* dfs, const void* dfn,
    const void* uold, const void* sc, const void* ops, const void* mask,
    void* out, int ny, int nx, void* stream) {
  // no source arm: no planes, no potential, no gravity
  const dflo::ResArgs a{u,   dfw, dfe, dfs, dfn, uold, sc, ops, mask,
                        nullptr, nullptr, nullptr, 0.0, 0.0, out, ny, nx};
  return dflo::launch_table<dflo::HLLC, dflo::SRC_NONE>(
      dtype, modal, p, K, nq, a, (cudaStream_t)stream);
}

// number of thread blocks (= diagnostic partials) for an ny x nx grid
extern "C" int dflo_num_blocks(int ny, int nx) {
  const dim3 g = dflo::grid_for(ny, nx);
  return (int)(g.x * g.y);
}
