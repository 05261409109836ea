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
// What bounds it on the H100: operations (residual.cuh): the V
// contraction, the traces, one flux per volume and face point and the lift,
// each multiply and add a separate IEEE operation (-fmad=false); at p 1-2
// the state's bytes come close (about 48 bytes per DoF read and written).
//
// What the tile design does about it (residual.cuh): one block per tile,
// the tile's DoFs and a one-cell ring staged once in shared memory, each
// trace, face flux and volume flux computed once, and the lift as a
// register-tiled product, so no thread holds a cell's arrays (no local
// memory at any degree).  The thread-per-cell kernel it replaced streamed
// every DoF about nine times and computed each face flux twice.
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
// unsupported case (a tile the kernel does not take included): ty x tx is
// the tile, ops/kernels.residual_tile.
extern "C" int dflo_fused_residual(
    int dtype, int modal, int p, int K, int nq, const void* u,
    const void* dfw, const void* dfe, const void* dfs, const void* dfn,
    const void* uold, const void* sc, const void* ops, const void* mask,
    void* out, int ny, int nx, int ty, int tx, void* stream) {
  // no source arm: no planes, no potential, no gravity
  const dflo::ResArgs a{u,   dfw, dfe, dfs, dfn, uold, sc, ops, mask,
                        nullptr, nullptr, nullptr, 0.0, 0.0, out,
                        ny,  nx,  ty,  tx};
  return dflo::launch_table<dflo::HLLC, dflo::SRC_NONE>(
      dtype, modal, p, K, nq, a, (cudaStream_t)stream);
}

// The dynamic shared memory in bytes of one residual (tp = 0) or candidate
// (tp = 1) block: dtype and the basis dims as above, qp positivity points,
// flux and src (0 for none) as dflo_fused_residual_src, masked 0/1, and the
// ty x tx tile; -1 for a tile the kernel does not take.  For the build's
// report (chip_smoke.py phase 1).
extern "C" int dflo_tile_smem(int dtype, int modal, int K, int nq, int qp,
                              int flux, int src, int masked, int tp, int ty,
                              int tx) {
  using namespace dflo;
  if (K < 1 || K > K_MAX || nq < 1 || nq > NQ_MAX || ty < 1 || tx < 1 ||
      (ty * tx) % CB != 0)
    return -1;
  const bool wb = !modal && src == WB_ISO;
  const bool avg = flux == LXF || flux == KEP || wb;
  const bool body = src == FORCE_CONST || src == FORCE_PLANES;
  const TileGeo g =
      modal ? (dtype ? tile_geo<double>(general_dims<true>(K, nq, qp), avg,
                                        masked, tp, body, wb, ty, tx, 1, 1)
                     : tile_geo<float>(general_dims<true>(K, nq, qp), avg,
                                       masked, tp, body, wb, ty, tx, 1, 1))
            : (dtype ? tile_geo<double>(general_dims<false>(K, nq, qp), avg,
                                        masked, tp, body, wb, ty, tx, 1, 1)
                     : tile_geo<float>(general_dims<false>(K, nq, qp), avg,
                                       masked, tp, body, wb, ty, tx, 1, 1));
  return g.bytes;
}
