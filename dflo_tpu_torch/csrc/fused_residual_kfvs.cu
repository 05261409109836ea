// Fused DG residual with the KFVS flux, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual with
// flux_name="kfvs" (kernel body _fused_kernel, :268), on the collocated
// nodal Qk and GLL bases and on the modal Pk basis (the V contraction first,
// :450-459), masked (pallas_kernels.py:287-292, :472-533, :598-599) or
// not: the kernel of fused_residual.cu (residual.cuh) instantiated with
// FLUX = KFVS, in its R, SSP-stage and u + dt*R forms.  The flux is
// the kinetic flux-vector splitting (src/equation.h:756-782) with the
// Abramowitz-Stegun erf, as the reference's kernel (get_flux(kernel_safe=True),
// pallas_kernels.py:272-273).
//
// What bounds it and what the tile design does about it: as
// fused_residual.cu (residual.cuh), the flux computed once per face
// point.  Its own source so that nvcc builds it beside the others.
#include <stdint.h>

#include "residual.cuh"

namespace dflo {
// this flux's general kernels (degrees 4-6 and any nq != p + 1), for every
// source arm: compiled here alone (residual.cuh launch_general)
template DFLO_GENERAL(KFVS);
}  // namespace dflo

// dtype: 0 = float32, 1 = float64; modal: 1 where the DoFs are contracted
// with V (modal Pk, or a nodal basis off its nodes), 0 for a collocated Qk or
// GLL basis; p the degree, K the DoFs per cell and nq the quadrature points
// per direction (dflo::launch_table: degrees 1-6, nq up to NQ_MAX).  Forms
// and mask (on either basis) as dflo_fused_residual.  Returns the
// cudaGetLastError() code after the launch (0 = launched), -1 for an
// unsupported case (a tile the kernel does not take included): ty x tx is
// the tile, ops/kernels.residual_tile.
extern "C" int dflo_fused_residual_kfvs(
    int dtype, int modal, int p, int K, int nq, const void* u,
    const void* dfw, const void* dfe, const void* dfs, const void* dfn,
    const void* uold, const void* sc, const void* ops, const void* mask,
    void* out, int ny, int nx, int ty, int tx, void* stream) {
  // no source arm: no planes, no potential, no gravity
  const dflo::ResArgs a{u,   dfw, dfe, dfs, dfn, uold, sc, ops, mask,
                        nullptr, nullptr, nullptr, 0.0, 0.0, out,
                        ny,  nx,  ty,  tx};
  return dflo::launch_table<dflo::KFVS, dflo::SRC_NONE>(
      dtype, modal, p, K, nq, a, (cudaStream_t)stream);
}
