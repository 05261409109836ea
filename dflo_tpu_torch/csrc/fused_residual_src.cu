// Fused DG residual with a source term, hand-written for Hopper: the entry
// point of every source arm, and the gravity arm with the HLLC flux.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual with a
// `source` (kernel body _fused_kernel, its ops["src"] arm, :573-577,
// :682-700) or with well_balanced="isothermal" (its wb_iso arm, :578-593,
// :701-727): the kernel of fused_residual.cu (residual.cuh) with the
// template argument SRC, in its R, SSP-stage and u + dt*R forms.
//
// - FORCE_CONST, gravity (rayleigh_taylor): the constant g = (gx, gy)
//   arrives as two scalars.  The TPU kernel streams the quadrature points'
//   coordinates because its source is a generic callable it traces; this
//   one computes the same function without them: no coordinate bytes.
// - FORCE_PLANES, an external force f(x, y, t): the caller evaluates f at
//   the call's t on the quadrature points (torch, no host sync) and the
//   kernel reads the planes fx, fy [Q, ny, nx] and applies forcing_external.
// - Both force arms lift S through the baked src = minv . (wq2 V)^T on
//   collocated Qk and GLL (where it is the identity up to rounding) and on
//   modal Pk (W at the quadrature points first).
// - WB_ISO (iso_xing_shu), collocated only: exp(-phi/RT) on the nodal
//   potential plane phi [K, ny, nx] with RT from the cell average, the nodal
//   derivatives through the baked Gxn, Gyn and 1/dx, 1/dy (IEEE exp, no
//   contraction: -fmad=false, so the plain twin rounds alike up to exp).
//
// What bounds it on the H100: operations, as fused_residual.cu; gravity
// adds no bytes and 10 operations per point plus the K x Q lift of S, the
// planes 2Q values per cell, the isothermal arm K values of phi and K exp,
// 2K^2 multiply-adds of the derivatives and about 10 operations per node.
// The tile design (residual.cuh) keeps the source in the same pass: S, E
// and the additions stay in shared memory, a chunk of points at a time.
//
// The arms' launch tables live in sources built side by side (launch_table
// in residual.cuh): this one (gravity, hllc), fused_residual_src_<flux>.cu
// (gravity with lxf, roe, sw, kfvs and kep), fused_residual_planes.cu and
// fused_residual_planes_<flux>.cu (the force planes), fused_residual_wb.cu
// (isothermal, hllc and lxf) and fused_residual_wb_<flux>.cu (isothermal,
// roe, sw, kfvs and kep): every arm with each of the six fluxes, as the
// reference's arms take any flux (get_flux(flux_name, kernel_safe=True),
// pallas_kernels.py:273).
#include <stdint.h>

#include "residual.cuh"

namespace dflo {
// the other arms' tables are instantiated in their own sources
#define DFLO_TABLE(FLUX, SRC)                                               \
  int launch_table<FLUX, SRC>(int, int, int, int, int, const ResArgs&,      \
                              cudaStream_t)
#define DFLO_EXTERN(FLUX)                                                   \
  extern template DFLO_TABLE(FLUX, FORCE_CONST);                            \
  extern template DFLO_TABLE(FLUX, FORCE_PLANES);                           \
  extern template DFLO_TABLE(FLUX, WB_ISO)
DFLO_EXTERN(LXF);
DFLO_EXTERN(ROE);
DFLO_EXTERN(SW);
DFLO_EXTERN(KFVS);
DFLO_EXTERN(KEP);
extern template DFLO_TABLE(HLLC, FORCE_PLANES);
extern template DFLO_TABLE(HLLC, WB_ISO);
template DFLO_TABLE(HLLC, FORCE_CONST);
#undef DFLO_EXTERN
#undef DFLO_TABLE
}  // namespace dflo

// dtype: 0 = float32, 1 = float64; modal: 1 where the DoFs are contracted
// with V (modal Pk, or a nodal basis off its nodes), 0 for a collocated
// basis; p the degree, K the DoFs per cell, nq the quadrature points per
// direction (degrees 1-6, nq up to NQ_MAX); flux: 0 = hllc, 1 = lxf,
// 2 = roe, 3 = sw, 4 = kfvs, 5 = kep (residual.cuh); src: 1 = FORCE_CONST
// (gx, gy), 2 = FORCE_PLANES (fx, fy [Q, ny, nx]), 3 = WB_ISO (phi
// [K, ny, nx], collocated only).  Forms and mask as dflo_fused_residual
// (the mask on either basis).  Returns the cudaGetLastError() code after
// the launch (0 = launched), -1 for an unsupported case; ty x tx is the
// tile, ops/kernels.residual_tile.
extern "C" int dflo_fused_residual_src(
    int dtype, int modal, int p, int K, int nq, int flux, int src,
    const void* u, const void* dfw, const void* dfe, const void* dfs,
    const void* dfn, const void* uold, const void* sc, const void* ops,
    const void* mask, const void* fx, const void* fy, const void* phi,
    double gx, double gy, void* out, int ny, int nx, int ty, int tx, void* stream) {
  using namespace dflo;
  const ResArgs a{u,  dfw, dfe, dfs, dfn, uold, sc, ops, mask,
                  fx, fy,  phi, gx,  gy,  out,  ny, nx, ty, tx};
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_ARM(FLUX, SRC)                                                 \
  if (flux == FLUX && src == SRC)                                           \
  return launch_table<FLUX, SRC>(dtype, modal, p, K, nq, a, s)
#define DFLO_ARMS(FLUX)                                                     \
  DFLO_ARM(FLUX, FORCE_CONST);                                              \
  DFLO_ARM(FLUX, FORCE_PLANES);                                             \
  DFLO_ARM(FLUX, WB_ISO)
  DFLO_ARMS(HLLC);
  DFLO_ARMS(LXF);
  DFLO_ARMS(ROE);
  DFLO_ARMS(SW);
  DFLO_ARMS(KFVS);
  DFLO_ARMS(KEP);
#undef DFLO_ARMS
#undef DFLO_ARM
  return -1;
}
