// Fused Pk post of one MOOD stage, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_pk_post (with and
// without its diag outputs).  Per cell of a modal Pk state: the mode-0 mean
// and the four neighbors' mode-0 means (neighbor-exists flags from
// global-edge arithmetic, non-wrapping on non-periodic sides); the modal TVB
// limiter (src/limiter.cc:376-516: slopes sqrt(3) x the (1,0) and (0,1)
// modes, beta / 2, characteristic decomposition) on the cells whose shock
// plane exceeds 1 (the cells the cascade marked) and whose change exceeds
// 1e-10, rebuilt as [mean, x-slope, y-slope]; Zhang-Shu positivity about
// the mean (modal.cuh); with diag, the CFL wave speed and min(rho, p) of the
// means (the chain preserves them), reduced per block into partials.
//
// What bounds it on the H100: bytes at f32 (the state read and written once,
// four mode-0 values of each neighbor, the shock plane), with ~2,000
// operations per P2 cell (two 4x4 eigen systems, 18 positivity points).
// Degrees 4-6 run on the general modal dims (K, the positivity points and
// the (0,1) mode p + 1 read at run time; the per-cell arrays in local
// memory): the rebuild zeroes every mode but the three it keeps, at any K.
// Built with -fmad=false, and every quantity that feeds the TVB gate is
// computed with the plain version's IEEE operations in its order, so in
// float32 kernel and plain version take the same limiter decisions (the
// fault seen in fused_post.cu's first chip run).
#include <stdint.h>

#include "modal.cuh"

namespace dflo {

struct PkPostParams {
  int per_x, per_y, char_lim;
  double avg0, beta, Mdx2, h;
};

template <typename T, class D>
__global__ void __launch_bounds__(BX * BY)
fused_pk_post_kernel(const T* __restrict__ u, const T* __restrict__ shock,
                     const T* __restrict__ Pm, T* __restrict__ out,
                     T* __restrict__ lam_part, T* __restrict__ minq_part,
                     int ny, int nx, PkPostParams prm, D d) {
  const int K = d.K;
  const int IX = 1, IY = d.P + 1;       // (1,0) and (0,1) modes
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions

  if (x < nx && y < ny) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    const int xw = x == 0 ? nx - 1 : x - 1;
    const int xe = x == nx - 1 ? 0 : x + 1;
    const int ys = y == 0 ? ny - 1 : y - 1;
    const int yn = y == ny - 1 ? 0 : y + 1;
    const bool vW = prm.per_x || x > 0, vE = prm.per_x || x < nx - 1;
    const bool vS = prm.per_y || y > 0, vN = prm.per_y || y < ny - 1;
    const T avg0 = T(prm.avg0);
    const T sqrt3 = T(1.7320508075688772);   // float(np.sqrt(3.0))
    const T inv_sqrt3 = T(1) / sqrt3;        // stab/limiter's inv_sqrt3

    T w[4][D::KMAX], ub[4], ubW[4], ubE[4], ubS[4], ubN[4];
    load_cell<T>(d, u, plane, cell, w);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* m0 = u + (long)(c * K) * plane;
      ub[c] = avg0 * w[c][0];
      ubW[c] = avg0 * __ldg(m0 + (long)y * nx + xw);
      ubE[c] = avg0 * __ldg(m0 + (long)y * nx + xe);
      ubS[c] = avg0 * __ldg(m0 + (long)ys * nx + x);
      ubN[c] = avg0 * __ldg(m0 + (long)yn * nx + x);
    }

    // ---- modal TVB limiter ----------------------------------------------
    T Dx[4], Dy[4], dbx[4], dfx[4], dby[4], dfy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dx[c] = sqrt3 * w[c][IX];
      Dy[c] = sqrt3 * w[c][IY];
      dbx[c] = vW ? ub[c] - ubW[c] : Dx[c];
      dfx[c] = vE ? ubE[c] - ub[c] : Dx[c];
      dby[c] = vS ? ub[c] - ubS[c] : Dy[c];
      dfy[c] = vN ? ubN[c] - ub[c] : Dy[c];
    }
    T Dxn[4], Dyn[4];
    const T change = tvb_slopes(ub, Dx, Dy, dbx, dfx, dby, dfy,
                                prm.char_lim != 0, T(prm.beta), T(prm.Mdx2),
                                Dxn, Dyn);
    if (__ldg(shock + cell) > T(1) && change > T(1.0e-10)) {
      // keep [mean, x-slope, y-slope]; mode 0 takes the mean itself, as the
      // plain limiter (stab/limiter.py) does
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int k = 0; k < K; ++k) w[c][k] = T(0);
        w[c][0] = ub[c];
        w[c][IX] = Dxn[c] * inv_sqrt3;
        w[c][IY] = Dyn[c] * inv_sqrt3;
      }
    }

    // ---- Zhang-Shu positivity about the pre-limit mean -------------------
    modal_pos<T>(d, w, ub, Pm);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = w[c][k];

    if (lam_part != nullptr) cell_diag(ub, T(1) / T(prm.h), lam, mq);
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, class D>
static int launch(const D& d, const void* u, const void* shock,
                  const void* Pm, void* out, void* lam_part, void* minq_part,
                  int ny, int nx, const PkPostParams& prm,
                  cudaStream_t stream) {
  fused_pk_post_kernel<T, D><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)shock, (const T*)Pm, (T*)out, (T*)lam_part,
      (T*)minq_part, ny, nx, prm, d);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 with K = (p+1)(p+2)/2 modes
// and qp positivity points (the rows of Pm): p 1-3 take their own
// instantiations (BDims), p 4-6 the general modal dims (GDims, one
// instantiation per dtype; modal.cuh modal_dims_case).  beta is the Pk
// limiter's effective beta (half the configured one).  lam_part/minq_part
// NULL for the form without diag, else one entry per 4 x 32 block (BY x BX;
// ops/kernels.tile_count of kernels.BLOCK) each.  Returns cudaGetLastError() after the launch, -1 for an
// unsupported case.
extern "C" int dflo_fused_pk_post(int dtype, int p, int K, int qp,
                                  const void* u, const void* shock,
                                  const void* Pm, void* out, void* lam_part,
                                  void* minq_part, int ny, int nx, int per_x,
                                  int per_y, int char_lim, double avg0,
                                  double beta, double Mdx2, double h,
                                  void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  const dflo::PkPostParams prm{per_x, per_y, char_lim, avg0, beta, Mdx2, h};
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto zero, const auto& d) {
    using T = decltype(zero);
    return dflo::launch<T>(d, u, shock, Pm, out, lam_part, minq_part, ny, nx,
                           prm, s);
  };
  // no quadrature is read: nq = p + 1 picks the fixed dims of P1-P3
  return dflo::modal_dims_case(dtype, p, K, p + 1, qp, run);
}
