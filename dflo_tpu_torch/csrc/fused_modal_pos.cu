// Fused modal positivity, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_modal_pos (all four
// forms: with and without the truncation to a per-cell degree, with and
// without the diag outputs).  Per cell of a modal Pk state: {truncation to
// deg ->} Zhang-Shu positivity about the mode-0 mean (modal.cuh, the same
// device function the MOOD candidate applies); with diag, the CFL wave
// speed and min(rho, p) of the mean (truncation keeps mode 0 and Zhang-Shu
// scales about the mean), reduced per block with NaN-propagating max/min
// into partials the wrapper reduces with torch.amax/amin.
//
// What bounds it on the H100: at f32 the arithmetic (18 positivity points x
// 4 components x 6 modes plus a quadratic per point at p = 2, ~1,600
// operations per cell; 40 x 4 x 15 at p = 4, ~6,800) against 2 x 4K values
// of traffic, so roughly balanced; in f64 the operations.  Degrees 4-6 run
// on the general modal dims (their per-cell arrays in local memory).  One
// thread per cell, coalesced along x, each value read and written once.
// Built with -fmad=false so its decisions at the pressure floor match the
// plain version's.
#include <stdint.h>

#include "modal.cuh"

namespace dflo {

template <typename T, class D>
__global__ void __launch_bounds__(BX * BY)
fused_modal_pos_kernel(const T* __restrict__ u, const int* __restrict__ deg,
                       const T* __restrict__ Pm, T* __restrict__ out,
                       T* __restrict__ lam_part, T* __restrict__ minq_part,
                       int ny, int nx, T avg0, T h, D d) {
  const int K = d.K;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (x < nx && y < ny) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    T w[4][D::KMAX], ub[4];
    load_cell<T>(d, u, plane, cell, w);
#pragma unroll
    for (int c = 0; c < 4; ++c) ub[c] = avg0 * w[c][0];
    if (deg != nullptr) {
      modal_tp<T>(d, w, __ldg(deg + cell), Pm, avg0);
    } else {
      modal_pos<T>(d, w, ub, Pm);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = w[c][k];
    if (lam_part != nullptr) cell_diag(ub, T(1) / h, lam, mq);
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, class D>
static int launch(const D& d, const void* u, const void* deg, const void* Pm,
                  void* out, void* lam_part, void* minq_part, int ny, int nx,
                  double avg0, double h, cudaStream_t stream) {
  fused_modal_pos_kernel<T, D><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const int*)deg, (const T*)Pm, (T*)out, (T*)lam_part,
      (T*)minq_part, ny, nx, T(avg0), T(h), d);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 with K = (p+1)(p+2)/2 modes
// and qp positivity points (the rows of Pm): p 1-3 take their own
// instantiations (BDims), p 4-6 the general modal dims (GDims, one
// instantiation per dtype; modal.cuh modal_dims_case).  deg NULL: positivity
// only; lam_part/minq_part NULL for the form without diag, else
// dflo_num_blocks(ny, nx) entries each.  Returns cudaGetLastError() after
// the launch, -1 for an unsupported case.
extern "C" int dflo_fused_modal_pos(int dtype, int p, int K, int qp,
                                    const void* u, const void* deg,
                                    const void* Pm, void* out, void* lam_part,
                                    void* minq_part, int ny, int nx,
                                    double avg0, double h, void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto zero, const auto& d) {
    using T = decltype(zero);
    return dflo::launch<T>(d, u, deg, Pm, out, lam_part, minq_part, ny, nx,
                           avg0, h, s);
  };
  // no quadrature is read: nq = p + 1 picks the fixed dims of P1-P3
  return dflo::modal_dims_case(dtype, p, K, p + 1, qp, run);
}
