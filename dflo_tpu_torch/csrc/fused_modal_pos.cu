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
// operations per cell) against 2 x 4K values of traffic, so roughly
// balanced; in f64 the operations.  One thread per cell, coalesced along x,
// each value read and written once.  Built with -fmad=false so its
// decisions at the pressure floor match the plain version's.
#include <stdint.h>

#include "modal.cuh"

namespace dflo {

template <typename T, int P>
__global__ void __launch_bounds__(BX * BY)
fused_modal_pos_kernel(const T* __restrict__ u, const int* __restrict__ deg,
                       const T* __restrict__ Pm, T* __restrict__ out,
                       T* __restrict__ lam_part, T* __restrict__ minq_part,
                       int ny, int nx, T avg0, T h) {
  constexpr int K = BDims<P, true>::K;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (x < nx && y < ny) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    T w[4][K], ub[4];
    load_cell<T, K>(u, plane, cell, w);
#pragma unroll
    for (int c = 0; c < 4; ++c) ub[c] = avg0 * w[c][0];
    if (deg != nullptr) {
      modal_tp<T, P>(w, __ldg(deg + cell), Pm, avg0);
    } else {
      modal_pos<T, P>(w, ub, Pm);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = w[c][k];
    if (lam_part != nullptr) cell_diag(ub, T(1) / h, lam, mq);
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, int P>
static int launch(const void* u, const void* deg, const void* Pm, void* out,
                  void* lam_part, void* minq_part, int ny, int nx, double avg0,
                  double h, cudaStream_t stream) {
  fused_modal_pos_kernel<T, P><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const int*)deg, (const T*)Pm, (T*)out, (T*)lam_part,
      (T*)minq_part, ny, nx, T(avg0), T(h));
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3}.  deg NULL: positivity
// only; lam_part/minq_part NULL for the form without diag, else
// dflo_num_blocks(ny, nx) entries each.  Returns cudaGetLastError() after
// the launch, -1 for an unsupported case.
extern "C" int dflo_fused_modal_pos(int dtype, int p, const void* u,
                                    const void* deg, const void* Pm, void* out,
                                    void* lam_part, void* minq_part, int ny,
                                    int nx, double avg0, double h,
                                    void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P) \
  return dflo::launch<T, P>(u, deg, Pm, out, lam_part, minq_part, ny, nx, avg0, h, s)
  if (dtype == 0) {
    if (p == 1) DFLO_CASE(float, 1);
    if (p == 2) DFLO_CASE(float, 2);
    if (p == 3) DFLO_CASE(float, 3);
  } else if (dtype == 1) {
    if (p == 1) DFLO_CASE(double, 1);
    if (p == 2) DFLO_CASE(double, 2);
    if (p == 3) DFLO_CASE(double, 3);
  }
#undef DFLO_CASE
  return -1;
}
