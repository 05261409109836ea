// Collocated volume residual, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py volume_residual (kernel body
// _volume_kernel, pallas_kernels.py:115-137): the Euler fluxes at the K
// collocated nodes of each cell (the DoFs are the point values), then the
// stacked lift R[c][m] = sum_k L[m][k] Fx[c][k] + L[m][K + k] Fy[c][k] with
// L = [dy GxW^T | dx GyW^T], as the TPU kernel does in its own body (no
// library matrix product).  It is the volume term of the plain residual of
// solver/spatial.make_rhs(volume_kernel="pallas").
//
// What bounds it on the H100: bytes.  One thread per cell reads the cell's
// 4K values once (each (c, k) plane coalesced along x) and writes 4K values;
// the arithmetic is about 20 operations per node for the fluxes and two per
// nonzero lift entry and component.  L comes from a device buffer built from
// the NumPy basis (the same [K, 2K] array the plain version reads); the loop
// skips its zero entries (about 2/3 of a collocated Qk lift is zero: a
// node's derivative only reaches the nodes of its own row and column) at a
// branch that is the same for every thread of the warp.  Every product and
// sum is the plain version's, in its order (kernels.volume_residual_plain:
// per node its x then its y column), and the source is built with
// -fmad=false, so kernel and plain version round alike.  Q1-Q3 have an
// instantiation each; Q4-Q6 share one per dtype with K read at run time
// (its accumulators sized for Q6 and held in local memory).
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

// KC: the compile-time K of Q1-Q3 (the loops unroll, R lives in
// registers), or 0 for Q4-Q6: K read at run time, R sized for K_MAX in
// local memory (one instantiation per dtype)
template <typename T, int KC>
__global__ void __launch_bounds__(BX * BY)
volume_residual_kernel(const T* __restrict__ u, const T* __restrict__ L,
                       T* __restrict__ out, int ny, int nx, int k_run) {
  const int K = KC ? KC : k_run;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  T R[4][KC ? KC : K_MAX];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < K; ++m) R[c][m] = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T w[4], fx[4], fy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = __ldg(u + (long)(c * K + k) * plane + cell);
    flux_xy(w, fx, fy);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const T lx = __ldg(L + m * 2 * K + k);
      const T ly = __ldg(L + m * 2 * K + K + k);
      if (lx != T(0))
#pragma unroll
        for (int c = 0; c < 4; ++c) R[c][m] = R[c][m] + lx * fx[c];
      if (ly != T(0))
#pragma unroll
        for (int c = 0; c < 4; ++c) R[c][m] = R[c][m] + ly * fy[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < K; ++m) out[(long)(c * K + m) * plane + cell] = R[c][m];
}

template <typename T, int KC>
static int launch(const void* u, const void* L, void* out, int ny, int nx,
                  int K, cudaStream_t stream) {
  volume_residual_kernel<T, KC><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)L, (T*)out, ny, nx, K);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; K in {4, 9, 16, 25, 36, 49}
// (collocated Q1-Q6); L: the [K, 2K] lift in u's dtype.  Returns
// cudaGetLastError() after the launch, -1 for an unsupported case.
extern "C" int dflo_volume_residual(int dtype, int K, const void* u,
                                    const void* L, void* out, int ny, int nx,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_SIZES(T)                                              \
  switch (K) {                                                     \
    case 4: return dflo::launch<T, 4>(u, L, out, ny, nx, K, s);    \
    case 9: return dflo::launch<T, 9>(u, L, out, ny, nx, K, s);    \
    case 16: return dflo::launch<T, 16>(u, L, out, ny, nx, K, s);  \
    case 25:                                                       \
    case 36:                                                       \
    case 49: return dflo::launch<T, 0>(u, L, out, ny, nx, K, s);   \
    default: return -1;                                            \
  }
  if (dtype == 0) DFLO_SIZES(float)
  if (dtype == 1) DFLO_SIZES(double)
#undef DFLO_SIZES
  return -1;
}
