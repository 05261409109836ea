// Fused step diagnostics, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_diag (single chip),
// masked or not, for any basis: the cell average is the mean-weight row
// avg = wq2 @ V (K entries) against the cell's K DoFs, so the kernel is
// instantiated on K alone (nodal Q1-Q6: 4, 9, 16, 25, 36, 49; modal P1-P6:
// 3, 6, 10, 15, 21, 28), whatever quadrature the row came from.
// Per cell, from its cell average: the CFL wave speed
// (c + |vx|)/h + (c + |vy|)/h (compute_time_step_cartesian,
// src/claw.cc:483-512) and min(rho, p) for the fatal-negativity flag
// (src/positivity.cc:26-39).  On a masked domain a solid cell (uint8 fluid
// flag 0) counts as lam = 0 and min(rho, p) = inf, so it enters neither
// reduction (pallas_kernels.py:1675-1710).  Each block reduces its cells with
// NaN-propagating max/min (a NaN cell must reach the driver's
// bad = ~(minq >= EPS)) and writes one partial each; the wrapper reduces the
// partials with torch.amax/amin, as the TPU version does with jnp.max/min.
//
// What bounds it on the H100: bytes, one read of the state (4K values per
// cell, coalesced along x) and almost no arithmetic.  The simple design
// reads each value once and writes one pair of partials per 128-cell block;
// a later version folds this pass into the previous step's fused post, as the
// chunked loop already does for every step but the first of a chunk.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

template <typename T, int K>
__global__ void __launch_bounds__(BX * BY)
fused_diag_kernel(const T* __restrict__ u, const T* __restrict__ avg,
                  const uint8_t* __restrict__ mask, T* __restrict__ lam_part,
                  T* __restrict__ minq_part, int ny, int nx, T h) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (x < nx && y < ny) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    T ub[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ub[c] = dot_cell<T, K>(avg, u, c, plane, cell);
    cell_diag(ub, T(1) / h, lam, mq);
    if (mask != nullptr && __ldg(mask + cell) == 0) {
      lam = T(0);
      mq = T(INFINITY);
    }
  }
  block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, int K>
static int launch(const void* u, const void* avg, const void* mask,
                  void* lam_part, void* minq_part, int ny, int nx, double h,
                  cudaStream_t stream) {
  fused_diag_kernel<T, K><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)avg, (const uint8_t*)mask, (T*)lam_part,
      (T*)minq_part, ny, nx, T(h));
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; K in {3, 4, 6, 9, 10, 15, 16, 21, 25,
// 28, 36, 49} (the DoFs per cell of Pk / Qk and GLL, p = 1..6, on any
// quadrature); mask: uint8 [ny, nx] fluid flags, or NULL;
// lam_part/minq_part hold one entry per 4 x 32 block (BY x BX;
// ops/kernels.tile_count of kernels.BLOCK).  Returns
// cudaGetLastError() after the launch, -1 for an unsupported case.
extern "C" int dflo_fused_diag(int dtype, int K, const void* u, const void* avg,
                               const void* mask, void* lam_part,
                               void* minq_part, int ny, int nx, double h,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, K) \
  return dflo::launch<T, K>(u, avg, mask, lam_part, minq_part, ny, nx, h, s)
#define DFLO_SIZES(T)                                             \
  switch (K) {                                                    \
    case 3: DFLO_CASE(T, 3);                                      \
    case 4: DFLO_CASE(T, 4);                                      \
    case 6: DFLO_CASE(T, 6);                                      \
    case 9: DFLO_CASE(T, 9);                                      \
    case 10: DFLO_CASE(T, 10);                                    \
    case 15: DFLO_CASE(T, 15);                                    \
    case 16: DFLO_CASE(T, 16);                                    \
    case 21: DFLO_CASE(T, 21);                                    \
    case 25: DFLO_CASE(T, 25);                                    \
    case 28: DFLO_CASE(T, 28);                                    \
    case 36: DFLO_CASE(T, 36);                                    \
    case 49: DFLO_CASE(T, 49);                                    \
    default: return -1;                                           \
  }
  if (dtype == 0) DFLO_SIZES(float)
  if (dtype == 1) DFLO_SIZES(double)
#undef DFLO_SIZES
#undef DFLO_CASE
  return -1;
}

// The thread block of the per-cell kernels (the diag, the Pk post, the
// check and the per-cell post), axis 0 its rows (BY), 1 its columns (BX):
// their diag partials number these blocks, which ops/kernels.BLOCK mirrors
// (checked in chip_smoke.py phase 1).
extern "C" int dflo_block_dims(int axis) {
  return axis == 0 ? dflo::BY : dflo::BX;
}
