// The MOOD cascade's candidate, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (the sparse MOOD re-update, :945-1056, a dynamic pallas grid over a list
// of 8 x 128 tiles), and with every cell set its one-pass dense candidate
// (`fused(..., deg, dt_tp)` with modal_tp).  Per cell: u_t + dt*R(u_t) with
// u_t = {Pk truncation to the cell's degree -> Zhang-Shu positivity}(u_pre)
// (modal.cuh modal_tp), applied to the cell AND to each face neighbor with
// the neighbor's own degree before its trace; the residual is residual.cuh's
// with the caller's strips computed from the same u_t edge lines.
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
#include <stdint.h>

#include "residual.cuh"

namespace dflo {

template <typename T, int P>
__global__ void __launch_bounds__(BX * BY)
fused_mood_candidate_kernel(const T* __restrict__ u, const int* __restrict__ deg,
                            const uint8_t* __restrict__ cells,
                            const uint8_t* __restrict__ flags,
                            const T* __restrict__ dfw, const T* __restrict__ dfe,
                            const T* __restrict__ dfs, const T* __restrict__ dfn,
                            const T* __restrict__ dt, const T* __restrict__ ops,
                            const T* __restrict__ Pm, T avg0, int ny, int nx,
                            T* __restrict__ out) {
  constexpr int K = BDims<P, true>::K;
  if (flags[blockIdx.y * gridDim.x + blockIdx.x] == 0) return;  // whole tile
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  if (cells[cell] == 0) return;

  T R[4][K], w[4][K];
  cell_residual<T, P, true, true>(u, deg, Pm, avg0, dfw, dfe, dfs, dfn, ops, x,
                                  y, ny, nx, R, w);
  const T h = dt[0];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[(long)(c * K + k) * plane + cell] = w[c][k] + h * R[c][k];
}

template <typename T, int P>
static int launch(const void* u, const void* deg, const void* cells,
                  const void* flags, const void* dfw, const void* dfe,
                  const void* dfs, const void* dfn, const void* dt,
                  const void* ops, const void* Pm, double avg0, int ny, int nx,
                  void* out, cudaStream_t stream) {
  fused_mood_candidate_kernel<T, P>
      <<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
          (const T*)u, (const int*)deg, (const uint8_t*)cells,
          (const uint8_t*)flags, (const T*)dfw, (const T*)dfe, (const T*)dfs,
          (const T*)dfn, (const T*)dt, (const T*)ops, (const T*)Pm, T(avg0),
          ny, nx, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3}.  flags holds one byte per
// 32 x 4 tile (ceil(ny/4) x ceil(nx/32), row-major), cells one byte per cell;
// out is u_prev, updated in place.  Returns cudaGetLastError() after the
// launch, -1 for an unsupported case.
extern "C" int dflo_fused_mood_candidate(int dtype, int p, const void* u,
                                         const void* deg, const void* cells,
                                         const void* flags, const void* dfw,
                                         const void* dfe, const void* dfs,
                                         const void* dfn, const void* dt,
                                         const void* ops, const void* Pm,
                                         double avg0, int ny, int nx,
                                         void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P)                                                      \
  return dflo::launch<T, P>(u, deg, cells, flags, dfw, dfe, dfs, dfn, dt,   \
                            ops, Pm, avg0, ny, nx, out, s)
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
