// The MOOD candidate kernel, shared by fused_mood_candidate.cu (hllc) and
// fused_mood_candidate_{lxf,roe,sw,kfvs,kep}.cu: one source per flux so
// that nvcc builds the six fluxes' instantiations side by side (see
// fused_mood_candidate.cu for what it computes and what bounds it).
#pragma once

#include <stdint.h>

#include "residual.cuh"

namespace dflo {

template <typename T, int P, int FLUX>
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
  cell_residual<T, BDims<P, true>, true, FLUX>(BDims<P, true>{}, u, deg, Pm,
                                               avg0, dfw, dfe, dfs, dfn, ops,
                                               x, y, ny, nx, R, w);
  const T h = dt[0];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[(long)(c * K + k) * plane + cell] = w[c][k] + h * R[c][k];
}

template <typename T, int P, int FLUX>
int launch_candidate(const void* u, const void* deg, const void* cells,
                  const void* flags, const void* dfw, const void* dfe,
                  const void* dfs, const void* dfn, const void* dt,
                  const void* ops, const void* Pm, double avg0, int ny, int nx,
                  void* out, cudaStream_t stream) {
  fused_mood_candidate_kernel<T, P, FLUX>
      <<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
          (const T*)u, (const int*)deg, (const uint8_t*)cells,
          (const uint8_t*)flags, (const T*)dfw, (const T*)dfe, (const T*)dfs,
          (const T*)dfn, (const T*)dt, (const T*)ops, (const T*)Pm, T(avg0),
          ny, nx, (T*)out);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3}.  flags holds one byte
// per 32 x 4 tile (ceil(ny/4) x ceil(nx/32), row-major), cells one byte per
// cell; out is u_prev, updated in place.  Returns cudaGetLastError() after
// the launch, -1 for an unsupported case.
template <int FLUX>
int candidate_entry(int dtype, int p, const void* u, const void* deg,
                    const void* cells, const void* flags, const void* dfw,
                    const void* dfe, const void* dfs, const void* dfn,
                    const void* dt, const void* ops, const void* Pm,
                    double avg0, int ny, int nx, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P)                                                      \
  return launch_candidate<T, P, FLUX>(u, deg, cells, flags, dfw, dfe, dfs,  \
                                      dfn, dt, ops, Pm, avg0, ny, nx, out, s)
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

}  // namespace dflo
