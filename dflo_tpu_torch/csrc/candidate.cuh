// The MOOD candidate kernel, shared by fused_mood_candidate.cu (hllc) and
// fused_mood_candidate_{lxf,roe,sw,kfvs,kep}.cu: one source per flux so
// that nvcc builds the six fluxes' instantiations side by side (see
// fused_mood_candidate.cu for what it computes and what bounds it).  Each
// flux's source instantiates its fixed P1-P3 candidates and its one general
// candidate per dtype (GDims<true>: degrees 4-6 and the over-integrated Pk
// bases), as residual.cuh's launch_general does for the residual.
#pragma once

#include <stdint.h>

#include "residual.cuh"

namespace dflo {

template <typename T, class D, int FLUX>
__global__ void __launch_bounds__(BX * BY)
fused_mood_candidate_kernel(const T* __restrict__ u, const int* __restrict__ deg,
                            const uint8_t* __restrict__ cells,
                            const uint8_t* __restrict__ flags,
                            const T* __restrict__ dfw, const T* __restrict__ dfe,
                            const T* __restrict__ dfs, const T* __restrict__ dfn,
                            const T* __restrict__ dt, const T* __restrict__ ops,
                            const T* __restrict__ Pm, T avg0, int ny, int nx,
                            T* __restrict__ out, D d) {
  const int K = d.K;
  if (flags[blockIdx.y * gridDim.x + blockIdx.x] == 0) return;  // whole tile
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  if (cells[cell] == 0) return;

  T R[4][D::KMAX], w[4][D::KMAX];
  cell_residual<T, D, true, FLUX>(d, u, deg, Pm, avg0, dfw, dfe, dfs, dfn,
                                  ops, x, y, ny, nx, R, w);
  const T h = dt[0];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[(long)(c * K + k) * plane + cell] = w[c][k] + h * R[c][k];
}

// The operands of one candidate launch (the C entry point's pointers).
struct CandArgs {
  const void *u, *deg, *cells, *flags, *dfw, *dfe, *dfs, *dfn, *dt, *ops,
      *Pm;
  double avg0;
  int ny, nx;
  void* out;
};

template <typename T, int FLUX, class D>
int launch_candidate(const D& d, const CandArgs& a, cudaStream_t stream) {
  fused_mood_candidate_kernel<T, D, FLUX>
      <<<grid_for(a.ny, a.nx), dim3(BX, BY), 0, stream>>>(
          (const T*)a.u, (const int*)a.deg, (const uint8_t*)a.cells,
          (const uint8_t*)a.flags, (const T*)a.dfw, (const T*)a.dfe,
          (const T*)a.dfs, (const T*)a.dfn, (const T*)a.dt, (const T*)a.ops,
          (const T*)a.Pm, T(a.avg0), a.ny, a.nx, (T*)a.out, d);
  return (int)cudaGetLastError();
}

// The launch table of one flux's candidate.  dtype: 0 = float32,
// 1 = float64; the modal Pk basis of degree p (1..6, K = (p+1)(p+2)/2
// modes) on nq x nq quadrature points (nq <= NQ_MAX), with qp positivity
// points (the rows of Pm).  Degrees 1-3 on their default quadrature
// (nq = p + 1) take their own instantiations (BDims); every other basis
// (degrees 4-6, and any over-integrated Pk basis, whose operator buffer
// and strips are laid out for its nq) the flux's general candidate
// (GDims<true>: sizes, the degree and the positivity points read at run
// time; one instantiation per dtype, compiled only in this flux's source;
// modal.cuh modal_dims_case).  flags holds one byte per 32 x 4 tile
// (ceil(ny/4) x ceil(nx/32), row-major), cells one byte per cell; out is
// u_prev, updated in place.  Returns cudaGetLastError() after the launch,
// -1 for an unsupported case.
template <int FLUX>
int candidate_entry(int dtype, int p, int K, int nq, int qp, const void* u,
                    const void* deg, const void* cells, const void* flags,
                    const void* dfw, const void* dfe, const void* dfs,
                    const void* dfn, const void* dt, const void* ops,
                    const void* Pm, double avg0, int ny, int nx, void* out,
                    void* stream) {
  const CandArgs a{u, deg, cells, flags, dfw, dfe, dfs, dfn, dt, ops, Pm,
                   avg0, ny, nx, out};
  cudaStream_t s = (cudaStream_t)stream;
  return modal_dims_case(dtype, p, K, nq, qp, [&](auto zero, const auto& d) {
    return launch_candidate<decltype(zero), FLUX>(d, a, s);
  });
}

}  // namespace dflo
