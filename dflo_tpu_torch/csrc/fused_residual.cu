// Fused DG residual of the explicit RK/TVB step, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual (the dense
// entry `fused`, kernel body _fused_kernel) in its collocated-Qk, hllc,
// unmasked form, plain and blended.  It computes M^{-1} R(u): the volume
// flux, the four face traces, one HLLC flux per face and the volume and face
// lifts with minv/area folded into the lift rows; with `uold` it writes the
// SSP stage a*u_old + (1-a)*(u + dt*R), [a, dt] read from a device pointer
// so the host never waits on dt.  Neighbors wrap periodically, exactly as on
// the TPU; the caller's delta strips (true boundary flux minus wrap flux,
// solver/spatial.strips) are added at global column 0 / nx-1 and row
// 0 / ny-1.
//
// What bounds it on the H100: bytes.  One thread per cell, adjacent threads
// on adjacent x, so every (c, k) plane of the [4, K, ny, nx] state loads
// coalesced; each cell reads its own 4K values and the 4K values of each of
// its four neighbors (roughly 5x the state through L1/L2 per call) and writes
// 4K values.  The arithmetic (two HLLC evaluations per face, each flux
// computed by both of its cells) is small beside that at double precision
// rates.  Each cell recomputes the shared face flux from the same operands
// in the same order as its neighbor ("canonical recompute",
// pallas_kernels.py:184-193), so no face buffer goes through memory.
//
// What the simple design does about it: a 32 x 4 block keeps a warp on 32
// contiguous cells and puts the north/south neighbor rows of most cells in
// the same block, so those re-reads hit L1.  A later version stages a shared-
// memory tile with a one-cell halo (one read of the state per block) and
// bakes the sparse operator constants into the source.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

// face trace (nq points) of one cell, for face f
template <typename T, int P>
__device__ __forceinline__ void trace(const T* __restrict__ u,
                                      const T* __restrict__ faceVf, long plane,
                                      long cell, T tr[4][P + 1]) {
  constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T acc[NQ];
    T v = __ldg(u + (long)(c * K) * plane + cell);
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = faceVf[q * K] * v;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      v = __ldg(u + (long)(c * K + k) * plane + cell);
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = fma(faceVf[q * K + k], v, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) tr[c][q] = acc[q];
  }
}

// HLLC at the nq points of one face, FL/FR the left/right traces along the
// +x (nx=1) or +y (ny=1) normal; F[c][q]
template <typename T, int P>
__device__ __forceinline__ void face_flux(const T FL[4][P + 1],
                                          const T FR[4][P + 1], T nx, T ny,
                                          T F[4][P + 1]) {
#pragma unroll
  for (int q = 0; q < P + 1; ++q) {
    const T l[4] = {FL[0][q], FL[1][q], FL[2][q], FL[3][q]};
    const T r[4] = {FR[0][q], FR[1][q], FR[2][q], FR[3][q]};
    T f[4];
    hllc(l, r, nx, ny, f);
#pragma unroll
    for (int c = 0; c < 4; ++c) F[c][q] = f[c];
  }
}

// R[c][k] += lift[k][col0 + q] * F[c][q]
template <typename T, int P>
__device__ __forceinline__ void lift_face(const T* __restrict__ lift, int col0,
                                          const T F[4][P + 1],
                                          T R[4][Dims<P>::K]) {
  constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ, NL = Dims<P>::NL;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const T l = lift[k * NL + col0 + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) R[c][k] = fma(l, F[c][q], R[c][k]);
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(BX * BY)
fused_residual_kernel(const T* __restrict__ u, const T* __restrict__ dfw,
                      const T* __restrict__ dfe, const T* __restrict__ dfs,
                      const T* __restrict__ dfn, const T* __restrict__ uold,
                      const T* __restrict__ sc, const T* __restrict__ ops,
                      T* __restrict__ out, int ny, int nx) {
  constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ, NL = Dims<P>::NL;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  const int xw = x == 0 ? nx - 1 : x - 1;
  const int xe = x == nx - 1 ? 0 : x + 1;
  const int ys = y == 0 ? ny - 1 : y - 1;
  const int yn = y == ny - 1 ? 0 : y + 1;
  const T* faceV = ops;                 // [4][NQ][K]
  const T* lift = ops + 4 * NQ * K;     // [K][NL]

  T R[4][K];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) R[c][k] = T(0);

  // ---- volume term: nodes are the quadrature points (collocated) --------
#pragma unroll
  for (int n = 0; n < K; ++n) {
    T w[4], fx[4], fy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = __ldg(u + (long)(c * K + n) * plane + cell);
    flux_xy(w, fx, fy);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T lx = lift[k * NL + n], ly = lift[k * NL + K + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        R[c][k] = fma(lx, fx[c], R[c][k]);
        R[c][k] = fma(ly, fy[c], R[c][k]);
      }
    }
  }

  T own[4][NQ], nb[4][NQ], F[4][NQ];
  // ---- west face: left = west neighbor's east trace ---------------------
  trace<T, P>(u, faceV + 0 * NQ * K, plane, cell, own);
  trace<T, P>(u, faceV + 1 * NQ * K, plane, (long)y * nx + xw, nb);
  face_flux<T, P>(nb, own, T(1), T(0), F);
  if (x == 0)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfw[(c * NQ + q) * ny + y];
  lift_face<T, P>(lift, 2 * K + 0 * NQ, F, R);

  // ---- east face: right = east neighbor's west trace --------------------
  trace<T, P>(u, faceV + 1 * NQ * K, plane, cell, own);
  trace<T, P>(u, faceV + 0 * NQ * K, plane, (long)y * nx + xe, nb);
  face_flux<T, P>(own, nb, T(1), T(0), F);
  if (x == nx - 1)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfe[(c * NQ + q) * ny + y];
  lift_face<T, P>(lift, 2 * K + 1 * NQ, F, R);

  // ---- south face: left = south neighbor's north trace ------------------
  trace<T, P>(u, faceV + 2 * NQ * K, plane, cell, own);
  trace<T, P>(u, faceV + 3 * NQ * K, plane, (long)ys * nx + x, nb);
  face_flux<T, P>(nb, own, T(0), T(1), F);
  if (y == 0)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfs[(c * NQ + q) * nx + x];
  lift_face<T, P>(lift, 2 * K + 2 * NQ, F, R);

  // ---- north face: right = north neighbor's south trace -----------------
  trace<T, P>(u, faceV + 3 * NQ * K, plane, cell, own);
  trace<T, P>(u, faceV + 2 * NQ * K, plane, (long)yn * nx + x, nb);
  face_flux<T, P>(own, nb, T(0), T(1), F);
  if (y == ny - 1)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfn[(c * NQ + q) * nx + x];
  lift_face<T, P>(lift, 2 * K + 3 * NQ, F, R);

  // ---- write R, or the SSP stage ----------------------------------------
  if (uold == nullptr) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = R[c][k];
  } else {
    const T a = sc[0], dt = sc[1];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long i = (long)(c * K + k) * plane + cell;
        out[i] = a * __ldg(uold + i) + (T(1) - a) * (__ldg(u + i) + dt * R[c][k]);
      }
  }
}

template <typename T, int P>
static int launch(const void* u, const void* dfw, const void* dfe,
                  const void* dfs, const void* dfn, const void* uold,
                  const void* sc, const void* ops, void* out, int ny, int nx,
                  cudaStream_t stream) {
  fused_residual_kernel<T, P><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)dfw, (const T*)dfe, (const T*)dfs, (const T*)dfn,
      (const T*)uold, (const T*)sc, (const T*)ops, (T*)out, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3}.  Returns the
// cudaGetLastError() code after the launch (0 = launched), -1 for an
// unsupported (dtype, p).
extern "C" int dflo_fused_residual(int dtype, int p, const void* u,
                                   const void* dfw, const void* dfe,
                                   const void* dfs, const void* dfn,
                                   const void* uold, const void* sc,
                                   const void* ops, void* out, int ny, int nx,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P)                                                        \
  return dflo::launch<T, P>(u, dfw, dfe, dfs, dfn, uold, sc, ops, out, ny, nx, \
                            s)
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

// number of thread blocks (= diagnostic partials) for an ny x nx grid
extern "C" int dflo_num_blocks(int ny, int nx) {
  const dim3 g = dflo::grid_for(ny, nx);
  return (int)(g.x * g.y);
}
