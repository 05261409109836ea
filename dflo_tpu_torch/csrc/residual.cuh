// The DG residual of one cell, shared by fused_residual.cu (the dense
// residual, its SSP-stage and forward-Euler forms) and
// fused_mood_candidate.cu (the MOOD candidate on {truncated ->
// positivity-limited} states).
//
// Per cell: the volume flux at the Q quadrature points (collocated Qk: the
// DoFs are the point values; modal Pk: W = V u first,
// pallas_kernels.py:450-459), the four face traces of the cell and of each
// face neighbor, one HLLC flux per face and the volume and face lifts with
// minv/area folded into the lift rows.  Neighbors wrap periodically, as on
// the TPU; the caller's delta strips (true boundary flux minus wrap flux,
// solver/spatial.strips) are added at global column 0 / nx-1 and row
// 0 / ny-1.  Each cell recomputes the shared face flux from the same
// operands in the same order as its neighbor ("canonical recompute",
// pallas_kernels.py:184-193), so no face buffer goes through memory.
//
// Every contraction is an ordered sum (one multiply and one add per term,
// in the order of ops/kernels.fused_residual_plain) and the sources are
// built with -fmad=false, so kernel and plain version round alike: the
// MOOD cascade re-applies positivity to the stage predictor, whose branch at
// the pressure floor rounding decides, so an ulp in a residual would change
// later stages.
#pragma once

#include "modal.cuh"

namespace dflo {

// operator buffer layout (ops/kernels.residual_operators)
template <int P, bool MODAL>
struct ResOps {
  using D = BDims<P, MODAL>;
  static constexpr int FACEV = 0;                       // [4][NQ][K]
  static constexpr int LIFT = 4 * D::NQ * D::K;         // [K][NL]
  static constexpr int VOL = LIFT + D::K * D::NL;       // [Q][K] (modal)
};

// face trace (NQ points) of one cell streamed from memory, for face f
template <typename T, int P, bool MODAL>
__device__ __forceinline__ void trace_mem(const T* __restrict__ u,
                                          const T* __restrict__ faceVf,
                                          long plane, long cell,
                                          T tr[4][P + 1]) {
  constexpr int K = BDims<P, MODAL>::K, NQ = P + 1;
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
      for (int q = 0; q < NQ; ++q) acc[q] = acc[q] + faceVf[q * K + k] * v;
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) tr[c][q] = acc[q];
  }
}

// face trace of register-held DoFs w[4][K] (the same operations)
template <typename T, int P, bool MODAL>
__device__ __forceinline__ void trace_reg(const T w[4][BDims<P, MODAL>::K],
                                          const T* __restrict__ faceVf,
                                          T tr[4][P + 1]) {
  constexpr int K = BDims<P, MODAL>::K, NQ = P + 1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = faceVf[q * K] * w[c][0];
#pragma unroll
    for (int k = 1; k < K; ++k)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = acc[q] + faceVf[q * K + k] * w[c][k];
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
template <typename T, int P, bool MODAL>
__device__ __forceinline__ void lift_face(const T* __restrict__ lift, int col0,
                                          const T F[4][P + 1],
                                          T R[4][BDims<P, MODAL>::K]) {
  constexpr int K = BDims<P, MODAL>::K, NQ = P + 1, NL = BDims<P, MODAL>::NL;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const T l = lift[k * NL + col0 + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) R[c][k] = R[c][k] + l * F[c][q];
    }
  }
}

// R[c][k] += lift[k][n] fx[c] + lift[k][Q + n] fy[c] for quadrature point n
template <typename T, int P, bool MODAL>
__device__ __forceinline__ void lift_volume(const T* __restrict__ lift, int n,
                                            const T wq[4],
                                            T R[4][BDims<P, MODAL>::K]) {
  constexpr int K = BDims<P, MODAL>::K, Q = BDims<P, MODAL>::Q,
                NL = BDims<P, MODAL>::NL;
  T fx[4], fy[4];
  flux_xy(wq, fx, fy);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T lx = lift[k * NL + n], ly = lift[k * NL + Q + n];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      R[c][k] = R[c][k] + lx * fx[c];
      R[c][k] = R[c][k] + ly * fy[c];
    }
  }
}

// A face neighbor's trace on face f: streamed, or (TP) from its DoFs after
// truncation to its own degree and positivity.
template <typename T, int P, bool MODAL, bool TP>
__device__ __forceinline__ void neighbor_trace(
    const T* __restrict__ u, const int* __restrict__ deg,
    const T* __restrict__ Pm, T avg0, const T* __restrict__ faceVf,
    long plane, long ncell, T tr[4][P + 1]) {
  if constexpr (TP) {
    T v[4][BDims<P, MODAL>::K];
    load_cell<T, BDims<P, MODAL>::K>(u, plane, ncell, v);
    modal_tp<T, P>(v, __ldg(deg + ncell), Pm, avg0);
    trace_reg<T, P, MODAL>(v, faceVf, tr);
  } else {
    trace_mem<T, P, MODAL>(u, faceVf, plane, ncell, tr);
  }
}

// The residual R = M^{-1} R(u) of cell (x, y), in R[4][K].  REG: the cell's
// DoFs are held in w[4][K] (always for the modal basis, which contracts
// them with V; with TP they are {truncated -> positivity-limited} first,
// and so is every neighbor before its trace); otherwise (collocated Qk)
// they are streamed from memory and w is not written.
template <typename T, int P, bool MODAL, bool TP>
__device__ __forceinline__ void cell_residual(
    const T* __restrict__ u, const int* __restrict__ deg,
    const T* __restrict__ Pm, T avg0, const T* __restrict__ dfw,
    const T* __restrict__ dfe, const T* __restrict__ dfs,
    const T* __restrict__ dfn, const T* __restrict__ ops, int x, int y,
    int ny, int nx, T R[4][BDims<P, MODAL>::K],
    T w[4][BDims<P, MODAL>::K]) {
  static_assert(MODAL || !TP, "truncation needs the modal basis");
  using D = BDims<P, MODAL>;
  using O = ResOps<P, MODAL>;
  constexpr int K = D::K, NQ = D::NQ, Q = D::Q;
  constexpr bool REG = MODAL || TP;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  const int xw = x == 0 ? nx - 1 : x - 1;
  const int xe = x == nx - 1 ? 0 : x + 1;
  const int ys = y == 0 ? ny - 1 : y - 1;
  const int yn = y == ny - 1 ? 0 : y + 1;
  const T* faceV = ops + O::FACEV;
  const T* lift = ops + O::LIFT;

#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) R[c][k] = T(0);

  // ---- volume term --------------------------------------------------------
  if constexpr (REG) {
    load_cell<T, K>(u, plane, cell, w);
    if constexpr (TP) modal_tp<T, P>(w, __ldg(deg + cell), Pm, avg0);
  }
  if constexpr (MODAL) {
    const T* V = ops + O::VOL;
#pragma unroll
    for (int n = 0; n < Q; ++n) {
      T wq[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T acc = V[n * K] * w[c][0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + V[n * K + k] * w[c][k];
        wq[c] = acc;
      }
      lift_volume<T, P, MODAL>(lift, n, wq, R);
    }
  } else {
    // collocated: the nodes are the quadrature points
#pragma unroll
    for (int n = 0; n < K; ++n) {
      T wq[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wq[c] = __ldg(u + (long)(c * K + n) * plane + cell);
      lift_volume<T, P, MODAL>(lift, n, wq, R);
    }
  }

  T own[4][NQ], nb[4][NQ], F[4][NQ];
  auto own_trace = [&](int f) {
    if constexpr (REG) trace_reg<T, P, MODAL>(w, faceV + f * NQ * K, own);
    else trace_mem<T, P, MODAL>(u, faceV + f * NQ * K, plane, cell, own);
  };
  // ---- west face: left = west neighbor's east trace -----------------------
  own_trace(0);
  neighbor_trace<T, P, MODAL, TP>(u, deg, Pm, avg0, faceV + 1 * NQ * K, plane,
                                  (long)y * nx + xw, nb);
  face_flux<T, P>(nb, own, T(1), T(0), F);
  if (x == 0)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfw[(c * NQ + q) * ny + y];
  lift_face<T, P, MODAL>(lift, 2 * Q + 0 * NQ, F, R);

  // ---- east face: right = east neighbor's west trace ----------------------
  own_trace(1);
  neighbor_trace<T, P, MODAL, TP>(u, deg, Pm, avg0, faceV + 0 * NQ * K, plane,
                                  (long)y * nx + xe, nb);
  face_flux<T, P>(own, nb, T(1), T(0), F);
  if (x == nx - 1)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfe[(c * NQ + q) * ny + y];
  lift_face<T, P, MODAL>(lift, 2 * Q + 1 * NQ, F, R);

  // ---- south face: left = south neighbor's north trace --------------------
  own_trace(2);
  neighbor_trace<T, P, MODAL, TP>(u, deg, Pm, avg0, faceV + 3 * NQ * K, plane,
                                  (long)ys * nx + x, nb);
  face_flux<T, P>(nb, own, T(0), T(1), F);
  if (y == 0)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfs[(c * NQ + q) * nx + x];
  lift_face<T, P, MODAL>(lift, 2 * Q + 2 * NQ, F, R);

  // ---- north face: right = north neighbor's south trace -------------------
  own_trace(3);
  neighbor_trace<T, P, MODAL, TP>(u, deg, Pm, avg0, faceV + 2 * NQ * K, plane,
                                  (long)yn * nx + x, nb);
  face_flux<T, P>(own, nb, T(0), T(1), F);
  if (y == ny - 1)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < NQ; ++q) F[c][q] += dfn[(c * NQ + q) * nx + x];
  lift_face<T, P, MODAL>(lift, 2 * Q + 3 * NQ, F, R);
}

}  // namespace dflo
