// Zhang-Shu positivity about the mode-0 mean on one cell of the modal Pk
// basis, held by one thread (fused_pk_post.cu), and the run-time degree of
// each mode that the tile kernels' truncation reads (tile.cuh); the tile
// kernels (the MOOD candidate, residual.cuh, and the modal positivity,
// fused_modal_pos.cu) run the same operations on their staged cells, a
// positivity point per thread (euler.cuh zs_floors, zs_theta1, zs_point_t),
// so all three round alike.
//
// The mirror of dflo_tpu/ops/pallas_kernels.py _modal_tp_slabs and
// _modal_pos_slabs (:196-265): truncation zeroes every mode whose total
// degree exceeds the cell's degree (reduce_degree_Pk, src/mood.cc:174-191);
// positivity scales about the mode-0 mean with the dtype-aware floors.  The
// plain twin is dflo_tpu_torch/ops/kernels.modal_tp_plain.  Every function
// takes the modal dims (euler.cuh): BDims<P, true> for P1-P3, GDims<true>
// for degrees 4-6 and the over-integrated Pk bases.
#pragma once

#include "euler.cuh"

namespace dflo {

// total degree i + j of mode k in the reference ordering (j outer, i inner,
// i + j <= P: ops/basis._pk_index), for a degree P read at run time (the
// tile kernels' truncation, tile.cuh)
__device__ __forceinline__ int mode_degree(int P, int k) {
  for (int j = 0; j <= P; ++j) {
    const int row = P - j + 1;
    if (k < row) return j + k;
    k -= row;
  }
  return P + 1;
}

// one cell's DoFs [4][K] from the [4, K, ny, nx] state
template <typename T, class D>
__device__ __forceinline__ void load_cell(const D& d, const T* __restrict__ u,
                                          long plane, long cell,
                                          T w[4][D::KMAX]) {
  const int K = d.K;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[c][k] = __ldg(u + (long)(c * K + k) * plane + cell);
}

// Zhang-Shu positivity on the modal DoFs w[4][K] about the cell mean ub
// (stab/positivity with the modal scaling): mode 0 mixes with the mean,
// the other modes shrink.  d: the modal dims, BDims<P, true> for P1-P3 or
// GDims<true> (K and the d.QP positivity points read at run time).
template <typename T, class D>
__device__ __forceinline__ void modal_pos(const D& d, T w[4][D::KMAX],
                                          const T ub[4],
                                          const T* __restrict__ Pm) {
  const int K = d.K;
  T theta1, theta2;
  zs_thetas<T>(d, w, ub, Pm, theta1, theta2);
  w[RHO][0] = w[RHO][0] * theta1 + ub[RHO] * (T(1) - theta1);
#pragma unroll
  for (int k = 1; k < K; ++k) w[RHO][k] = w[RHO][k] * theta1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c][0] = w[c][0] * theta2 + ub[c] * (T(1) - theta2);
#pragma unroll
    for (int k = 1; k < K; ++k) w[c][k] = w[c][k] * theta2;
  }
}

// The dims of a kernel on the modal Pk basis (the candidate, the modal
// positivity, the Pk post) from the degree p, the K modes, the nq x nq
// quadrature points (the candidate's residual reads them; the other two
// pass p + 1) and the qp positivity points: P1-P3 on nq = p + 1 take their
// fixed dims (an instantiation each), every other basis the general modal
// dims (one instantiation per dtype); run(T(0), dims) launches and returns
// cudaGetLastError(), -1 for a case outside these (dtype 0 = float32,
// 1 = float64).
template <typename T, class F>
int modal_dims_typed(int p, int K, int nq, int qp, F& run) {
  if (nq == p + 1 && p <= 3) {
    if (p == 1 && qp == BDims<1, true>::QP) return run(T(0), BDims<1, true>{});
    if (p == 2 && qp == BDims<2, true>::QP) return run(T(0), BDims<2, true>{});
    if (p == 3 && qp == BDims<3, true>::QP) return run(T(0), BDims<3, true>{});
    return -1;
  }
  return run(T(0), general_dims<true>(K, nq, qp, p));
}

template <class F>
int modal_dims_case(int dtype, int p, int K, int nq, int qp, F&& run) {
  if (p < 1 || p > 6 || K != (p + 1) * (p + 2) / 2 || nq < 1 ||
      nq > NQ_MAX || qp < 1)
    return -1;
  if (dtype == 0) return modal_dims_typed<float>(p, K, nq, qp, run);
  if (dtype == 1) return modal_dims_typed<double>(p, K, nq, qp, run);
  return -1;
}

}  // namespace dflo
