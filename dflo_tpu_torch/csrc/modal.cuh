// The {Pk degree truncation -> Zhang-Shu positivity} chain on one cell of
// the modal Pk basis, shared by fused_modal_pos.cu, fused_mood_candidate.cu
// (applied to a cell and to each of its face neighbors before tracing) and
// fused_pk_post.cu (positivity only), so all three round alike.
//
// The mirror of dflo_tpu/ops/pallas_kernels.py _modal_tp_slabs and
// _modal_pos_slabs (:196-265): truncation zeroes every mode whose total
// degree exceeds the cell's degree (reduce_degree_Pk, src/mood.cc:174-191);
// positivity scales about the mode-0 mean with the dtype-aware floors.  The
// plain twin is dflo_tpu_torch/ops/kernels.modal_tp_plain.
#pragma once

#include "euler.cuh"

namespace dflo {

// total degree i + j of mode k in the reference ordering (j outer, i inner,
// i + j <= P: ops/basis._pk_index); constant-folded in unrolled loops
template <int P>
__host__ __device__ constexpr int pk_mode_degree(int k) {
  int n = 0;
  for (int j = 0; j <= P; ++j)
    for (int i = 0; i <= P - j; ++i, ++n)
      if (n == k) return i + j;
  return -1;
}

// Zhang-Shu positivity on the modal DoFs w[4][K] about the cell mean ub
// (stab/positivity with the modal scaling): mode 0 mixes with the mean,
// the other modes shrink.
template <typename T, int P>
__device__ __forceinline__ void modal_pos(T w[4][BDims<P, true>::K],
                                          const T ub[4],
                                          const T* __restrict__ Pm) {
  constexpr int K = BDims<P, true>::K;
  T theta1, theta2;
  zs_thetas<T>(BDims<P, true>{}, w, ub, Pm, theta1, theta2);
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

// truncation to degree deg, then positivity about the (truncation-
// invariant) mode-0 mean avg0 * w[c][0]
template <typename T, int P>
__device__ __forceinline__ void modal_tp(T w[4][BDims<P, true>::K], int deg,
                                         const T* __restrict__ Pm, T avg0) {
  constexpr int K = BDims<P, true>::K;
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (deg < pk_mode_degree<P>(k))
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c][k] = T(0);
  T ub[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ub[c] = avg0 * w[c][0];
  modal_pos<T, P>(w, ub, Pm);
}

// one cell's DoFs [4][K] from the [4, K, ny, nx] state
template <typename T, int K>
__device__ __forceinline__ void load_cell(const T* __restrict__ u, long plane,
                                          long cell, T w[4][K]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) w[c][k] = __ldg(u + (long)(c * K + k) * plane + cell);
}

}  // namespace dflo
