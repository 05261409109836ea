// The pieces of the tile kernels, shared by the residual and the MOOD
// candidate (residual.cuh), the nodal post (fused_post.cu), the modal
// positivity (fused_modal_pos.cu), the Pk post (fused_pk_post.cu) and the
// MOOD check (fused_mood_check.cu): one block of TNT threads per tile of
// TY x TX cells, the tile's DoFs (and, for the residual and the post, a
// one-cell ring) staged once in dynamic shared memory, each product an
// ordered sum per output (register-tiled where it has the rows), and
// Zhang-Shu positivity with its points spread over the threads.  Every
// function here is called by every thread of the block unless it says
// otherwise.
#pragma once

#include <stdint.h>

#include "modal.cuh"

namespace dflo {

// threads per block of the tile kernels (ops/kernels.TILE_THREADS), and the
// register tile of their products: RB rows (modes or points) by CB cells
constexpr int TNT = 256;
constexpr int RB = 4;
constexpr int CB = 4;
// the dynamic shared memory a block may take on the H100 (227 kB)
constexpr int MAX_SMEM = 232448;

// i / d for 0 <= i < 2^22 through a float reciprocal: (i + 1/2) r is within
// a relative 2^-23 of (i + 1/2) / d, which lies at least 1/(2d) from an
// integer, so the truncation is exact (cheaper than an integer division by
// a divisor known only at run time)
struct FDiv {
  int d;
  float r;
  __device__ __forceinline__ explicit FDiv(int d_)
      : d(d_), r(1.0f / (float)d_) {}
  __device__ __forceinline__ int q(int i) const {
    return (int)(((float)i + 0.5f) * r);
  }
};

// v in [-1, n + tile) wrapped periodically into [0, n)
__device__ __forceinline__ int wrap_index(int v, int n) {
  v = v < 0 ? v + n : v;
  return v < n ? v : v % n;
}

// one element from global to shared memory without a register round trip
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

// 16 bytes (one vector; both addresses 16-byte aligned) from global to
// shared memory, past L1
template <typename T>
__device__ __forceinline__ void copy_async16(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
#else
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}

// Stage SS cells' nplanes planes into Us [nplanes][SS]: np = TNT / SS
// threads per staged cell (at least one), part p of cell s copying planes
// p, p + np, ... from src + plane * stride, where cell(s, src, stride)
// gives the cell's first value and its plane stride (false: a cell no tile
// cell reads, left unstaged); once(s) runs on part 0 of every staged cell
// (its flag bytes or its degree).  Ends with the copies' wait and a barrier.
template <typename T, class Cell, class Once>
__device__ __forceinline__ void stage_tile(T* Us, int SS, int nplanes,
                                           Cell cell, Once once) {
  const FDiv dSS(SS);
  const int np = TNT >= SS ? TNT / SS : 1;
  for (int t = threadIdx.x; t < np * SS; t += TNT) {
    const int p = dSS.q(t), s = t - p * SS;
    const T* src;
    long stride;
    if (!cell(s, src, stride)) continue;
    for (int ck = p; ck < nplanes; ck += np)
      copy_async(Us + ck * SS + s, src + ck * stride);
    if (p == 0) once(s);
  }
  copy_async_wait();
  __syncthreads();
}

// One register tile of a product with the staged DoFs: acc[i][j] = sum_k
// M[r_i][k] Uc[k][s_j], rows r_i = min(r0 + i, NR - 1), Uc = one
// component's staged planes; one multiply and one add per term in k order,
// the first term a product (trace_mem, point_state, contract._ordered_sum)
template <int RT, int CT, typename T, class D>
__device__ __forceinline__ void row_tile(const D& d, const T* __restrict__ M,
                                         int r0, int NR, const T* Uc, int SS,
                                         const int s[CT], T acc[RT][CT]) {
  const int K = d.K;
  const T* m[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) m[i] = M + (r0 + i < NR ? r0 + i : NR - 1) * K;
  T a[RT], b[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) b[j] = Uc[s[j]];
#pragma unroll
  for (int i = 0; i < RT; ++i) a[i] = __ldg(m[i]);
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = a[i] * b[j];
  // unrolled by 4: the next terms' loads go out before this term's
  // products
#pragma unroll 4
  for (int k = 1; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < CT; ++j) b[j] = Uc[k * SS + s[j]];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = __ldg(m[i] + k);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
  }
}

// Group g of the product sum_k M[r][k] U[c][k][sidx(i)] over the NR rows
// of M, the four components and NCELL cells, stored at out[oidx(c, r, i,
// s)] (s = sidx(i)): the register tile of component c, rows rb*RT.. and
// cells cb + j*ncb (strided, so that neighbouring threads take
// neighbouring cells)
template <int RT, int CT, typename T, class D, class SIdx, class OIdx>
__device__ __forceinline__ void row_group(const D& d, const T* __restrict__ M,
                                          int NR, const T* Us, int SS,
                                          int NCELL, SIdx sidx, OIdx oidx,
                                          T* out, int g) {
  const int nrb = (NR + RT - 1) / RT, ncb = (NCELL + CT - 1) / CT;
  const int cb = g % ncb, rb = (g / ncb) % nrb, c = g / (ncb * nrb);
  int s[CT], cell[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    cell[j] = cb + j * ncb;
    s[j] = sidx(cell[j] < NCELL ? cell[j] : NCELL - 1);
  }
  T acc[RT][CT];
  row_tile<RT, CT, T>(d, M, rb * RT, NR, Us + c * d.K * SS, SS, s, acc);
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (rb * RT + i < NR && cell[j] < NCELL)
        out[oidx(c, rb * RT + i, cell[j], s[j])] = acc[i][j];
}

// the register tiles of that product
template <int RT, int CT>
__device__ __forceinline__ int row_groups(int NR, int NCELL) {
  return 4 * ((NR + RT - 1) / RT) * ((NCELL + CT - 1) / CT);
}

// The product out[(c NR + r) NCELL + i] over all its groups, the block's
// threads in turn; the caller synchronises
template <int RT, int CT, typename T, class D, class SIdx>
__device__ __forceinline__ void apply_rows(const D& d, const T* __restrict__ M,
                                           int NR, const T* Us, int SS,
                                           int NCELL, SIdx sidx, T* out) {
  for (int g = threadIdx.x; g < row_groups<RT, CT>(NR, NCELL); g += TNT)
    row_group<RT, CT, T>(
        d, M, NR, Us, SS, NCELL, sidx,
        [=](int c, int r, int i, int) { return (c * NR + r) * NCELL + i; },
        out, g);
}

// Group g of the four cell averages of every staged cell, Av[c][s] =
// sum_k avg[k] Us[c][k][s] (the ordered sum of contract.basis_reduce), as
// register tiles of CB cells; avg_groups(SS) of them
__host__ __device__ constexpr int avg_groups(int SS) {
  return 4 * ((SS + CB - 1) / CB);
}

template <typename T, class D>
__device__ __forceinline__ void avg_group(const D& d,
                                          const T* __restrict__ avg,
                                          const T* Us, int SS, T* Av, int g) {
  row_group<1, CB, T>(
      d, avg, 1, Us, SS, SS, [](int s) { return s; },
      [=](int c, int, int, int s) { return c * SS + s; }, Av, g);
}

// All of them, the block's threads in turn; the caller synchronises
template <typename T, class D>
__device__ __forceinline__ void tile_averages(const D& d,
                                              const T* __restrict__ avg,
                                              const T* Us, int SS, T* Av) {
  for (int g = threadIdx.x; g < avg_groups(SS); g += TNT)
    avg_group<T>(d, avg, Us, SS, Av, g);
}

// Truncation to a per-cell degree (modal Pk, reduce_degree_Pk): of the n
// cells j at staged index sidx(j) of Us [4][K][SS], zero every mode whose
// total degree exceeds the cell's degree Ds[sidx(j)] (exact assignments:
// the order does not matter).  Ends with a barrier.
template <typename T, class D, class SIdx>
__device__ __forceinline__ void tile_truncate(const D& d, T* Us, int SS,
                                              int n, SIdx sidx,
                                              const int* Ds) {
  const int K = d.K;
  const FDiv dn(n);
  for (int i = threadIdx.x; i < K * n; i += TNT) {
    const int k = dn.q(i), s = sidx(i - k * n);
    if (Ds[s] < mode_degree(d.P, k))
#pragma unroll
      for (int c = 0; c < 4; ++c) Us[(c * K + k) * SS + s] = T(0);
  }
  __syncthreads();
}

// the register tile of the positivity points' products: PR points (one
// vector load of the transposed points) x PC cells per thread, each an
// ordered sum over k as zs_thetas' loops
constexpr int PR = 4;
constexpr int PC = 1;

// the positivity points padded to a multiple of PR (the padding zero)
__host__ __device__ constexpr int pad_points(int qp) {
  return (qp + PR - 1) / PR * PR;
}

// The positivity points Pm [QP][K] transposed into pmt [K][QPP] (QPP =
// pad_points(QP), the padding zero) in shared memory, so that PR points of
// one mode are one vector load; the staging's barrier follows
template <typename T>
__device__ __forceinline__ void stage_points(const T* __restrict__ Pm, int K,
                                             int QP, T* pmt) {
  const int QPP = pad_points(QP);
  const FDiv dQ(QPP);
  for (int i = threadIdx.x; i < K * QPP; i += TNT) {
    const int k = dQ.q(i), q = i - k * QPP;
    pmt[i] = q < QP ? __ldg(Pm + q * K + k) : T(0);
  }
}

// the PR points of one mode at p (16-byte aligned) into registers
template <typename T>
__device__ __forceinline__ void load_points(const T* p, T a[PR]) {
  static_assert(PR % 4 == 0, "vector loads of four points");
#pragma unroll
  for (int i = 0; i < PR; i += 4) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(p + i);
      const double2 w = *reinterpret_cast<const double2*>(p + i + 2);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = w.x;
      a[i + 3] = w.y;
    }
  }
}

// One register tile of the points' products: acc[c][i][j] = sum_k pmt[k][q0
// + i] Us[cs[c] + k SS + s[j]] for NCOMP components, each an ordered sum
// over k, the first term a product (contract.basis_apply_ordered)
template <int NCOMP, typename T>
__device__ __forceinline__ void point_tile(const T* pmt, int QPP, int K,
                                           int q0, const T* Us, int SS,
                                           const int cs[NCOMP],
                                           const int s[PC],
                                           T acc[NCOMP][PR][PC]) {
  T a[PR], b[NCOMP][PC];
  load_points(pmt + q0, a);
#pragma unroll
  for (int c = 0; c < NCOMP; ++c)
#pragma unroll
    for (int j = 0; j < PC; ++j) b[c][j] = Us[cs[c] + s[j]];
#pragma unroll
  for (int c = 0; c < NCOMP; ++c)
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[c][i][j] = a[i] * b[c][j];
#pragma unroll 2
  for (int k = 1; k < K; ++k) {
    load_points(pmt + k * QPP + q0, a);
#pragma unroll
    for (int c = 0; c < NCOMP; ++c)
#pragma unroll
      for (int j = 0; j < PC; ++j) b[c][j] = Us[cs[c] + k * SS + s[j]];
#pragma unroll
    for (int c = 0; c < NCOMP; ++c)
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j)
          acc[c][i][j] = acc[c][i][j] + a[i] * b[c][j];
  }
}

// Zhang-Shu positivity's scale factors of n staged cells, cell j at staged
// index sidx(j) of Us [4][K][SS], about its mean mean(j, ub): the density
// at each positivity point (pmt, the transposed points of stage_points),
// theta1 per cell, the pressure factor at each point, theta2 per cell
// (euler.cuh zs_floors, zs_theta1, zs_point_t: the operations of
// zs_thetas in its order); the points' products as register tiles of PR
// points x PC cells, each thread's zs_point_t on the points it computed.
// scr holds QPP n values, tps 7 n: each cell's mean ub[4], eps_p, theta1
// and theta2 (tps[c n + j] = ub[c]; tile_scale applies them).  Ends with
// a barrier.
template <typename T, class D, class SIdx, class Mean>
__device__ __forceinline__ void tile_thetas(const D& d, const T* Us, int SS,
                                            int n, SIdx sidx, Mean mean,
                                            const T* pmt, T* scr, T* tps) {
  const int K = d.K, QP = d.QP, QPP = pad_points(QP), tid = threadIdx.x;
  const int nqb = QPP / PR, ncb = (n + PC - 1) / PC;
  // the group g's points qb*PR.. and cells cb + jj*ncb (neighbouring
  // threads on neighbouring cells) and their staged indices
  auto group = [&](int g, int& q0, int j[PC], int s[PC]) {
    const int cb = g % ncb;
    q0 = (g / ncb) * PR;
#pragma unroll
    for (int jj = 0; jj < PC; ++jj) {
      j[jj] = cb + jj * ncb;
      s[jj] = sidx(j[jj] < n ? j[jj] : n - 1);
    }
  };
  // the density at each positivity point (zs_thetas' first loop)
  const int crho[1] = {RHO * K * SS};
  for (int g = tid; g < nqb * ncb; g += TNT) {
    int q0, j[PC], s[PC];
    group(g, q0, j, s);
    T acc[1][PR][PC];
    point_tile<1, T>(pmt, QPP, K, q0, Us, SS, crho, s, acc);
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int jj = 0; jj < PC; ++jj)
        if (j[jj] < n) scr[(q0 + i) * n + j[jj]] = acc[0][i][jj];
  }
  __syncthreads();
  for (int j = tid; j < n; j += TNT) {
    T ub[4], eps_r, eps_p;
    mean(j, ub);
    zs_floors(ub, eps_r, eps_p);
    T rho_min = T(INFINITY);
    for (int q = 0; q < QP; ++q) rho_min = nmin(rho_min, scr[q * n + j]);
#pragma unroll
    for (int c = 0; c < 4; ++c) tps[c * n + j] = ub[c];
    tps[4 * n + j] = eps_p;
    tps[5 * n + j] = zs_theta1(ub[RHO], eps_r, rho_min);
  }
  __syncthreads();
  // the pressure factor at each positivity point (its second loop): the
  // momenta's and the energy's point values of the group beside the
  // density's from the first loop (the same sums), then zs_point_t on each
  // point, which writes its factor over its density
  const int cs[3] = {MX * K * SS, MY * K * SS, ENE * K * SS};
  for (int g = tid; g < nqb * ncb; g += TNT) {
    int q0, j[PC], s[PC];
    group(g, q0, j, s);
    T acc[3][PR][PC];
    point_tile<3, T>(pmt, QPP, K, q0, Us, SS, cs, s, acc);
#pragma unroll
    for (int jj = 0; jj < PC; ++jj) {
      if (j[jj] >= n) continue;
      T ub[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ub[c] = tps[c * n + j[jj]];
      const T theta1 = tps[5 * n + j[jj]], eps_p = tps[4 * n + j[jj]];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        if (q0 + i >= QP) continue;
        T* sp = scr + (q0 + i) * n + j[jj];
        T Wq[4];
        Wq[MX] = acc[0][i][jj];
        Wq[MY] = acc[1][i][jj];
        Wq[RHO] = *sp;
        Wq[ENE] = acc[2][i][jj];
        *sp = zs_point_t(Wq, ub, theta1, eps_p);
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += TNT) {
    T theta2 = T(INFINITY);
    for (int q = 0; q < QP; ++q) theta2 = nmin(theta2, scr[q * n + j]);
    tps[6 * n + j] = theta2;
  }
  __syncthreads();
}

// The scaling of the n cells in place by their factors in tps
// (tile_thetas), a thread per (component, cell) over the cell's modes:
// MODAL, mode 0 about the mean and the other modes toward 0 (modal_pos);
// else every DoF about the mean (the nodal chain).  Ends with a barrier.
template <bool MODAL, typename T, class SIdx>
__device__ __forceinline__ void tile_scale(T* Us, int K, int SS, int n,
                                           SIdx sidx, const T* tps) {
  const FDiv dn(n);
  for (int i = threadIdx.x; i < 4 * n; i += TNT) {
    const int c = dn.q(i), j = i - c * n;
    T* u = Us + c * K * SS + sidx(j);
    const T ubc = tps[i];
    const T theta1 = tps[5 * n + j], theta2 = tps[6 * n + j];
    for (int k = 0; k < K; ++k) {
      T v = u[k * SS];
      if constexpr (MODAL) {
        if (c == RHO)
          v = k == 0 ? v * theta1 + ubc * (T(1) - theta1) : v * theta1;
        v = k == 0 ? v * theta2 + ubc * (T(1) - theta2) : v * theta2;
      } else {
        if (c == RHO) v = v * theta1 + ubc * (T(1) - theta1);
        v = v * theta2 + ubc * (T(1) - theta2);
      }
      u[k * SS] = v;
    }
  }
  __syncthreads();
}

// The diag partials of one tile: NaN-propagating max of lam and min of mq
// over the block's threads (the identities -inf and +inf where a thread
// holds no cell), written by thread 0 to slot blockIdx.x (the tile), so
// the partials number the tiles (ops/kernels.tile_count)
template <typename T>
__device__ __forceinline__ void tile_diag(T lam, T mq, T* __restrict__ lam_part,
                                          T* __restrict__ minq_part) {
  constexpr int NW = TNT / 32;
  __shared__ T s_lam[NW];
  __shared__ T s_mq[NW];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lam = nmax(lam, __shfl_down_sync(0xffffffffu, lam, off));
    mq = nmin(mq, __shfl_down_sync(0xffffffffu, mq, off));
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    s_lam[tid >> 5] = lam;
    s_mq[tid >> 5] = mq;
  }
  __syncthreads();
  if (tid == 0) {
    T l = s_lam[0], m = s_mq[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      l = nmax(l, s_lam[w]);
      m = nmin(m, s_mq[w]);
    }
    lam_part[blockIdx.x] = l;
    minq_part[blockIdx.x] = m;
  }
}

// Set a kernel's dynamic shared memory above the default 48 kB where the
// tile needs it, then launch one block per grid entry.  Returns
// cudaGetLastError().
template <class Kern, class... Args>
int launch_tile_kernel(Kern kern, int blocks, int bytes, cudaStream_t stream,
                       const Args&... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, TNT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dflo
