// Fused stabilization chain of one RK stage, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_post (the single-chip
// kernel, with and without its diag outputs), masked or not, and the
// per-device kernel of make_fused_post_sharded (pallas_kernels.py:1536-1652,
// the block form below).  Per cell, in
// this order: its cell average and its four neighbors' averages; the KXRCF
// jump of the indicator variable across its faces (pallas_kernels.py:
// 1290-1323), or with the `limiter` indicator every cell marked
// (:1158-1160); the characteristic TVB limiter with minmod, Mdx2 and the
// change > 1e-10 gate (:1325-1365); Zhang-Shu positivity with the
// dtype-aware floors (:1367-1425); with diag, the CFL wave speed and
// min(rho, p) of the cell average (the chain preserves cell means), reduced
// per block with NaN-propagating max/min into partials that the wrapper
// reduces with torch.amax/amin (:1527).  Neighbor-exists flags come from
// edge arithmetic (:1277-1288): a cell off the block's border always has its
// neighbor, a border cell has one where the argument nb_w / nb_e / nb_s /
// nb_n says so (the periodic flags on one device; under a device mesh, 0
// only at a true, non-periodic domain edge, the runtime edge flags of
// :1599-1609); on a masked domain the static flag plane vflags [5, ny, nx]
// (uint8: the W, E, S, N fluid-neighbor flags and the cell's own fluid
// flag, :1135-1151) gives them instead; a solid cell enters neither diag
// reduction (:1442-1447).
//
// The block form (one block of a domain split over a device mesh): the
// neighbor DoF lines across the block's four borders come in as halo lines
// hW, hE [4, K, ny] and hS, hN [4, K, nx] (the neighbor blocks' edge
// columns and rows).  A border cell reads its neighbor's DoFs from the halo
// line where the wrapped index would leave the block, so it computes the
// same neighbor average and trace from the same numbers in the same order
// as on one device, and the sharded post equals the single-device post
// bitwise.  The TPU kernel exchanges packs of traces and averages instead
// (equal to f32 reassociation round-off); raw DoF lines cost a few more
// bytes (4K values per border cell) and keep the arithmetic one path.  A
// null halo pointer keeps the block wrap (one device, or a true domain
// edge, where the edge flag switches the neighbor off).
//
// What bounds it on the H100: bytes.  Each cell reads its own 4K values and
// each neighbor's 4K values (for the neighbor's average and facing trace),
// roughly 5x the state through L1/L2, and writes 4K values.  The per-cell
// arithmetic (two 4x4 eigen systems, 18 positivity points at p = 2) is
// modest.  The simple design relies on the 32 x 4 block for L1 reuse of the
// neighbor rows; a later version stages a shared-memory tile with a one-cell
// halo so each cell's average and traces are computed once per block.
// Degrees 1-3 have an instantiation each (every size a constant, the
// loops unrolled); degrees 4-6 share one general instantiation per dtype
// (euler.cuh GDims: the sizes read at run time, the per-cell arrays sized
// for Q6 and held in local memory), which keeps the build short at the
// cost of local-memory traffic.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

struct PostParams {
  int nb_w, nb_e, nb_s, nb_n, comp, mark_all, char_lim, pos_lim;
  double dx, dy, h, hdx, hdy, inv_h, diam_pow, Mdx2, beta;
};

// operator buffer layout (ops/kernels.post_operators), all [.][K] rows:
// faceV [4][NQ][K] face traces first, then the offsets below
template <class D>
struct PostOps {
  int WQ, AVG, GX, GY, DRX, DRY, PM;
  __device__ __forceinline__ explicit PostOps(const D& d)
      : WQ(4 * d.NQ * d.K),   // [NQ] face weights
        AVG(WQ + d.NQ),       // [K] cell average
        GX(AVG + d.K),        // [K] mean d/dx
        GY(GX + d.K),         // [K] mean d/dy
        DRX(GY + d.K),        // [K] node x - centre
        DRY(DRX + d.K),       // [K] node y - centre
        PM(DRY + d.K) {}      // [QP][K] positivity points
};

// sum_k op[k] * v[k] for k < n, one multiply and one add per term in k
// order (dot_seq with the length of the dims)
template <typename T>
__device__ __forceinline__ T dot_len(const T* __restrict__ op, const T* v,
                                     int n) {
  T acc = op[0] * v[0];
#pragma unroll
  for (int k = 1; k < n; ++k) acc = acc + op[k] * v[k];
  return acc;
}

// load one cell's component c
template <typename T, class D>
__device__ __forceinline__ void load_comp(const D& d, const T* __restrict__ u,
                                          int c, long plane, long cell,
                                          T v[D::KMAX]) {
  const int K = d.K;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __ldg(u + (long)(c * K + k) * plane + cell);
}

// a neighbor's cell average and its trace of component comp on face f; u is
// the state (plane = ny * nx, cell its index) or a halo line (plane = its
// length, cell the index along it)
template <typename T, class D>
__device__ __forceinline__ void avg_and_trace(const D& d,
                                              const T* __restrict__ u,
                                              const T* __restrict__ ops, int f,
                                              int comp, long plane, long cell,
                                              T ub[4], T tr[D::NQMAX]) {
  const int K = d.K, NQ = d.NQ;
  const PostOps<D> O(d);
  T v[D::KMAX];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    load_comp<T>(d, u, c, plane, cell, v);
    ub[c] = dot_len<T>(ops + O.AVG, v, K);
  }
  load_comp<T>(d, u, comp, plane, cell, v);
#pragma unroll
  for (int q = 0; q < NQ; ++q) tr[q] = dot_len<T>(ops + (f * NQ + q) * K, v, K);
}

// face integral of the indicator jump: sum_q wq[q] * (t[q] - tn[q]) * valid
template <typename T, class D>
__device__ __forceinline__ T face_jump(const D& d, const T* __restrict__ wq,
                                       const T t[D::NQMAX],
                                       const T tn[D::NQMAX], T valid) {
  const int NQ = d.NQ;
  T j[D::NQMAX];
#pragma unroll
  for (int q = 0; q < NQ; ++q) j[q] = (t[q] - tn[q]) * valid;
  return dot_len<T>(wq, j, NQ);
}

// The chain follows stab/indicator, stab/limiter and stab/positivity
// operation by operation.  Every quantity that feeds a threshold decision
// (KXRCF > 1, change > 1e-10) is computed with the IEEE operations of the
// torch version in the same order (ordered sums, no contraction: every
// source is built with -fmad=false), so in float32 the kernel and the plain
// version take the same limiter decisions.
template <typename T, class D>
__global__ void __launch_bounds__(BX * BY)
fused_post_kernel(const T* __restrict__ u, const T* __restrict__ ops,
                  const uint8_t* __restrict__ vflags,
                  const T* __restrict__ hW, const T* __restrict__ hE,
                  const T* __restrict__ hS, const T* __restrict__ hN,
                  T* __restrict__ out, T* __restrict__ lam_part,
                  T* __restrict__ minq_part, int ny, int nx, PostParams prm,
                  D d) {
  const int K = d.K, NQ = d.NQ;
  constexpr int KA = D::KMAX, NA = D::NQMAX;
  const PostOps<D> O(d);
  const T* faceV = ops;
  const T* wq = ops + O.WQ;
  const T* avg = ops + O.AVG;
  const T* Pm = ops + O.PM;

  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const bool inside = x < nx && y < ny;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions

  if (inside) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    const int xw = x == 0 ? nx - 1 : x - 1;
    const int xe = x == nx - 1 ? 0 : x + 1;
    const int ys = y == 0 ? ny - 1 : y - 1;
    const int yn = y == ny - 1 ? 0 : y + 1;
    bool vW = prm.nb_w || x > 0, vE = prm.nb_e || x < nx - 1;
    bool vS = prm.nb_s || y > 0, vN = prm.nb_n || y < ny - 1;
    bool fluid = true;
    if (vflags != nullptr) {
      vW = __ldg(vflags + cell) != 0;
      vE = __ldg(vflags + plane + cell) != 0;
      vS = __ldg(vflags + 2 * plane + cell) != 0;
      vN = __ldg(vflags + 3 * plane + cell) != 0;
      fluid = __ldg(vflags + 4 * plane + cell) != 0;
    }
    const int comp = prm.comp;
    const T dx = T(prm.dx), dy = T(prm.dy), h = T(prm.h);

    // ---- neighbor averages and their facing indicator traces (from a halo
    // line where the neighbor lies across the block's border) -------------
    T ubW[4], ubE[4], ubS[4], ubN[4], tEw[NA], tWe[NA], tNs[NA], tSn[NA];
    if (x == 0 && hW != nullptr)
      avg_and_trace<T>(d, hW, ops, 1, comp, ny, y, ubW, tEw);
    else
      avg_and_trace<T>(d, u, ops, 1, comp, plane, (long)y * nx + xw, ubW, tEw);
    if (x == nx - 1 && hE != nullptr)
      avg_and_trace<T>(d, hE, ops, 0, comp, ny, y, ubE, tWe);
    else
      avg_and_trace<T>(d, u, ops, 0, comp, plane, (long)y * nx + xe, ubE, tWe);
    if (y == 0 && hS != nullptr)
      avg_and_trace<T>(d, hS, ops, 3, comp, nx, x, ubS, tNs);
    else
      avg_and_trace<T>(d, u, ops, 3, comp, plane, (long)ys * nx + x, ubS, tNs);
    if (y == ny - 1 && hN != nullptr)
      avg_and_trace<T>(d, hN, ops, 2, comp, nx, x, ubN, tSn);
    else
      avg_and_trace<T>(d, u, ops, 2, comp, plane, (long)yn * nx + x, ubN, tSn);

    // ---- own state and average ------------------------------------------
    T w[4][KA], ub[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      load_comp<T>(d, u, c, plane, cell, w[c]);
      ub[c] = dot_len<T>(avg, w[c], K);
    }

    // ---- KXRCF shock indicator (src/indicator.cc:48-198), or every cell
    // marked (the `limiter` indicator, src/indicator.cc:19-22) -------------
    // the indicator variable's DoFs, selected without a runtime index into
    // the register array
    T wi[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) wi[k] = comp == ENE ? w[ENE][k] : w[RHO][k];
    const T ubi = comp == ENE ? ub[ENE] : ub[RHO];
    T tW[NA], tE[NA], tS[NA], tN[NA];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      tW[q] = dot_len<T>(faceV + (0 * NQ + q) * K, wi, K);
      tE[q] = dot_len<T>(faceV + (1 * NQ + q) * K, wi, K);
      tS[q] = dot_len<T>(faceV + (2 * NQ + q) * K, wi, K);
      tN[q] = dot_len<T>(faceV + (3 * NQ + q) * K, wi, K);
    }
    const T fW = face_jump<T>(d, wq, tW, tEw, T(vW));
    const T fE = face_jump<T>(d, wq, tE, tWe, T(vE));
    const T fS = face_jump<T>(d, wq, tS, tNs, T(vS));
    const T fN = face_jump<T>(d, wq, tN, tSn, T(vN));
    const T vx = ub[MX] / ub[RHO];
    const T vy = ub[MY] / ub[RHO];
    const T inW = T(-vx < T(0)) * T(vW);
    const T inE = T(vx < T(0)) * T(vE);
    const T inS = T(-vy < T(0)) * T(vS);
    const T inN = T(vy < T(0)) * T(vN);
    const T ind = (inW * fW + inE * fE) * dy + (inS * fS + inN * fN) * dx;
    const T measure = (inW + inE) * dy + (inS + inN) * dx;
    const T denom = T(prm.diam_pow) * measure * ubi;
    const bool marked =
        prm.mark_all ||
        (fabs(denom) > T(0) ? fabs(ind) / (denom == T(0) ? T(1) : denom)
                            : T(0)) > T(1);

    // ---- TVB limiter (src/limiter.cc:224-370) ----------------------------
    T Dx[4], Dy[4], dbx[4], dfx[4], dby[4], dfy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dx[c] = T(prm.hdx) * dot_len<T>(ops + O.GX, w[c], K);
      Dy[c] = T(prm.hdy) * dot_len<T>(ops + O.GY, w[c], K);
      dbx[c] = vW ? ub[c] - ubW[c] : Dx[c];
      dfx[c] = vE ? ubE[c] - ub[c] : Dx[c];
      dby[c] = vS ? ub[c] - ubS[c] : Dy[c];
      dfy[c] = vN ? ubN[c] - ub[c] : Dy[c];
    }
    T Dxn[4], Dyn[4];
    const T change = tvb_slopes(ub, Dx, Dy, dbx, dfx, dby, dfy,
                                prm.char_lim != 0, T(prm.beta), T(prm.Mdx2),
                                Dxn, Dyn);
    if (marked && change > T(1.0e-10)) {
      // nodal linear rebuild ub + drx (Dxn / h) + dry (Dyn / h)
      const T inv_h = T(prm.inv_h);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T sx = Dxn[c] * inv_h, sy = Dyn[c] * inv_h;
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[c][k] = ub[c] + ops[O.DRX + k] * sx + ops[O.DRY + k] * sy;
      }
    }

    // ---- Zhang-Shu positivity (src/positivity.cc:16-208) -----------------
    if (prm.pos_lim) {
      T theta1, theta2;
      zs_thetas<T>(d, w, ub, Pm, theta1, theta2);
#pragma unroll
      for (int k = 0; k < K; ++k)
        w[RHO][k] = w[RHO][k] * theta1 + ub[RHO] * (T(1) - theta1);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[c][k] = w[c][k] * theta2 + ub[c] * (T(1) - theta2);
    }

#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = w[c][k];

    if (lam_part != nullptr) {
      cell_diag(ub, T(1) / h, lam, mq);
      if (!fluid) {   // solid cells enter neither reduction
        lam = T(0);
        mq = T(INFINITY);
      }
    }
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, class D>
static int launch(const D& d, const void* u, const void* ops,
                  const void* vflags, const void* const h[4], void* out,
                  void* lam_part, void* minq_part, int ny, int nx,
                  const PostParams& prm, cudaStream_t stream) {
  fused_post_kernel<T, D><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)ops, (const uint8_t*)vflags, (const T*)h[0],
      (const T*)h[1], (const T*)h[2], (const T*)h[3], (T*)out,
      (T*)lam_part, (T*)minq_part, ny, nx, prm, d);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 (1-3 on their own
// instantiations, 4-6 on the general dims of one instantiation per dtype:
// its per-cell arrays sized for Q6 live in local memory).  vflags: uint8
// [5, ny, nx] flag plane of a masked domain, or NULL.  hW, hE ([4, K, ny])
// and hS, hN ([4, K, nx]): the block form's halo lines, each NULL for the
// block wrap (the single-device form passes four NULLs); not with vflags.
// nb_w, nb_e, nb_s, nb_n: 1 where the cells on that border have a neighbor
// across it.  lam_part/minq_part NULL for the form without diag, else
// dflo_num_blocks(ny, nx) entries each.  mark_all: the `limiter` indicator.
// Returns cudaGetLastError() after the launch, -1 for an unsupported case.
extern "C" int dflo_fused_post(int dtype, int p, const void* u, const void* ops,
                               const void* vflags, const void* hW,
                               const void* hE, const void* hS, const void* hN,
                               void* out, void* lam_part, void* minq_part,
                               int ny, int nx, int nb_w, int nb_e, int nb_s,
                               int nb_n, int comp, int mark_all, int char_lim,
                               int pos_lim, double dx, double dy, double h,
                               double hdx, double hdy, double inv_h,
                               double diam_pow, double Mdx2, double beta,
                               void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  const void* const halo[4] = {hW, hE, hS, hN};
  if (vflags != nullptr && (hW || hE || hS || hN)) return -1;
  const dflo::PostParams prm{nb_w,     nb_e,     nb_s,    nb_n, comp,
                             mark_all, char_lim, pos_lim, dx,   dy,
                             h,        hdx,      hdy,     inv_h, diam_pow,
                             Mdx2,     beta};
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, D)                                                     \
  return dflo::launch<T>(D, u, ops, vflags, halo, out, lam_part, minq_part, \
                         ny, nx, prm, s)
  if (dtype == 0) {
    if (p == 1) DFLO_CASE(float, dflo::Dims<1>{});
    if (p == 2) DFLO_CASE(float, dflo::Dims<2>{});
    if (p == 3) DFLO_CASE(float, dflo::Dims<3>{});
  } else if (dtype == 1) {
    if (p == 1) DFLO_CASE(double, dflo::Dims<1>{});
    if (p == 2) DFLO_CASE(double, dflo::Dims<2>{});
    if (p == 3) DFLO_CASE(double, dflo::Dims<3>{});
  }
  // degrees 4-6: the general dims of Q_p on its p + 1 Gauss points, with
  // the positivity points of stab/positivity._pos_points(p)
  if (p < 4 || p > 6) return -1;
  const int nq = p + 1, ng = (p + 3) % 2 == 0 ? (p + 3) / 2 : (p + 4) / 2;
  const auto g = dflo::general_dims<false>(nq * nq, nq, 2 * ng * nq);
  if (dtype == 0) DFLO_CASE(float, g);
  if (dtype == 1) DFLO_CASE(double, g);
#undef DFLO_CASE
  return -1;
}
