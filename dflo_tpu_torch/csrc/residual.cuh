// The DG residual of one cell, shared by fused_residual.cu (the dense
// residual, its SSP-stage and forward-Euler forms) and
// fused_mood_candidate.cu (the MOOD candidate on {truncated ->
// positivity-limited} states).
//
// Per cell: the volume flux at the Q quadrature points (collocated Qk and
// GLL: the DoFs are the point values; modal Pk, and a nodal basis off its
// nodes (over-integrated, nq != p + 1): W = V u first,
// pallas_kernels.py:450-459), the four face traces of the cell and of each
// face neighbor, one numerical flux per face (HLLC, Roe, Steger-Warming,
// KFVS, or LxF and KEP with the cell averages of both cells) and the
// volume and face lifts with minv/area folded into the lift rows.
//
// Every function takes the basis dims d (euler.cuh): BDims for degrees 1-3
// on their default quadrature, whose sizes are constants (the loops unroll
// and the per-cell arrays stay in registers), or GDims for degrees 4-6 and
// any nq != p + 1 up to K_MAX and NQ_MAX, whose sizes are read at run time:
// one general instantiation per dtype, kind of dims and flux (its source
// arm read at run time too), its per-cell arrays in local memory, and the
// same operations in the same order.  Neighbors wrap periodically, as on the TPU;
// the caller's delta strips (true boundary flux minus wrap flux,
// solver/spatial.strips) are added at global column 0 / nx-1 and row
// 0 / ny-1.  On a masked domain (a uint8 fluid-flag plane) a fluid|solid
// face, the wrap faces included, takes the slip-wall mirror of the fluid
// side's trace and average (pallas_kernels.py:472-533; on the modal basis
// the cell's own trace and average come from its register-held DoFs, a
// neighbor's from the loads of its trace), and a solid cell's residual is
// zeroed (:598-599), so a solid cell's u + dt*R is its u.  Each cell
// recomputes the shared face flux from the same operands in the same order
// as its neighbor ("canonical recompute", pallas_kernels.py:184-193), so no
// face buffer goes through memory.
//
// Source arms (template argument SRC, pallas_kernels.py:573-593), added
// after the lifts and before the mask: a body force S(W) at the Q volume
// quadrature points lifted through the baked src = minv . (wq2 V)^T [K, Q],
// one point column at a time in point order (FORCE_CONST: gravity with the
// constant g = (gx, gy); FORCE_PLANES: an external force f(x, y, t) whose
// planes fx, fy [Q, ny, nx] the caller evaluated at this call's t); or, on a
// collocated basis, the isothermal well-balanced gravity source (WB_ISO):
// RT from the cell average, E = exp(-phi/RT) on the nodal potential plane
// phi [K, ny, nx], its nodal derivatives Gxn E / dx and Gyn E / dy, and
// rho RT / E times them added node by node (src_gll/assemble_explicit.cc:
// 30-135).  A source adds nothing at a face, so the delta strips do not
// change.
//
// Every contraction is an ordered sum (one multiply and one add per term,
// in the order of ops/kernels.fused_residual_plain) and the .cu files are
// built with -fmad=false, so kernel and plain version round alike: the
// MOOD cascade re-applies positivity to the stage predictor, whose branch at
// the pressure floor rounding decides, so an ulp in a residual would change
// later stages.
#pragma once

#include <stdint.h>

#include "modal.cuh"

namespace dflo {

// the numerical flux of the residual (template argument FLUX)
enum { HLLC = 0, LXF = 1, ROE = 2, SW = 3, KFVS = 4, KEP = 5 };

// whether the flux reads the cell averages of the face's two cells (LxF's
// dissipation speed, KEP's dissipation matrix)
template <int FLUX>
__host__ __device__ constexpr bool reads_averages() {
  return FLUX == LXF || FLUX == KEP;
}

// the source arm of the residual (template argument SRC); SRC_ANY: the
// general dims' kernels, whose arm is read at run time (SrcArgs::kind)
enum { SRC_ANY = -1, SRC_NONE = 0, FORCE_CONST = 1, FORCE_PLANES = 2,
       WB_ISO = 3 };

// operator buffer layout (ops/kernels.residual_operators): faceV [4][NQ][K]
// first, then the lift [K][NL], V [Q][K] (MODAL dims only) and the cell
// average row [K]; after it, by source arm: the force arms' projection src
// [K][Q], or the isothermal arm's nodal derivative matrices Gxn, Gyn [K][K]
// and [1/dx, 1/dy]
template <class D>
struct ResOps {
  int LIFT, VOL, AVG, SRCOP, GXN, GYN, INVD;
  __device__ __forceinline__ explicit ResOps(const D& d)
      : LIFT(4 * d.NQ * d.K),
        VOL(LIFT + d.K * d.NL),
        AVG(VOL + (D::MODAL ? d.Q * d.K : 0)),
        SRCOP(AVG + d.K),
        GXN(AVG + d.K),
        GYN(GXN + d.K * d.K),
        INVD(GYN + d.K * d.K) {}
};

// the per-call operands of the source arms (unused members stay null / 0)
template <typename T>
struct SrcArgs {
  const T* fx = nullptr;   // [Q, ny, nx] force planes (FORCE_PLANES)
  const T* fy = nullptr;
  const T* phi = nullptr;  // [K, ny, nx] nodal potential (WB_ISO)
  T gx = T(0);             // constant gravity (FORCE_CONST)
  T gy = T(0);
  int kind = SRC_NONE;     // the arm (read by the SRC_ANY kernels only)
};

// the state at volume quadrature point n: the streamed nodal values
// (collocated: the nodes are the quadrature points), or V[n] . w of the
// register-held DoFs (MODAL), each an ordered sum over k
template <typename T, class D>
__device__ __forceinline__ void point_state(const D& d,
                                            const T* __restrict__ u,
                                            long plane, long cell,
                                            const T* __restrict__ V,
                                            const T w[4][D::KMAX], int n,
                                            T wq[4]) {
  const int K = d.K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (D::MODAL) {
      T acc = V[n * K] * w[c][0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + V[n * K + k] * w[c][k];
      wq[c] = acc;
    } else {
      wq[c] = __ldg(u + (long)(c * K + n) * plane + cell);
    }
  }
}

// face trace (NQ points) of one cell streamed from memory, for face f; with
// AVG also its cell average ub[c] = sum_k avg[k] u[c][k] (an ordered sum, as
// contract.basis_reduce), from the same loads
template <typename T, class D, bool AVG = false>
__device__ __forceinline__ void trace_mem(const D& d, const T* __restrict__ u,
                                          const T* __restrict__ faceVf,
                                          long plane, long cell,
                                          T tr[4][D::NQMAX],
                                          const T* __restrict__ avg = nullptr,
                                          T* ub = nullptr) {
  const int K = d.K, NQ = d.NQ;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T acc[D::NQMAX];
    T v = __ldg(u + (long)(c * K) * plane + cell);
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = faceVf[q * K] * v;
    T a = T(0);
    if constexpr (AVG) a = avg[0] * v;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      v = __ldg(u + (long)(c * K + k) * plane + cell);
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = acc[q] + faceVf[q * K + k] * v;
      if constexpr (AVG) a = a + avg[k] * v;
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) tr[c][q] = acc[q];
    if constexpr (AVG) ub[c] = a;
  }
}

// the cell average ub[c] = sum_k avg[k] w[c][k] of register-held DoFs (an
// ordered sum, as contract.basis_reduce and trace_mem)
template <typename T, class D>
__device__ __forceinline__ void avg_reg(const D& d, const T w[4][D::KMAX],
                                        const T* __restrict__ avg, T ub[4]) {
  const int K = d.K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T a = avg[0] * w[c][0];
#pragma unroll
    for (int k = 1; k < K; ++k) a = a + avg[k] * w[c][k];
    ub[c] = a;
  }
}

// face trace of register-held DoFs w[4][K] (the same operations)
template <typename T, class D>
__device__ __forceinline__ void trace_reg(const D& d, const T w[4][D::KMAX],
                                          const T* __restrict__ faceVf,
                                          T tr[4][D::NQMAX]) {
  const int K = d.K, NQ = d.NQ;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T acc[D::NQMAX];
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

// the numerical flux at the nq points of one face, FL/FR the left/right
// traces along the +x (nx=1) or +y (ny=1) normal, AL/AR the left/right cell
// averages (read by LxF and KEP only); F[c][q]
template <typename T, class D, int FLUX>
__device__ __forceinline__ void face_flux(const D& d, const T FL[4][D::NQMAX],
                                          const T FR[4][D::NQMAX],
                                          const T AL[4], const T AR[4], T nx,
                                          T ny, T F[4][D::NQMAX]) {
  const int NQ = d.NQ;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const T l[4] = {FL[0][q], FL[1][q], FL[2][q], FL[3][q]};
    const T r[4] = {FR[0][q], FR[1][q], FR[2][q], FR[3][q]};
    T f[4];
    if constexpr (FLUX == LXF) lxf(l, r, AL, AR, nx, ny, f);
    else if constexpr (FLUX == KEP) kep(l, r, AL, AR, nx, ny, f);
    else if constexpr (FLUX == ROE) roe(l, r, nx, ny, f);
    else if constexpr (FLUX == SW) steger_warming(l, r, nx, ny, f);
    else if constexpr (FLUX == KFVS) kfvs(l, r, nx, ny, f);
    else hllc(l, r, nx, ny, f);
#pragma unroll
    for (int c = 0; c < 4; ++c) F[c][q] = f[c];
  }
}

// Slip-wall mirror operands at a fluid|solid face (physics/euler.wall_fix):
// left solid, right fluid -> the left trace and average become the right
// ones with the normal momentum (component MX for an x face, MY for a y
// face) negated; left fluid, right solid -> the other way round.
template <typename T, class D>
__device__ __forceinline__ void wall_fix(const D& d, T FL[4][D::NQMAX],
                                         T FR[4][D::NQMAX], T AL[4], T AR[4],
                                         bool mL, bool mR, int nc) {
  const int NQ = d.NQ;
  if (!mL && mR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) FL[c][q] = c == nc ? -FR[c][q] : FR[c][q];
      AL[c] = c == nc ? -AR[c] : AR[c];
    }
  } else if (mL && !mR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) FR[c][q] = c == nc ? -FL[c][q] : FL[c][q];
      AR[c] = c == nc ? -AL[c] : AL[c];
    }
  }
}

// R[c][k] += lift[k][col0 + q] * F[c][q]
template <typename T, class D>
__device__ __forceinline__ void lift_face(const D& d,
                                          const T* __restrict__ lift, int col0,
                                          const T F[4][D::NQMAX],
                                          T R[4][D::KMAX]) {
  const int K = d.K, NQ = d.NQ, NL = d.NL;
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
template <typename T, class D>
__device__ __forceinline__ void lift_volume(const D& d,
                                            const T* __restrict__ lift, int n,
                                            const T wq[4], T R[4][D::KMAX]) {
  const int K = d.K, Q = d.Q, NL = d.NL;
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

// A face neighbor's trace on face f (with AVG also its cell average):
// streamed, or (TP) from its DoFs after truncation to its own degree and
// positivity, the average then of those DoFs (the plain candidate averages
// the tp'd state, pallas_kernels.py:340, :368, :380).  TP takes the modal
// dims: BDims<P, true>, or GDims<true> with its degree d.P and its d.QP
// positivity points.
template <typename T, class D, bool TP, bool AVG>
__device__ __forceinline__ void neighbor_trace(
    const D& d, const T* __restrict__ u, const int* __restrict__ deg,
    const T* __restrict__ Pm, T avg0, const T* __restrict__ faceVf,
    long plane, long ncell, T tr[4][D::NQMAX], const T* __restrict__ avg,
    T ub[4]) {
  if constexpr (TP) {
    T v[4][D::KMAX];
    load_cell<T>(d, u, plane, ncell, v);
    modal_tp<T>(d, v, __ldg(deg + ncell), Pm, avg0);
    trace_reg<T>(d, v, faceVf, tr);
    if constexpr (AVG) avg_reg<T>(d, v, avg, ub);
  } else {
    trace_mem<T, D, AVG>(d, u, faceVf, plane, ncell, tr, avg, ub);
  }
}

// R += src[:, n] S(W(n)) point by point (ops/kernels._source_plain): the
// body force at the Q quadrature points, gravity with the constant g
// (CONST) or an external force from the caller's planes fx, fy
template <typename T, class D, bool CONST>
__device__ __forceinline__ void add_body_force(
    const D& d, const T* __restrict__ u, long plane, long cell,
    const T* __restrict__ V, const T w[4][D::KMAX],
    const T* __restrict__ sop, const SrcArgs<T>& src, T R[4][D::KMAX]) {
  const int K = d.K, Q = d.Q;
#pragma unroll
  for (int n = 0; n < Q; ++n) {
    T wq[4], s[4];
    point_state<T>(d, u, plane, cell, V, w, n, wq);
    if constexpr (CONST) {
      // physics/euler.forcing_gravity
      s[MX] = src.gx * wq[RHO];
      s[MY] = src.gy * wq[RHO];
      s[RHO] = T(0);
      s[ENE] = src.gx * wq[MX] + src.gy * wq[MY];
    } else {
      // physics/euler.forcing_external
      const T fx = __ldg(src.fx + (long)n * plane + cell);
      const T fy = __ldg(src.fy + (long)n * plane + cell);
      s[MX] = wq[RHO] * fx;
      s[MY] = wq[RHO] * fy;
      s[RHO] = T(0);
      s[ENE] = wq[MX] * fx + wq[MY] * fy;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T l = sop[k * Q + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) R[c][k] = R[c][k] + l * s[c];
    }
  }
}

// isothermal well-balanced gravity on the nodes of a collocated basis
// (pallas_kernels.py:578-593): RT of the cell average ub, E = exp(-phi/RT),
// the nodal derivatives of E times the baked 1/dx, 1/dy, then
// S = rho RT / E grad E added node by node
template <typename T, class D>
__device__ __forceinline__ void add_wb_iso(
    const D& d, const T* __restrict__ u, long plane, long cell,
    const T* __restrict__ V, const T w[4][D::KMAX],
    const T* __restrict__ ops, const ResOps<D>& O, const T ub[4],
    const SrcArgs<T>& src, T R[4][D::KMAX]) {
  const int K = d.K;
  const T* gxn = ops + O.GXN;
  const T* gyn = ops + O.GYN;
  const T inv_dx = ops[O.INVD], inv_dy = ops[O.INVD + 1];
  const T rt = pressure(ub) / ub[RHO];
  T E[D::KMAX];
#pragma unroll
  for (int k = 0; k < K; ++k)
    E[k] = ieee_exp(-__ldg(src.phi + (long)k * plane + cell) / rt);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T dex = gxn[k * K] * E[0], dey = gyn[k * K] * E[0];
#pragma unroll
    for (int j = 1; j < K; ++j) {
      dex = dex + gxn[k * K + j] * E[j];
      dey = dey + gyn[k * K + j] * E[j];
    }
    dex = dex * inv_dx;
    dey = dey * inv_dy;
    T wk[4];
    point_state<T>(d, u, plane, cell, V, w, k, wk);
    const T fac = wk[RHO] * rt / E[k];
    const T sx = fac * dex, sy = fac * dey;
    R[MX][k] = R[MX][k] + sx;
    R[MY][k] = R[MY][k] + sy;
    R[RHO][k] = R[RHO][k] + T(0);
    R[ENE][k] = R[ENE][k] + (wk[MX] * sx + wk[MY] * sy) / wk[RHO];
  }
}

// The residual R = M^{-1} R(u) of cell (x, y), in R[4][K], on the basis
// dims d (BDims or GDims).  REG: the cell's DoFs are held in w[4][K]
// (always on MODAL dims, which contract them with V; with TP they are
// {truncated -> positivity-limited} first, and so is every neighbor before
// its trace); otherwise (a collocated basis) they are streamed from memory
// and w is not written.  FLUX: HLLC, ROE, SW, KFVS, or LXF and KEP, which
// also read the cell averages of the cell and of each face neighbor (of
// the register-held DoFs where they are held, so with TP the averages of
// the tp'd states).  mask: the uint8 fluid flags of a masked domain, or
// nullptr.
template <typename T, class D, bool TP, int FLUX = HLLC, int SRC = SRC_NONE>
__device__ __forceinline__ void cell_residual(
    const D& d, const T* __restrict__ u, const int* __restrict__ deg,
    const T* __restrict__ Pm, T avg0, const T* __restrict__ dfw,
    const T* __restrict__ dfe, const T* __restrict__ dfs,
    const T* __restrict__ dfn, const T* __restrict__ ops, int x, int y,
    int ny, int nx, T R[4][D::KMAX], T w[4][D::KMAX],
    const uint8_t* __restrict__ mask = nullptr,
    const SrcArgs<T>& src = SrcArgs<T>()) {
  static_assert(D::MODAL || !TP, "truncation needs the modal basis");
  static_assert(SRC == SRC_NONE || !TP, "the candidate takes no source");
  static_assert(SRC != WB_ISO || !D::MODAL,
                "well-balanced gravity needs a collocated basis");
  const int K = d.K, NQ = d.NQ, Q = d.Q;
  constexpr int NA = D::NQMAX;
  constexpr bool REG = D::MODAL || TP;
  constexpr bool AVG = reads_averages<FLUX>();
  const ResOps<D> O(d);
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  const int xw = x == 0 ? nx - 1 : x - 1;
  const int xe = x == nx - 1 ? 0 : x + 1;
  const int ys = y == 0 ? ny - 1 : y - 1;
  const int yn = y == ny - 1 ? 0 : y + 1;
  const T* faceV = ops;
  const T* lift = ops + O.LIFT;
  const T* avg = ops + O.AVG;
  const bool masked = mask != nullptr;
  const bool m_own = masked ? __ldg(mask + cell) != 0 : true;

#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) R[c][k] = T(0);

  // ---- volume term --------------------------------------------------------
  if constexpr (REG) {
    if constexpr (TP) {
      load_cell<T>(d, u, plane, cell, w);
      modal_tp<T>(d, w, __ldg(deg + cell), Pm, avg0);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[c][k] = __ldg(u + (long)(c * K + k) * plane + cell);
    }
  }
  const T* V = ops + O.VOL;
#pragma unroll
  for (int n = 0; n < Q; ++n) {
    T wq[4];
    point_state<T>(d, u, plane, cell, V, w, n, wq);
    lift_volume<T>(d, lift, n, wq, R);
  }

  // the cell's own average (LxF, KEP; the isothermal source's RT)
  T ub[4] = {T(0), T(0), T(0), T(0)};
  if constexpr (AVG && REG) {
    avg_reg<T>(d, w, avg, ub);
  } else if constexpr (AVG || SRC == WB_ISO || SRC == SRC_ANY) {
    if (AVG || SRC != SRC_ANY || src.kind == WB_ISO) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T a = avg[0] * __ldg(u + (long)(c * K) * plane + cell);
#pragma unroll
        for (int k = 1; k < K; ++k)
          a = a + avg[k] * __ldg(u + (long)(c * K + k) * plane + cell);
        ub[c] = a;
      }
    }
  }

  T own[4][NA], nb[4][NA], F[4][NA], a_own[4], a_nb[4];
  // One face: the cell's trace on face f_own, the neighbor ncell's trace on
  // the facing face f_nb; left = the neighbor on the W and S faces.  nc is
  // the normal momentum component a wall mirror negates; strip/stride/sidx
  // address the delta strip added where `edge` holds; col0 is the face's
  // first lift column.
  auto face = [&](int f_own, int f_nb, long ncell, bool nb_left, T nxv, T nyv,
                  int nc, bool edge, const T* __restrict__ strip, int stride,
                  int sidx, int col0) {
    if constexpr (REG) trace_reg<T>(d, w, faceV + f_own * NQ * K, own);
    else trace_mem<T, D>(d, u, faceV + f_own * NQ * K, plane, cell, own);
    neighbor_trace<T, D, TP, AVG>(d, u, deg, Pm, avg0,
                                  faceV + f_nb * NQ * K, plane, ncell, nb,
                                  avg, a_nb);
#pragma unroll
    for (int c = 0; c < 4; ++c) a_own[c] = ub[c];
    const bool m_nb = masked ? __ldg(mask + ncell) != 0 : true;
    if (nb_left) {
      if (masked) wall_fix<T>(d, nb, own, a_nb, a_own, m_nb, m_own, nc);
      face_flux<T, D, FLUX>(d, nb, own, a_nb, a_own, nxv, nyv, F);
    } else {
      if (masked) wall_fix<T>(d, own, nb, a_own, a_nb, m_own, m_nb, nc);
      face_flux<T, D, FLUX>(d, own, nb, a_own, a_nb, nxv, nyv, F);
    }
    if (edge)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < NQ; ++q) F[c][q] += strip[(c * NQ + q) * stride + sidx];
    lift_face<T>(d, lift, col0, F, R);
  };
  // west: left = west neighbor's east trace; east: right = east neighbor's
  // west trace; south / north likewise along y
  face(0, 1, (long)y * nx + xw, true, T(1), T(0), MX, x == 0, dfw, ny, y,
       2 * Q + 0 * NQ);
  face(1, 0, (long)y * nx + xe, false, T(1), T(0), MX, x == nx - 1, dfe, ny,
       y, 2 * Q + 1 * NQ);
  face(2, 3, (long)ys * nx + x, true, T(0), T(1), MY, y == 0, dfs, nx, x,
       2 * Q + 2 * NQ);
  face(3, 2, (long)yn * nx + x, false, T(0), T(1), MY, y == ny - 1, dfn, nx,
       x, 2 * Q + 3 * NQ);

  // ---- source arms, after the lifts --------------------------------------
  if constexpr (SRC == FORCE_CONST || SRC == FORCE_PLANES) {
    add_body_force<T, D, SRC == FORCE_CONST>(d, u, plane, cell, V, w,
                                             ops + O.SRCOP, src, R);
  } else if constexpr (SRC == WB_ISO) {
    add_wb_iso<T>(d, u, plane, cell, V, w, ops, O, ub, src, R);
  } else if constexpr (SRC == SRC_ANY) {
    // the general dims: the arm read at run time
    if (src.kind == FORCE_CONST) {
      add_body_force<T, D, true>(d, u, plane, cell, V, w, ops + O.SRCOP, src,
                                 R);
    } else if (src.kind == FORCE_PLANES) {
      add_body_force<T, D, false>(d, u, plane, cell, V, w, ops + O.SRCOP,
                                  src, R);
    } else if constexpr (!D::MODAL) {
      if (src.kind == WB_ISO)
        add_wb_iso<T>(d, u, plane, cell, V, w, ops, O, ub, src, R);
    }
  }

  if (masked) {
    // solid cells are frozen (R * mask, as the plain version multiplies)
    const T m = m_own ? T(1) : T(0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) R[c][k] = R[c][k] * m;
  }
}

// The dense fused residual of one cell per thread: R, the SSP stage
// a*u_old + (1-a)*(u + dt*R) with [a, dt] read from a device pointer so the
// host never waits on dt, or the forward-Euler update u + dt*R (sc = [dt]);
// SRC adds a source arm with its operands in src.
template <typename T, class D, int FLUX, int SRC = SRC_NONE>
__global__ void __launch_bounds__(BX * BY)
fused_residual_kernel(const T* __restrict__ u, const T* __restrict__ dfw,
                      const T* __restrict__ dfe, const T* __restrict__ dfs,
                      const T* __restrict__ dfn, const T* __restrict__ uold,
                      const T* __restrict__ sc, const T* __restrict__ ops,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      int ny, int nx, SrcArgs<T> src, D d) {
  const int K = d.K;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;

  T R[4][D::KMAX], w[4][D::KMAX];
  cell_residual<T, D, false, FLUX, SRC>(d, u, nullptr, nullptr, T(0), dfw,
                                        dfe, dfs, dfn, ops, x, y, ny, nx, R,
                                        w, mask, src);

  // ---- write R, the SSP stage, or the forward-Euler update ---------------
  if (uold != nullptr) {
    const T a = sc[0], dt = sc[1];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long i = (long)(c * K + k) * plane + cell;
        out[i] = a * __ldg(uold + i) + (T(1) - a) * (__ldg(u + i) + dt * R[c][k]);
      }
  } else if (sc != nullptr) {
    const T dt = sc[0];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long i = (long)(c * K + k) * plane + cell;
        out[i] = __ldg(u + i) + dt * R[c][k];
      }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = R[c][k];
  }
}

// The operands of one residual launch (the C entry points' pointers, as
// void*; fx, fy, phi, gx, gy only for a source arm).
struct ResArgs {
  const void *u, *dfw, *dfe, *dfs, *dfn, *uold, *sc, *ops, *mask;
  const void *fx, *fy, *phi;
  double gx, gy;
  void* out;
  int ny, nx;
};

template <typename T, int FLUX, int SRC, class D>
int launch_residual(const D& d, const ResArgs& a, cudaStream_t stream,
                    int kind = SRC) {
  SrcArgs<T> src;
  src.kind = kind;
  src.fx = (const T*)a.fx;
  src.fy = (const T*)a.fy;
  src.phi = (const T*)a.phi;
  src.gx = T(a.gx);
  src.gy = T(a.gy);
  fused_residual_kernel<T, D, FLUX, SRC>
      <<<grid_for(a.ny, a.nx), dim3(BX, BY), 0, stream>>>(
          (const T*)a.u, (const T*)a.dfw, (const T*)a.dfe, (const T*)a.dfs,
          (const T*)a.dfn, (const T*)a.uold, (const T*)a.sc,
          (const T*)a.ops, (const uint8_t*)a.mask, (T*)a.out, a.ny, a.nx,
          src, d);
  return (int)cudaGetLastError();
}

// The general dims of one flux, every source arm read at run time (src, as
// SRC): degrees 4-6 and any nq != p + 1, within K_MAX and NQ_MAX.  Defined
// here and instantiated once per flux, in fused_residual<_flux>.cu (the
// extern declarations below keep the arms' sources from compiling it
// again): one kernel per dtype and kind of dims for all of a flux's arms.
template <int FLUX>
int launch_general(int dtype, int modal, int K, int nq, int src,
                   const ResArgs& a, cudaStream_t s) {
  if (K < 1 || K > K_MAX || nq < 1 || nq > NQ_MAX) return -1;
  if (!modal && K != nq * nq) return -1;   // collocated: the nodes are the points
  if (src == WB_ISO && modal) return -1;
#define DFLO_RUN(T, M)                                                      \
  return launch_residual<T, FLUX, SRC_ANY>(general_dims<M>(K, nq), a, s, src)
  if (dtype == 0) {
    if (modal) DFLO_RUN(float, true);
    DFLO_RUN(float, false);
  }
  if (modal) DFLO_RUN(double, true);
  DFLO_RUN(double, false);
#undef DFLO_RUN
}

#define DFLO_GENERAL(FLUX)                                                  \
  int launch_general<FLUX>(int, int, int, int, int, const ResArgs&,         \
                           cudaStream_t)
extern template DFLO_GENERAL(HLLC);
extern template DFLO_GENERAL(LXF);
extern template DFLO_GENERAL(ROE);
extern template DFLO_GENERAL(SW);
extern template DFLO_GENERAL(KFVS);
extern template DFLO_GENERAL(KEP);

// The launch table of one flux and source arm over dtype (0 = float32,
// 1 = float64), the basis dims and the degree: modal = 1 where the kernel
// contracts the DoFs with V (the modal Pk basis, or a nodal basis off its
// nodes), K DoFs and nq quadrature points per direction.  Degrees 1-3 on
// their default quadrature (nq = p + 1) take their own instantiations
// (BDims); every other basis within K_MAX and NQ_MAX the flux's general
// kernels (launch_general).  -1 for a case it does not take (a source
// arm's operands missing, WB_ISO on a MODAL basis, u_old without sc, a
// basis beyond the bounds).  Each source arm's table is instantiated in a
// translation unit of its own (fused_residual_src*.cu, _planes*.cu,
// _wb*.cu), so nvcc builds them side by side.
template <int FLUX, int SRC>
int launch_table(int dtype, int modal, int p, int K, int nq,
                 const ResArgs& a, cudaStream_t s) {
  if (a.uold != nullptr && a.sc == nullptr) return -1;
  if (SRC == FORCE_PLANES && (a.fx == nullptr || a.fy == nullptr)) return -1;
  if (SRC == WB_ISO && (a.phi == nullptr || modal)) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const bool fixed = p >= 1 && p <= 3 && nq == p + 1 &&
                     K == (modal ? (p + 1) * (p + 2) / 2 : (p + 1) * (p + 1));
  if (!fixed) return launch_general<FLUX>(dtype, modal, K, nq, SRC, a, s);
#define DFLO_RUN(T, D) return launch_residual<T, FLUX, SRC>(D, a, s)
#define DFLO_DEGREES(T, M)                                                  \
  if (p == 1) DFLO_RUN(T, (BDims<1, M>{}));                                 \
  if (p == 2) DFLO_RUN(T, (BDims<2, M>{}));                                 \
  if (p == 3) DFLO_RUN(T, (BDims<3, M>{}));
  if constexpr (SRC == WB_ISO) {
    if (dtype == 0) { DFLO_DEGREES(float, false) }
    if (dtype == 1) { DFLO_DEGREES(double, false) }
  } else {
    if (dtype == 0) {
      if (modal) { DFLO_DEGREES(float, true) } else { DFLO_DEGREES(float, false) }
    } else {
      if (modal) { DFLO_DEGREES(double, true) } else { DFLO_DEGREES(double, false) }
    }
  }
#undef DFLO_DEGREES
#undef DFLO_RUN
  return -1;
}

}  // namespace dflo
