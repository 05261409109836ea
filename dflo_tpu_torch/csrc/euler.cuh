// Device functions shared by the kernels of the port: Euler pressure and
// fluxes, the branchless HLLC, local Lax-Friedrichs, Roe, Steger-Warming,
// KFVS (with the A&S erf) and KEP numerical fluxes, the
// slip-wall mirror of a masked domain, the characteristic eigen matrices and the
// TVB slope limiter, NaN-propagating min/max, the per-degree dimensions of
// the nodal Qk and modal Pk bases and the block reduction of the
// diagnostics.
//
// Every function follows its torch twin in dflo_tpu_torch/physics and
// dflo_tpu_torch/stab operation by operation, so kernel and plain version
// differ only by rounding (FMA contraction, summation order).  Nothing here
// uses reduced precision: the build has no --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dflo {

constexpr double GAMMA = 1.4;
constexpr double FLOOR = 1.0e-13;   // physics/euler.FLOOR
constexpr double EPS = 1.0e-13;     // stab/positivity.EPS
constexpr double REL_F32 = 4.0e-6;  // stab/positivity.REL_F32
enum { MX = 0, MY = 1, RHO = 2, ENE = 3 };

// thread block: 32 cells along x (one warp, coalesced) by 4 rows
constexpr int BX = 32;
constexpr int BY = 4;
constexpr int NWARP = BX * BY / 32;

// Basis dimensions, in two kinds.  A kernel body reads them as d.K, d.NQ,
// d.Q, d.NL and d.QP of a dims object d and sizes its per-thread arrays
// by D::KMAX and D::NQMAX.
//
// BDims<P, MODAL>: degree P = 1..3 on its default quadrature (nq = P + 1),
// every size a compile-time constant (the loops unroll, the arrays live in
// registers).  MODAL = false is the collocated nodal Qk or GLL basis (the
// DoFs are the values at the Q quadrature points), MODAL = true the modal
// Pk Legendre basis (total degree <= P, K = (P+1)(P+2)/2 modes).
template <int P_, bool MODAL_>
struct BDims {
  static constexpr int P = P_;
  static constexpr bool MODAL = MODAL_;
  static constexpr int NQ = P + 1;                  // 1-D Gauss points
  static constexpr int Q = NQ * NQ;                 // volume quadrature points
  static constexpr int K = MODAL ? (P + 1) * (P + 2) / 2 : Q;  // DoFs per cell
  static constexpr int NL = 2 * Q + 4 * NQ;         // lift columns
  // positivity points: GLL(N) x Gauss(p+1), twice (stab/positivity._pos_points)
  static constexpr int NG = ((P + 3) % 2 == 0) ? (P + 3) / 2 : (P + 4) / 2;
  static constexpr int QP = 2 * NG * NQ;
  static constexpr int KMAX = K, NQMAX = NQ;        // array bounds
};

template <int P>
using Dims = BDims<P, false>;

// the bounds of the general dims: Q6 (K = 49 DoFs) and p + 2 = 8 points
// per face at p = 6 (ops/kernels.NQ_MAX)
constexpr int K_MAX = 49;
constexpr int NQ_MAX = 8;

// GDims<MODAL>: the general dims, read at run time: degrees 4-6 on any
// basis, and any basis off its default quadrature (nq != p + 1).  MODAL =
// true contracts the DoFs to the quadrature points first, W = V u (the
// modal Pk basis, and a nodal Qk or GLL basis whose nodes are not its
// quadrature points); MODAL = false is a collocated nodal basis.  The
// per-thread arrays are sized for K_MAX and NQ_MAX and live in local
// memory where the loops index them at run time.  P, the degree, is read
// only by the modal Pk chain (modal.cuh: each mode's total degree).
template <bool MODAL_>
struct GDims {
  static constexpr bool MODAL = MODAL_;
  static constexpr int KMAX = K_MAX, NQMAX = NQ_MAX;
  int K, NQ, Q, NL, QP, P;
};

// the general dims of K DoFs on nq x nq quadrature points; qp positivity
// points (the posts' and the modal Pk chain's; 0 where unused) and the
// degree p (the modal Pk chain's; 0 where unused)
template <bool MODAL>
inline GDims<MODAL> general_dims(int K, int nq, int qp = 0, int p = 0) {
  return GDims<MODAL>{K, nq, nq * nq, 2 * nq * nq + 4 * nq, qp, p};
}

// jnp.maximum / jnp.minimum semantics: NaN in either operand gives NaN.
// (fmax/fmin drop a NaN and return the other operand, which would hide a
// blown-up cell from the fatal-negativity flag.)
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) { return (a != a || a < b) ? a : b; }

// max(x, FLOOR) keeping NaN (torch.clamp(x, min=FLOOR))
template <typename T>
__device__ __forceinline__ T pos_floor(T x) { return nmax(x, T(FLOOR)); }

template <typename T>
__device__ __forceinline__ T pressure(const T w[4]) {
  const T ke = T(0.5) * (w[MX] * w[MX] + w[MY] * w[MY]) / w[RHO];
  return T(GAMMA - 1.0) * (w[ENE] - ke);
}

// Cartesian physical fluxes (physics/euler.flux_x / flux_y)
template <typename T>
__device__ __forceinline__ void flux_xy(const T w[4], T fx[4], T fy[4]) {
  const T p = pressure(w);
  const T u = w[MX] / w[RHO];
  const T v = w[MY] / w[RHO];
  fx[MX] = w[MX] * u + p;
  fx[MY] = w[MY] * u;
  fx[RHO] = w[MX];
  fx[ENE] = (w[ENE] + p) * u;
  fy[MX] = w[MX] * v;
  fy[MY] = w[MY] * v + p;
  fy[RHO] = w[MY];
  fy[ENE] = (w[ENE] + p) * v;
}

// HLLC flux, SU2-derived variant (src/equation.h:559-681), branchless like
// physics/fluxes.hllc.  Both cells sharing a face call it with the same
// (UL, UR, nx, ny) in the same order, so they get the same flux.
template <typename T>
__device__ __forceinline__ void hllc(const T UL[4], const T UR[4], const T nx,
                                     const T ny, T F[4]) {
  const T g1 = T(GAMMA - 1.0);
  const T rl = UL[RHO], rr = UR[RHO];
  const T sl_ = sqrt(pos_floor(rl)), sr_ = sqrt(pos_floor(rr));
  const T fl = sl_ / (sl_ + sr_);
  const T fr = T(1) - fl;

  const T ul = UL[MX] / rl, vl = UL[MY] / rl;
  const T ur = UR[MX] / rr, vr = UR[MY] / rr;
  const T v2l = ul * ul + vl * vl;
  const T v2r = ur * ur + vr * vr;
  const T vnl = ul * nx + vl * ny;
  const T vnr = ur * nx + vr * ny;
  const T u = ul * fl + ur * fr;
  const T v = vl * fl + vr * fr;
  const T vn = u * nx + v * ny;
  const T v2 = u * u + v * v;

  const T pl = g1 * (UL[ENE] - T(0.5) * rl * v2l);
  const T pr = g1 * (UR[ENE] - T(0.5) * rr * v2r);
  const T hl = (UL[ENE] + pl) / rl;
  const T hr = (UR[ENE] + pr) / rr;
  const T cl = sqrt(T(GAMMA) * pos_floor(pl) / pos_floor(rl));
  const T cr = sqrt(T(GAMMA) * pos_floor(pr) / pos_floor(rr));
  const T el = UL[ENE] / rl;
  const T er = UR[ENE] / rr;

  const T h = hl * fl + hr * fr;
  const T c = sqrt(pos_floor(g1 * (h - T(0.5) * v2)));

  const T s_l = nmin(vn - c, vnl - cl);
  const T s_r = nmax(vn + c, vnr + cr);
  const T s_m = (pl - pr - rl * vnl * (s_l - vnl) + rr * vnr * (s_r - vnr)) /
                (rr * (s_r - vnr) - rl * (s_l - vnl));
  const T p_star = rr * (vnr - s_r) * (vnr - s_m) + pr;

  // the selects of physics/fluxes.hllc: s_m >= 0 -> (s_l > 0 ? f_l : f*_l),
  // else (s_r >= 0 ? f*_r : f_r)
  const bool left = s_m >= T(0);
  const bool upwind = left ? (s_l > T(0)) : !(s_r >= T(0));
  const T rho = left ? rl : rr;
  const T uu = left ? ul : ur;
  const T vv = left ? vl : vr;
  const T vnn = left ? vnl : vnr;
  const T p = left ? pl : pr;
  const T e = left ? el : er;
  if (upwind) {
    F[MX] = rho * uu * vnn + p * nx;
    F[MY] = rho * vv * vnn + p * ny;
    F[RHO] = rho * vnn;
    F[ENE] = e * rho * vnn + p * vnn;
  } else {
    const T s = left ? s_l : s_r;
    T den = s - s_m;
    den = fabs(den) < T(1e-300) ? T(1) : den;
    const T inv = T(1) / den;
    const T smu = s - vnn;
    const T rho_s = rho * smu * inv;
    const T mx_s = (rho * uu * smu + (p_star - p) * nx) * inv;
    const T my_s = (rho * vv * smu + (p_star - p) * ny) * inv;
    const T e_s = (smu * e * rho - p * vnn + p_star * s_m) * inv;
    F[MX] = mx_s * s_m + p_star * nx;
    F[MY] = my_s * s_m + p_star * ny;
    F[RHO] = rho_s * s_m;
    F[ENE] = (e_s + p_star) * s_m;
  }
}

// |v.n| + c of a state (physics/euler.max_eigenvalue_normal)
template <typename T>
__device__ __forceinline__ T max_eig_normal(const T A[4], const T nx,
                                            const T ny) {
  const T vn = (A[MX] * nx + A[MY] * ny) / A[RHO];
  const T c = sqrt(T(GAMMA) * pos_floor(pressure(A)) / pos_floor(A[RHO]));
  return fabs(vn) + c;
}

// Local Lax-Friedrichs flux (src/equation.h:324-377), as physics/fluxes.lxf:
// the central flux plus 0.5 lam (UL - UR), lam the larger |v.n| + c of the
// two cells' AVERAGES AL, AR (src/assemble_explicit.cc:335-340).  Both cells
// sharing a face call it with the same operands in the same order.
template <typename T>
__device__ __forceinline__ void lxf(const T UL[4], const T UR[4],
                                    const T AL[4], const T AR[4], const T nx,
                                    const T ny, T F[4]) {
  const T vnl = (UL[MX] * nx + UL[MY] * ny) / UL[RHO];
  const T vnr = (UR[MX] * nx + UR[MY] * ny) / UR[RHO];
  const T pl = pressure(UL), pr = pressure(UR);
  const T lam = nmax(max_eig_normal(AL, nx, ny), max_eig_normal(AR, nx, ny));
  const T half = T(0.5);
  const T d = half * lam;
  F[MX] = half * (pl * nx + UL[MX] * vnl + pr * nx + UR[MX] * vnr) +
          d * (UL[MX] - UR[MX]);
  F[MY] = half * (pl * ny + UL[MY] * vnl + pr * ny + UR[MY] * vnr) +
          d * (UL[MY] - UR[MY]);
  F[RHO] = half * (UL[RHO] * vnl + UR[RHO] * vnr) + d * (UL[RHO] - UR[RHO]);
  F[ENE] = half * ((UL[ENE] + pl) * vnl + (UR[ENE] + pr) * vnr) +
           d * (UL[ENE] - UR[ENE]);
}

// The constant divisors of the fluxes as reciprocals rounded once in double
// (physics/fluxes._INV_G1, _INV_GAMMA): both versions multiply by them.
constexpr double INV_G1 = 1.0 / (GAMMA - 1.0);
constexpr double INV_GAMMA = 1.0 / GAMMA;

// IEEE log of the working dtype (logf for float; torch.log's on the card)
__device__ __forceinline__ float ieee_log(float x) { return logf(x); }
__device__ __forceinline__ double ieee_log(double x) { return ::log(x); }
// IEEE exp of the working dtype (expf for float; torch.exp's on the card)
__device__ __forceinline__ float ieee_exp(float x) { return expf(x); }
__device__ __forceinline__ double ieee_exp(double x) { return ::exp(x); }

// Steger-Warming flux-vector splitting (src/equation.h:382-464), as
// physics/fluxes.steger_warming: the + split of UL plus the - split of UR.
template <typename T>
__device__ __forceinline__ void sw_split(const T U[4], bool plus, const T nx,
                                         const T ny, T F[4]) {
  const T rho = U[RHO];
  const T vn = (U[MX] * nx + U[MY] * ny) / rho;
  const T q2 = (U[MX] * U[MX] + U[MY] * U[MY]) / (rho * rho);
  const T p = pressure(U);
  const T c = sqrt(T(GAMMA) * pos_floor(p) / pos_floor(rho));
  const T l1 = plus ? nmax(vn, T(0)) : nmin(vn, T(0));
  const T l2 = plus ? nmax(vn + c, T(0)) : nmin(vn + c, T(0));
  const T l3 = plus ? nmax(vn - c, T(0)) : nmin(vn - c, T(0));
  const T a = T(2.0 * (GAMMA - 1.0)) * l1 + l2 + l3;
  const T fscale = T(0.5) * rho * T(INV_GAMMA);
  F[MX] = fscale * (a * U[MX] / rho + c * (l2 - l3) * nx);
  F[MY] = fscale * (a * U[MY] / rho + c * (l2 - l3) * ny);
  F[RHO] = fscale * a;
  F[ENE] = fscale * (T(0.5) * a * q2 + c * vn * (l2 - l3) +
                     c * c * (l2 + l3) * T(INV_G1));
}

template <typename T>
__device__ __forceinline__ void steger_warming(const T UL[4], const T UR[4],
                                               const T nx, const T ny,
                                               T F[4]) {
  T fp[4], fm[4];
  sw_split(UL, true, nx, ny, fp);
  sw_split(UR, false, nx, ny, fm);
#pragma unroll
  for (int c = 0; c < 4; ++c) F[c] = fp[c] + fm[c];
}

// Roe flux with Harten's entropy fix delta = 0.1 c (src/equation.h:
// 469-556), as physics/fluxes.roe.
template <typename T>
__device__ __forceinline__ void roe(const T UL[4], const T UR[4], const T nx,
                                    const T ny, T F[4]) {
  const T g1 = T(GAMMA - 1.0);
  const T half = T(0.5);
  const T rl = UL[RHO], rr = UR[RHO];
  const T sl = sqrt(pos_floor(rl)), sr = sqrt(pos_floor(rr));
  const T fl = sl / (sl + sr);
  const T fr = T(1) - fl;

  const T ul = UL[MX] / rl, vl = UL[MY] / rl;
  const T ur = UR[MX] / rr, vr = UR[MY] / rr;
  const T v2l = ul * ul + vl * vl;
  const T v2r = ur * ur + vr * vr;
  const T vnl = ul * nx + vl * ny;
  const T vnr = ur * nx + vr * ny;
  const T u = ul * fl + ur * fr;
  const T v = vl * fl + vr * fr;
  const T vn = u * nx + v * ny;
  const T v2 = u * u + v * v;
  const T du = ur - ul, dv = vr - vl;
  const T v_dot_dv = u * du + v * dv;

  const T pl = g1 * (UL[ENE] - half * rl * v2l);
  const T pr = g1 * (UR[ENE] - half * rr * v2r);
  const T hl = T(GAMMA) * pl / rl * T(INV_G1) + half * v2l;
  const T hr = T(GAMMA) * pr / rr * T(INV_G1) + half * v2r;

  const T rho = sl * sr;
  const T h = hl * fl + hr * fr;
  const T c = sqrt(pos_floor(g1 * (h - half * v2)));
  const T drho = rr - rl;
  const T dp = pr - pl;
  const T dvn = vnr - vnl;

  const T a1 = (dp - rho * c * dvn) / (T(2) * c * c);
  const T a2 = drho - dp / (c * c);
  const T a3 = (dp + rho * c * dvn) / (T(2) * c * c);

  T l1 = fabs(vn - c);
  const T l2 = fabs(vn);
  T l3 = fabs(vn + c);
  const T delta = T(0.1) * c;
  l1 = l1 < delta ? half * (l1 * l1 / delta + delta) : l1;
  l3 = l3 < delta ? half * (l3 * l3 / delta + delta) : l3;

  const T d_rho = l1 * a1 + l2 * a2 + l3 * a3;
  const T d_ene = l1 * a1 * (h - c * vn) + l2 * a2 * half * v2 +
                  l2 * rho * (v_dot_dv - vn * dvn) + l3 * a3 * (h + c * vn);
  const T p_avg = half * (pl + pr);
  const T d_mx = (u - nx * c) * l1 * a1 + u * l2 * a2 +
                 (du - nx * dvn) * l2 * rho + (u + nx * c) * l3 * a3;
  const T d_my = (v - ny * c) * l1 * a1 + v * l2 * a2 +
                 (dv - ny * dvn) * l2 * rho + (v + ny * c) * l3 * a3;

  F[MX] = nx * p_avg + half * (UL[MX] * vnl + UR[MX] * vnr) - half * d_mx;
  F[MY] = ny * p_avg + half * (UL[MY] * vnl + UR[MY] * vnr) - half * d_my;
  F[RHO] = half * (rl * vnl + rr * vnr - d_rho);
  F[ENE] = half * (rl * hl * vnl + rr * hr * vnr - d_ene);
}

// sign(x) as torch.sign (0 at 0)
template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

// Abramowitz-Stegun 7.1.26 rational erf (physics/fluxes.erf_approx)
template <typename T>
__device__ __forceinline__ T erf_approx(T x) {
  const T s = sign_of(x);
  const T a = fabs(x);
  const T t = T(1) / (T(1) + T(0.3275911) * a);
  const T poly =
      t * (T(0.254829592) +
           t * (T(-0.284496736) +
                t * (T(1.421413741) +
                     t * (T(-1.453152027) + t * T(1.061405429)))));
  return s * (T(1) - poly * ieee_exp(-a * a));
}

// Kinetic split flux of Deshpande/Mandal (src/equation.h:714-751) with the
// A&S erf, as physics/fluxes._kinetic_split(erf_fn=erf_approx); F += the
// split of U (sign +1 for the left state, -1 for the right).
template <typename T>
__device__ __forceinline__ void kinetic_split(const T U[4], bool plus,
                                              const T nx, const T ny,
                                              T F[4]) {
  const T sg = plus ? T(1) : T(-1);
  const T vn = (U[MX] * nx + U[MY] * ny) / U[RHO];
  const T p = pressure(U);
  const T beta = T(0.5) * pos_floor(U[RHO]) / pos_floor(p);
  const T s = vn * sqrt(beta);
  const T A = T(0.5) * (T(1) + sg * erf_approx(s));
  const T B = T(plus ? 0.5 : -0.5) * ieee_exp(-s * s) /
              sqrt(T(3.141592653589793) * beta);
  const T ufact = vn * A + B;
  F[MX] = p * nx * A + U[MX] * ufact;
  F[MY] = p * ny * A + U[MY] * ufact;
  F[RHO] = U[RHO] * ufact;
  F[ENE] = (U[ENE] + p) * vn * A + (U[ENE] + T(0.5) * p) * B;
}

// KFVS (src/equation.h:756-782) in its kernel form (physics/fluxes.
// kfvs_kernel): the + split of UL plus the - split of UR.
template <typename T>
__device__ __forceinline__ void kfvs(const T UL[4], const T UR[4], const T nx,
                                     const T ny, T F[4]) {
  T fp[4], fm[4];
  kinetic_split(UL, true, nx, ny, fp);
  kinetic_split(UR, false, nx, ny, fm);
#pragma unroll
  for (int c = 0; c < 4; ++c) F[c] = fp[c] + fm[c];
}

// Logarithmic mean with the series guard (src_mpi/equation.h:26-45), as
// physics/fluxes.logavg.
template <typename T>
__device__ __forceinline__ T logavg(T a, T b) {
  const T xi = b / a;
  const T f = (xi - T(1)) / (xi + T(1));
  const T u = f * f;
  const T u2 = u * u;
  const bool small = u < T(1.0e-2);
  if (small)
    return T(0.5) * (a + b) /
           (T(1) + u * T(1.0 / 3.0) + u2 * T(1.0 / 5.0) +
            u2 * u * T(1.0 / 7.0));
  return T(0.5) * (a + b) / (ieee_log(xi) / (T(2) * f));
}

// Chandrashekar-style kinetic-energy-preserving, entropy-stable flux with
// the eigen-decomposed entropy-variable dissipation on the cell averages
// AL, AR (kep_flux + kep_diff_matrix, src_mpi/equation.h:748-920), as
// physics/fluxes.kep.  Both cells sharing a face call it with the same
// operands in the same order.
template <typename T>
__device__ __forceinline__ void kep(const T UL[4], const T UR[4],
                                    const T AL[4], const T AR[4], const T nx,
                                    const T ny, T F[4]) {
  const T g1 = T(GAMMA - 1.0);
  const T half = T(0.5);
  const T inv_gamma = T(INV_GAMMA);
  const T rl = UL[RHO], rr = UR[RHO];
  const T rho = logavg(rl, rr);
  const T ul = UL[MX] / rl, vl = UL[MY] / rl;
  const T ur = UR[MX] / rr, vr = UR[MY] / rr;
  const T v2l = ul * ul + vl * vl;
  const T v2r = ur * ur + vr * vr;
  const T u = half * (ul + ur);
  const T v = half * (vl + vr);
  const T vn = u * nx + v * ny;
  const T vel2 = half * (v2l + v2r);

  const T pl = g1 * (UL[ENE] - half * rl * v2l);
  const T pr = g1 * (UR[ENE] - half * rr * v2r);
  const T betal = half * pos_floor(rl) / pos_floor(pl);
  const T betar = half * pos_floor(rr) / pos_floor(pr);
  const T beta = logavg(betal, betar);
  const T p = half * (rl + rr) / (betal + betar);

  // central entropy-conservative part (src_mpi/equation.h:891-897)
  const T f_rho = rho * vn;
  const T f_mx = nx * p + u * f_rho;
  const T f_my = ny * p + v * f_rho;
  const T f_ene = half * (T(1) / (g1 * beta) - vel2) * f_rho + f_mx * u +
                  f_my * v;

  // dissipation matrix on the average states (kep_diff_matrix)
  const T arl = AL[RHO], arr = AR[RHO];
  const T arho = logavg(arl, arr);
  const T aul = AL[MX] / arl, avl = AL[MY] / arl;
  const T aur = AR[MX] / arr, avr = AR[MY] / arr;
  const T av2l = aul * aul + avl * avl;
  const T av2r = aur * aur + avr * avr;
  const T avnl = aul * nx + avl * ny;
  const T avnr = aur * nx + avr * ny;
  const T au = half * (aul + aur);
  const T av = half * (avl + avr);
  const T avn = au * nx + av * ny;
  const T av2 = au * au + av * av;

  const T apl = g1 * (AL[ENE] - half * arl * av2l);
  const T apr = g1 * (AR[ENE] - half * arr * av2r);
  const T abetal = half * pos_floor(arl) / pos_floor(apl);
  const T abetar = half * pos_floor(arr) / pos_floor(apr);
  const T abeta = logavg(abetal, abetar);
  const T aa = sqrt(T(0.5 * GAMMA) * (T(1) / abeta));
  const T ap = half * (arl + arr) / (abetal + abetar);

  const T H = aa * aa * T(INV_G1) + half * av2;
  const T v1 = au * ny - av * nx;
  const T one = T(1), zero = T(0);
  // R columns: eigenvectors in (rho, mx, my, E) internal ordering
  const T R[4][4] = {{one, au - aa * nx, av - aa * ny, H - aa * avn},
                     {one, au, av, half * av2},
                     {zero, ny * one, -nx * one, v1},
                     {one, au + aa * nx, av + aa * ny, H + aa * avn}};
  const T al_ = sqrt(T(GAMMA) * pos_floor(apl) / pos_floor(arl));
  const T ar_ = sqrt(T(GAMMA) * pos_floor(apr) / pos_floor(arr));
  const T bump = T(1.0 / 6.0);
  const T lam[4] = {
      fabs(avn - aa) + bump * fabs((avnl - al_) - (avnr - ar_)), fabs(avn),
      fabs(avn), fabs(avn + aa) + bump * fabs((avnl + al_) - (avnr + ar_))};
  const T S[4] = {half * arho * inv_gamma, g1 * arho * inv_gamma, ap,
                  half * arho * inv_gamma};

  // jump in entropy variables (src_mpi/equation.h:902-908)
  const T ds = ieee_log(pr / pl) - T(GAMMA) * ieee_log(rr / rl);
  const T dV[4] = {-ds * T(INV_G1) - (betar * v2r - betal * v2l),
                   T(2) * (betar * ur - betal * ul),
                   T(2) * (betar * vr - betal * vl),
                   T(-2) * (betar - betal)};

  // Diff = sum_k R_k (lam_k S_k) (R_k . dV), the terms in k order
  T diff[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T proj =
        ((R[k][0] * dV[0] + R[k][1] * dV[1]) + R[k][2] * dV[2]) +
        R[k][3] * dV[3];
    const T w = lam[k] * S[k] * proj;
#pragma unroll
    for (int c = 0; c < 4; ++c) diff[c] = k == 0 ? R[k][c] * w : diff[c] + R[k][c] * w;
  }
  F[MX] = f_mx - half * diff[1];
  F[MY] = f_my - half * diff[2];
  F[RHO] = f_rho - half * diff[0];
  F[ENE] = f_ene - half * diff[3];
}

// Left/right eigenvector matrices along x (dir 0) or y (dir 1) of state ub,
// in the internal (rho, mx, my, E) ordering (physics/euler.eigen_matrices).
// The operations and their order are those of the torch version, division
// by a constant written as a product with its reciprocal as there, so that
// with contraction off (every source is built with -fmad=false) both round
// alike.
template <typename T>
__device__ __forceinline__ void eigen(const T ub[4], int dir, T R[4][4],
                                      T L[4][4]) {
  const T g1 = T(GAMMA - 1.0);
  const T rho = ub[RHO];
  const T u = ub[MX] / rho;
  const T v = ub[MY] / rho;
  const T q2 = u * u + v * v;
  const T p = g1 * (ub[ENE] - T(0.5) * rho * q2);
  const T c2 = T(GAMMA) * pos_floor(p) / pos_floor(rho);
  const T c = sqrt(c2);
  const T inv_c2 = T(1) / c2;
  const T beta = T(0.5) * inv_c2;
  const T phi2 = T(0.5 * (GAMMA - 1.0)) * q2;
  const T h = c2 * T(1.0 / (GAMMA - 1.0)) + T(0.5) * q2;
  const T one = T(1), zero = T(0);
  L[0][0] = one - phi2 / c2; L[0][1] = g1 * u / c2; L[0][2] = g1 * v / c2;
  L[0][3] = -g1 * inv_c2;
  R[0][0] = one; R[0][1] = zero; R[0][2] = one; R[0][3] = one;
  if (dir == 0) {
    R[1][0] = u; R[1][1] = zero; R[1][2] = u + c; R[1][3] = u - c;
    R[2][0] = v; R[2][1] = -one; R[2][2] = v; R[2][3] = v;
    R[3][0] = T(0.5) * q2; R[3][1] = -v; R[3][2] = h + c * u; R[3][3] = h - c * u;
    L[1][0] = v; L[1][1] = zero; L[1][2] = -one; L[1][3] = zero;
    L[2][0] = beta * (phi2 - c * u); L[2][1] = beta * (c - g1 * u);
    L[2][2] = -beta * g1 * v; L[2][3] = beta * g1;
    L[3][0] = beta * (phi2 + c * u); L[3][1] = -beta * (c + g1 * u);
    L[3][2] = -beta * g1 * v; L[3][3] = beta * g1;
  } else {
    R[1][0] = u; R[1][1] = one; R[1][2] = u; R[1][3] = u;
    R[2][0] = v; R[2][1] = zero; R[2][2] = v + c; R[2][3] = v - c;
    R[3][0] = T(0.5) * q2; R[3][1] = u; R[3][2] = h + c * v; R[3][3] = h - c * v;
    L[1][0] = -u; L[1][1] = one; L[1][2] = zero; L[1][3] = zero;
    L[2][0] = beta * (phi2 - c * v); L[2][1] = -beta * g1 * u;
    L[2][2] = beta * (c - g1 * v); L[2][3] = beta * g1;
    L[3][0] = beta * (phi2 + c * v); L[3][1] = -beta * g1 * u;
    L[3][2] = -beta * (c + g1 * v); L[3][3] = beta * g1;
  }
}

// W_char = L @ (rho, mx, my, E)(W)   (physics/euler.to_characteristic)
template <typename T>
__device__ __forceinline__ void to_char(const T L[4][4], const T w[4], T out[4]) {
  const T V[4] = {w[RHO], w[MX], w[MY], w[ENE]};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = L[i][0] * V[0] + L[i][1] * V[1] + L[i][2] * V[2] + L[i][3] * V[3];
}

// inverse transform back to the conserved layout (physics/euler.to_conserved)
template <typename T>
__device__ __forceinline__ void to_cons(const T R[4][4], const T wc[4], T out[4]) {
  T V[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    V[i] = R[i][0] * wc[0] + R[i][1] * wc[1] + R[i][2] * wc[2] + R[i][3] * wc[3];
  out[MX] = V[1];
  out[MY] = V[2];
  out[RHO] = V[0];
  out[ENE] = V[3];
}

// TVB minmod (stab/limiter.minmod)
template <typename T>
__device__ __forceinline__ T minmod(T a, T b, T c, T Mdx2) {
  const bool samesign = (a * b > T(0)) && (b * c > T(0));
  const T sg = a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);  // torch.sign
  const T m = sg * nmin(fabs(a), nmin(fabs(b), fabs(c)));
  return fabs(a) < Mdx2 ? a : (samesign ? m : T(0));
}

// TVB slope limiting of one direction of one cell (stab/limiter.
// make_tvb_limiter): the slope D and the backward / forward mean
// differences db, df along x (dir 0) or y (dir 1), optionally in
// characteristic variables of the cell mean ub, through minmod with beta and
// Mdx2; writes the limited slope, back in conserved variables, to Dn and
// returns the direction's change measure mean|Dn - D| * 0.25 (in the
// limited variables).
template <typename T>
__device__ __forceinline__ T tvb_dir(const T ub[4], int dir, T D[4], T db[4],
                                     T df[4], bool char_lim, T beta, T Mdx2,
                                     T Dn[4]) {
  T Rm[4][4], Lm[4][4], cD[4], cdb[4], cdf[4], cDn[4];
  if (char_lim) {
    eigen(ub, dir, Rm, Lm);
    to_char(Lm, D, cD);
    to_char(Lm, db, cdb);
    to_char(Lm, df, cdf);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) { cD[c] = D[c]; cdb[c] = db[c]; cdf[c] = df[c]; }
  }
  T s = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cDn[c] = minmod(cD[c], beta * cdb[c], beta * cdf[c], Mdx2);
    s = c == 0 ? fabs(cDn[c] - cD[c]) : s + fabs(cDn[c] - cD[c]);
  }
  if (char_lim) {
    to_cons(Rm, cDn, Dn);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) Dn[c] = cDn[c];
  }
  return s * T(0.25);
}

// TVB slope limiting of one cell (shared by fused_post.cu and
// fused_pk_post.cu): both directions, x then y; returns the change measure
// mean|Dxn - Dx| + mean|Dyn - Dy| and writes the limited slopes to Dxn, Dyn.
template <typename T>
__device__ __forceinline__ T tvb_slopes(const T ub[4], T Dx[4], T Dy[4],
                                        T dbx[4], T dfx[4], T dby[4],
                                        T dfy[4], bool char_lim, T beta,
                                        T Mdx2, T Dxn[4], T Dyn[4]) {
  T change = T(0);
  change = change + tvb_dir(ub, 0, Dx, dbx, dfx, char_lim, beta, Mdx2, Dxn);
  change = change + tvb_dir(ub, 1, Dy, dby, dfy, char_lim, beta, Mdx2, Dyn);
  return change;
}

// Zhang-Shu scale factors of one cell (stab/positivity, src/positivity.cc:
// 16-208) with the dtype-aware floors (absolute EPS in f64, relative
// REL_F32 floors in f32): theta1 from the density at the d.QP positivity
// points Pm [QP][K], theta2 from the pressure there after the density
// squeeze.  w holds the cell's DoFs before either scaling and ub its mean;
// the caller applies the scaling (nodal: every DoF about the mean; modal:
// mode 0 about the mean, the other modes toward 0).  The operations and
// their order are the plain version's: the point values are ordered sums
// (ops/contract.basis_apply_ordered), one multiply and one add per term,
// so with contraction off (-fmad=false) the branches at the pressure floor
// (pre < eps_p, |1 - t| < 1e-14, decided by rounding there) go the same way
// in the kernel and in the plain version, at any shape.
//
// The chain is split into its per-cell and per-point parts (zs_floors,
// zs_theta1, zs_point_t) so that the MOOD candidate's tile kernel runs the
// points of its staged cells spread over the threads with the same
// operations (tile.cuh tile_thetas).
template <typename T>
__device__ __forceinline__ void zs_floors(const T ub[4], T& eps_r, T& eps_p) {
  eps_r = T(EPS);
  eps_p = T(EPS);
  if (sizeof(T) < sizeof(double)) {   // f32: relative floors
    eps_r = nmax(T(EPS), T(REL_F32) * ub[RHO]);
    eps_p = nmax(T(EPS), T(REL_F32) * pressure(ub));
  }
}

// theta1 from the smallest density rho_min at the positivity points
template <typename T>
__device__ __forceinline__ T zs_theta1(T rho_avg, T eps_r, T rho_min) {
  const T rat = fabs(rho_avg - eps_r) / (fabs(rho_avg - rho_min) + T(1.0e-13));
  return nmin(rat, T(1));
}

// the pressure factor t of one positivity point whose values are Wq (the
// density squeezed by theta1 here), about the cell mean ub; 1 where the
// squeezed pressure is not below eps_p (NaN included), as the plain
// version's select, whose other operand is then never computed
template <typename T>
__device__ __forceinline__ T zs_point_t(T Wq[4], const T ub[4], T theta1,
                                        T eps_p) {
  const T inv_g1 = T(1) / T(GAMMA - 1.0);   // the plain version's 1/g1
  const T rho_avg = ub[RHO];
  const T mavg_x = ub[MX], mavg_y = ub[MY], ravg = ub[RHO], Eavg = ub[ENE];
  Wq[RHO] = Wq[RHO] * theta1 + rho_avg * (T(1) - theta1);
  const T pre = pressure(Wq);
  if (!(pre < eps_p)) return T(1);
  const T drho = Wq[RHO] - ub[RHO], dE = Wq[ENE] - ub[ENE];
  const T dmx = Wq[MX] - ub[MX], dmy = Wq[MY] - ub[MY];
  const T a1 = T(2) * drho * dE - (dmx * dmx + dmy * dmy);
  const T b1 = T(2) * drho * (Eavg - eps_p * inv_g1) + T(2) * ravg * dE -
               T(2) * (mavg_x * dmx + mavg_y * dmy);
  const T c1 = T(2) * ravg * Eavg - (mavg_x * mavg_x + mavg_y * mavg_y) -
               T(2) * eps_p * ravg * inv_g1;
  const T a1s = a1 == T(0) ? T(1) : a1;
  const T b1n = b1 / a1s, c1n = c1 / a1s;
  const T Dq = sqrt(fabs(b1n * b1n - T(4) * c1n));
  const T t1 = T(0.5) * (-b1n - Dq);
  const T t2 = T(0.5) * (-b1n + Dq);
  const bool t1_ok = (t1 > T(-1.0e-12)) && (t1 < T(1) + T(1.0e-12));
  T t = t1_ok ? t1 : t2;
  t = t < T(0) ? T(0) : (t > T(1) ? T(1) : t);   // clip, NaN kept
  return fabs(T(1) - t) < T(1.0e-14) ? T(0) : t;
}

template <typename T, class D>
__device__ __forceinline__ void zs_thetas(const D& d, const T w[4][D::KMAX],
                                          const T ub[4],
                                          const T* __restrict__ Pm,
                                          T& theta1, T& theta2) {
  const int K = d.K, QP = d.QP;
  T eps_r, eps_p;
  zs_floors(ub, eps_r, eps_p);
  T rho_min = T(INFINITY);
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    T r = Pm[q * K] * w[RHO][0];
#pragma unroll
    for (int k = 1; k < K; ++k) r = r + Pm[q * K + k] * w[RHO][k];
    rho_min = nmin(rho_min, r);
  }
  theta1 = zs_theta1(ub[RHO], eps_r, rho_min);
  theta2 = T(INFINITY);
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    T Wq[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      T s = Pm[q * K] * w[c][0];
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + Pm[q * K + k] * w[c][k];
      Wq[c] = s;
    }
    theta2 = nmin(theta2, zs_point_t(Wq, ub, theta1, eps_p));
  }
}

// sum_k op[k] * v[k], one multiply and one add per term in k order
// (contract._ordered_sum; exact only where contraction is off)
template <typename T, int K>
__device__ __forceinline__ T dot_seq(const T* __restrict__ op, const T v[K]) {
  T acc = op[0] * v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + op[k] * v[k];
  return acc;
}

// Block reduction of the per-cell diagnostics: NaN-propagating max of lam and
// min of mq over the block; thread 0 writes the block's partials.  Every
// thread of the block must call it.
template <typename T>
__device__ __forceinline__ void block_diag(T lam, T mq, T* __restrict__ lam_part,
                                           T* __restrict__ minq_part) {
  __shared__ T s_lam[NWARP];
  __shared__ T s_mq[NWARP];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lam = nmax(lam, __shfl_down_sync(0xffffffffu, lam, off));
    mq = nmin(mq, __shfl_down_sync(0xffffffffu, mq, off));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    s_lam[tid >> 5] = lam;
    s_mq[tid >> 5] = mq;
  }
  __syncthreads();
  if (tid == 0) {
    T l = s_lam[0], m = s_mq[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      l = nmax(l, s_lam[w]);
      m = nmin(m, s_mq[w]);
    }
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    lam_part[b] = l;
    minq_part[b] = m;
  }
}

// per-cell (lam, min(rho, p)) from the cell average (fused_diag's body and
// the posts' diag; pallas_kernels.py:1697-1715); inv_h = T(1) / T(h), the
// reciprocal PyTorch multiplies by where the plain version divides by h
template <typename T>
__device__ __forceinline__ void cell_diag(const T ub[4], T inv_h, T& lam,
                                          T& mq) {
  const T rho = ub[RHO];
  const T pre = pressure(ub);
  const T cs = sqrt(T(GAMMA) * fabs(pre) / fabs(rho));
  const T vx = fabs(ub[MX] / rho);
  const T vy = fabs(ub[MY] / rho);
  lam = (cs + vx) * inv_h + (cs + vy) * inv_h;
  mq = nmin(rho, pre);
}

inline dim3 grid_for(int ny, int nx) {
  return dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY);
}

}  // namespace dflo
