// Fused stabilization chain of one RK stage, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_post (the single-chip
// kernel, with and without its diag outputs), unmasked.  Per cell, in this
// order: its cell average and its four neighbors' averages; the KXRCF jump
// of the indicator variable across its faces (pallas_kernels.py:1290-1323);
// the characteristic TVB limiter with minmod, Mdx2 and the change > 1e-10
// gate (:1325-1365); Zhang-Shu positivity with the dtype-aware floors
// (:1367-1425); with diag, the CFL wave speed and min(rho, p) of the cell
// average (the chain preserves cell means), reduced per block with
// NaN-propagating max/min into partials that the wrapper reduces with
// torch.amax/amin (:1527).  Neighbor-exists flags come from global-edge
// arithmetic (:1277-1288); per_x / per_y are arguments.
//
// What bounds it on the H100: bytes.  Each cell reads its own 4K values and
// each neighbor's 4K values (for the neighbor's average and facing trace),
// roughly 5x the state through L1/L2, and writes 4K values.  The per-cell
// arithmetic (two 4x4 eigen systems, 18 positivity points at p = 2) is
// modest.  The simple design relies on the 32 x 4 block for L1 reuse of the
// neighbor rows; a later version stages a shared-memory tile with a one-cell
// halo so each cell's average and traces are computed once per block.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

struct PostParams {
  int per_x, per_y, comp, char_lim, pos_lim;
  double dx, dy, h, hdx, hdy, inv_h, diam_pow, Mdx2, beta;
};

// operator buffer layout (ops/kernels.post_operators), all [.][K] rows
template <int P>
struct PostOps {
  static constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ;
  static constexpr int FACEV = 0;                // [4][NQ][K] face traces
  static constexpr int WQ = FACEV + 4 * NQ * K;  // [NQ] face weights
  static constexpr int AVG = WQ + NQ;            // [K] cell average
  static constexpr int GX = AVG + K;             // [K] mean d/dx
  static constexpr int GY = GX + K;              // [K] mean d/dy
  static constexpr int DRX = GY + K;             // [K] node x - centre
  static constexpr int DRY = DRX + K;            // [K] node y - centre
  static constexpr int PM = DRY + K;             // [QP][K] positivity points
};

// load one cell's component c
template <typename T, int K>
__device__ __forceinline__ void load_comp(const T* __restrict__ u, int c,
                                          long plane, long cell, T v[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __ldg(u + (long)(c * K + k) * plane + cell);
}

// a neighbor's cell average and its trace of component comp on face f
template <typename T, int P>
__device__ __forceinline__ void avg_and_trace(const T* __restrict__ u,
                                              const T* __restrict__ ops, int f,
                                              int comp, long plane, long cell,
                                              T ub[4], T tr[P + 1]) {
  constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ;
  T v[K];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    load_comp<T, K>(u, c, plane, cell, v);
    ub[c] = dot_seq<T, K>(ops + PostOps<P>::AVG, v);
  }
  load_comp<T, K>(u, comp, plane, cell, v);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    tr[q] = dot_seq<T, K>(ops + PostOps<P>::FACEV + (f * NQ + q) * K, v);
}

// face integral of the indicator jump: sum_q wq[q] * (t[q] - tn[q]) * valid
template <typename T, int NQ>
__device__ __forceinline__ T face_jump(const T* __restrict__ wq, const T t[NQ],
                                       const T tn[NQ], T valid) {
  T j[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) j[q] = (t[q] - tn[q]) * valid;
  return dot_seq<T, NQ>(wq, j);
}

// TVB minmod (stab/limiter.minmod)
template <typename T>
__device__ __forceinline__ T minmod(T a, T b, T c, T Mdx2) {
  const bool samesign = (a * b > T(0)) && (b * c > T(0));
  const T sg = a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);  // torch.sign
  const T m = sg * nmin(fabs(a), nmin(fabs(b), fabs(c)));
  return fabs(a) < Mdx2 ? a : (samesign ? m : T(0));
}

// The chain follows stab/indicator, stab/limiter and stab/positivity
// operation by operation.  Every quantity that feeds a threshold decision
// (KXRCF > 1, change > 1e-10) is computed with the IEEE operations of the
// torch version in the same order (ordered sums, no contraction: this file
// is built with -fmad=false), so in float32 the kernel and the plain
// version take the same limiter decisions.
template <typename T, int P>
__global__ void __launch_bounds__(BX * BY)
fused_post_kernel(const T* __restrict__ u, const T* __restrict__ ops,
                  T* __restrict__ out, T* __restrict__ lam_part,
                  T* __restrict__ minq_part, int ny, int nx, PostParams prm) {
  constexpr int K = Dims<P>::K, NQ = Dims<P>::NQ, QP = Dims<P>::QP;
  using O = PostOps<P>;
  const T* faceV = ops + O::FACEV;
  const T* wq = ops + O::WQ;
  const T* avg = ops + O::AVG;
  const T* Pm = ops + O::PM;

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
    const bool vW = prm.per_x || x > 0, vE = prm.per_x || x < nx - 1;
    const bool vS = prm.per_y || y > 0, vN = prm.per_y || y < ny - 1;
    const int comp = prm.comp;
    const T dx = T(prm.dx), dy = T(prm.dy), h = T(prm.h);

    // ---- neighbor averages and their facing indicator traces ------------
    T ubW[4], ubE[4], ubS[4], ubN[4], tEw[NQ], tWe[NQ], tNs[NQ], tSn[NQ];
    avg_and_trace<T, P>(u, ops, 1, comp, plane, (long)y * nx + xw, ubW, tEw);
    avg_and_trace<T, P>(u, ops, 0, comp, plane, (long)y * nx + xe, ubE, tWe);
    avg_and_trace<T, P>(u, ops, 3, comp, plane, (long)ys * nx + x, ubS, tNs);
    avg_and_trace<T, P>(u, ops, 2, comp, plane, (long)yn * nx + x, ubN, tSn);

    // ---- own state and average ------------------------------------------
    T w[4][K], ub[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      load_comp<T, K>(u, c, plane, cell, w[c]);
      ub[c] = dot_seq<T, K>(avg, w[c]);
    }

    // ---- KXRCF shock indicator (src/indicator.cc:48-198) ----------------
    // the indicator variable's DoFs, selected without a runtime index into
    // the register array
    T wi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wi[k] = comp == ENE ? w[ENE][k] : w[RHO][k];
    const T ubi = comp == ENE ? ub[ENE] : ub[RHO];
    T tW[NQ], tE[NQ], tS[NQ], tN[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      tW[q] = dot_seq<T, K>(faceV + (0 * NQ + q) * K, wi);
      tE[q] = dot_seq<T, K>(faceV + (1 * NQ + q) * K, wi);
      tS[q] = dot_seq<T, K>(faceV + (2 * NQ + q) * K, wi);
      tN[q] = dot_seq<T, K>(faceV + (3 * NQ + q) * K, wi);
    }
    const T fW = face_jump<T, NQ>(wq, tW, tEw, T(vW));
    const T fE = face_jump<T, NQ>(wq, tE, tWe, T(vE));
    const T fS = face_jump<T, NQ>(wq, tS, tNs, T(vS));
    const T fN = face_jump<T, NQ>(wq, tN, tSn, T(vN));
    const T vx = ub[MX] / ub[RHO];
    const T vy = ub[MY] / ub[RHO];
    const T inW = T(-vx < T(0)) * T(vW);
    const T inE = T(vx < T(0)) * T(vE);
    const T inS = T(-vy < T(0)) * T(vS);
    const T inN = T(vy < T(0)) * T(vN);
    const T ind = (inW * fW + inE * fE) * dy + (inS * fS + inN * fN) * dx;
    const T measure = (inW + inE) * dy + (inS + inN) * dx;
    const T denom = T(prm.diam_pow) * measure * ubi;
    const T shock = fabs(denom) > T(0)
                        ? fabs(ind) / (denom == T(0) ? T(1) : denom) : T(0);

    // ---- TVB limiter (src/limiter.cc:224-370) ----------------------------
    T Dx[4], Dy[4], dbx[4], dfx[4], dby[4], dfy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dx[c] = T(prm.hdx) * dot_seq<T, K>(ops + O::GX, w[c]);
      Dy[c] = T(prm.hdy) * dot_seq<T, K>(ops + O::GY, w[c]);
      dbx[c] = vW ? ub[c] - ubW[c] : Dx[c];
      dfx[c] = vE ? ubE[c] - ub[c] : Dx[c];
      dby[c] = vS ? ub[c] - ubS[c] : Dy[c];
      dfy[c] = vN ? ubN[c] - ub[c] : Dy[c];
    }
    const T beta = T(prm.beta), Mdx2 = T(prm.Mdx2);
    T Dxn[4], Dyn[4], change = T(0);
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      T* D = dir == 0 ? Dx : Dy;
      T* db = dir == 0 ? dbx : dby;
      T* df = dir == 0 ? dfx : dfy;
      T* Dn = dir == 0 ? Dxn : Dyn;
      T Rm[4][4], Lm[4][4], cD[4], cdb[4], cdf[4], cDn[4];
      if (prm.char_lim) {
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
      change = change + s * T(0.25);
      if (prm.char_lim) {
        to_cons(Rm, cDn, Dn);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) Dn[c] = cDn[c];
      }
    }
    if (shock > T(1) && change > T(1.0e-10)) {
      // nodal linear rebuild ub + drx (Dxn / h) + dry (Dyn / h)
      const T inv_h = T(prm.inv_h);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T sx = Dxn[c] * inv_h, sy = Dyn[c] * inv_h;
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[c][k] = ub[c] + ops[O::DRX + k] * sx + ops[O::DRY + k] * sy;
      }
    }

    // ---- Zhang-Shu positivity (src/positivity.cc:16-208) -----------------
    if (prm.pos_lim) {
      const T g1 = T(GAMMA - 1.0);
      T eps_r = T(EPS), eps_p = T(EPS);
      if (sizeof(T) < sizeof(double)) {   // f32: relative floors
        eps_r = nmax(T(EPS), T(REL_F32) * ub[RHO]);
        eps_p = nmax(T(EPS), T(REL_F32) * pressure(ub));
      }
      const T rho_avg = ub[RHO];
      T rho_min = T(INFINITY);
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        T r = Pm[q * K] * w[RHO][0];
#pragma unroll
        for (int k = 1; k < K; ++k) r = fma(Pm[q * K + k], w[RHO][k], r);
        rho_min = nmin(rho_min, r);
      }
      const T rat = fabs(rho_avg - eps_r) / (fabs(rho_avg - rho_min) + T(1.0e-13));
      const T theta1 = nmin(rat, T(1));
      const T mavg_x = ub[MX], mavg_y = ub[MY], ravg = ub[RHO], Eavg = ub[ENE];
      T theta2 = T(INFINITY);
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        T Wq[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          T s = Pm[q * K] * w[c][0];
#pragma unroll
          for (int k = 1; k < K; ++k) s = fma(Pm[q * K + k], w[c][k], s);
          Wq[c] = s;
        }
        Wq[RHO] = Wq[RHO] * theta1 + rho_avg * (T(1) - theta1);
        const T pre = pressure(Wq);
        const T drho = Wq[RHO] - ub[RHO], dE = Wq[ENE] - ub[ENE];
        const T dmx = Wq[MX] - ub[MX], dmy = Wq[MY] - ub[MY];
        const T a1 = T(2) * drho * dE - (dmx * dmx + dmy * dmy);
        const T b1 = T(2) * drho * (Eavg - eps_p / g1) + T(2) * ravg * dE -
                     T(2) * (mavg_x * dmx + mavg_y * dmy);
        const T c1 = T(2) * ravg * Eavg - (mavg_x * mavg_x + mavg_y * mavg_y) -
                     T(2) * eps_p * ravg / g1;
        const T a1s = a1 == T(0) ? T(1) : a1;
        const T b1n = b1 / a1s, c1n = c1 / a1s;
        const T Dq = sqrt(fabs(b1n * b1n - T(4) * c1n));
        const T t1 = T(0.5) * (-b1n - Dq);
        const T t2 = T(0.5) * (-b1n + Dq);
        const bool t1_ok = (t1 > T(-1.0e-12)) && (t1 < T(1) + T(1.0e-12));
        T t = t1_ok ? t1 : t2;
        t = t < T(0) ? T(0) : (t > T(1) ? T(1) : t);   // clip, NaN kept
        t = fabs(T(1) - t) < T(1.0e-14) ? T(0) : t;
        t = pre < eps_p ? t : T(1);
        theta2 = nmin(theta2, t);
      }
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

    if (lam_part != nullptr) cell_diag(ub, h, lam, mq);
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

template <typename T, int P>
static int launch(const void* u, const void* ops, void* out, void* lam_part,
                  void* minq_part, int ny, int nx, const PostParams& prm,
                  cudaStream_t stream) {
  fused_post_kernel<T, P><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, (const T*)ops, (T*)out, (T*)lam_part, (T*)minq_part, ny, nx,
      prm);
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in {1, 2, 3}.  lam_part/minq_part NULL
// for the form without diag, else dflo_num_blocks(ny, nx) entries each.
// Returns cudaGetLastError() after the launch, -1 for an unsupported case.
extern "C" int dflo_fused_post(int dtype, int p, const void* u, const void* ops,
                               void* out, void* lam_part, void* minq_part,
                               int ny, int nx, int per_x, int per_y, int comp,
                               int char_lim, int pos_lim, double dx, double dy,
                               double h, double hdx, double hdy, double inv_h,
                               double diam_pow, double Mdx2, double beta,
                               void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  const dflo::PostParams prm{per_x, per_y, comp, char_lim, pos_lim, dx, dy, h,
                             hdx, hdy, inv_h, diam_pow, Mdx2, beta};
  cudaStream_t s = (cudaStream_t)stream;
#define DFLO_CASE(T, P) \
  return dflo::launch<T, P>(u, ops, out, lam_part, minq_part, ny, nx, prm, s)
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
