// Fused MOOD acceptance check, hand-written for Hopper as a tile kernel.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_mood_check (apply_mood,
// src/mood.cc:290-491, as one pass over planes).  Inputs: the candidate's
// density planes (mode 0, D2xx = mode 2, D2yy = mode 2p+1, read straight
// from the [4, K, ny, nx] candidate), the predictor's DMP bounds, the
// degree map (int32) and the limiter marks (bytes).  Per cell: DMP on the
// mean (+-1e-6), Diot's u2 smoothness (plus-stencil min/max of each D2:
// same sign and comparable, or both below 1e-12); a failing cell of degree
// > 1 drops one degree, a failing degree-1 cell is marked for the limiter,
// a failing degree-1 cell already marked spreads the reduction to its face
// neighbors.  Outputs deg_new, lim_new and chg (the cells whose degree
// dropped).
//
// A cell's result depends on cells up to two rows or columns away (the
// spread reads the neighbors' fail flags, whose u2 test reads their
// neighbors' D2).  Neighbors wrap only on periodic sides: off-domain halo
// cells are neither tested nor spread from, and the validity of every
// neighbor arm follows the global edges (map_axis; the trap of 2561b31,
// where a wrapping spread silently stopped the cascade).
//
// What bounds it on the H100: bytes, seven planes in (25 B a cell in f32)
// and three out (6 B) with a few comparisons per cell: 10.3 MB, 3.1 us at
// the 1152 x 288 DMR.  At that size its time is latency: a phase timeline
// (%globaltimer per block) put the staging at 4.1-4.3 us, the flags at
// 1.5-1.7 us and the writes at 0.6 us of an 8.5-8.7 us span on 16 x 64
// and 8 x 64 tiles, every block in one wave.
//
// What the tile design does about it: one block of TNT threads per wide
// tile of CHECK_TY x CHECK_TX = 16 x 64 cells (ops/kernels.CHECK_TILE; the
// columns a multiple of 16, a byte plane's vector), each thread taking runs
// of four consecutive cells along x.
//  1. Stage once with cp.async, every plane in 16-byte vectors where its
//     rows allow (the edges and wrapped columns element by element): rho0,
//     dmin, dmax, deg and lim on the tile and a one-cell ring, the two D2
//     planes with a two-cell halo (at 16 x 64 the ring reads 1.16x and the
//     halo 1.33x the tile's cells, against the 32 x 4 tiles' 1.6x and
//     2.25x).
//  2. The fail and spread flags of the tile and its ring (no corners) into
//     shared memory, from the staged planes alone, a run of four cells a
//     thread (one vector load a row of each plane; runs off the domain's
//     edges without the edge tests), the ring's columns cell by cell.
//  3. Each run of four cells: its fail flag, the neighbours' spread flags,
//     its staged deg and lim; deg_new, lim_new and chg stored as vectors.
// One round of loads and two barriers.  The decisions are the plain
// version's (the IEEE comparisons in its order; min and max as it takes
// them, up to the sign of a zero, which no test reads), so kernel and plain
// version agree bitwise.
//
// The per-cell kernel (cell_check_kernel: a thread per cell on a BY x BX
// block, the D2 planes staged with a two-cell halo, the flags on a one-cell
// ring, each ring cell's other planes read from global memory) stays for
// the dtypes a build-time cap names (DFLO_CHECK_PER_CELL_F32 / _F64:
// float64, where the tile kernel ran 56 % slower on the H100).
#include <stdint.h>

#include <type_traits>

#include "tile.cuh"

namespace dflo {

constexpr double DMP_EPS = 1.0e-6;   // stab/mood.DMP_EPS
constexpr double U2_EPS = 0.5;       // stab/mood.U2_EPS
constexpr double U2_TINY = 1.0e-12;  // stab/mood.U2_TINY

// global index g of an n-long axis, wrapped when periodic; false when it
// lies off the domain
__device__ __forceinline__ bool map_axis(int& g, int n, bool periodic) {
  if (g >= 0 && g < n) return true;
  if (!periodic) return false;
  g = ((g % n) + n) % n;
  return true;
}

// min and max of one precision (fminf / fmin)
__device__ __forceinline__ float fmin_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_t(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fmax_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_t(double a, double b) { return fmax(a, b); }

// Diot's u2 test of one D2 plane at a cell of value a0 whose W, E, S, N
// neighbours count where vW, vE, vS, vN (stab/mood.u2_ok): over the plus
// stencil, min and max share a sign and are comparable, or both are below
// U2_TINY.  A NaN among the counted values fails it, as the plain version's
// NaN-propagating min and max do; without one, fmin and fmax give the same
// min and max up to the sign of a zero, which neither |mn|, |mx| nor
// mn * mx >= 0 sees, so the test decides as the plain version's.
template <typename T>
__device__ __forceinline__ bool u2_ok(T a0, T w, T e, T s, T n, bool vW,
                                      bool vE, bool vS, bool vN) {
  const bool nan = (a0 != a0) || (vW && w != w) || (vE && e != e) ||
                   (vS && s != s) || (vN && n != n);
  T mn = a0, mx = a0;
  if (vW) { mn = fmin_t(mn, w); mx = fmax_t(mx, w); }
  if (vE) { mn = fmin_t(mn, e); mx = fmax_t(mx, e); }
  if (vS) { mn = fmin_t(mn, s); mx = fmax_t(mx, s); }
  if (vN) { mn = fmin_t(mn, n); mx = fmax_t(mx, n); }
  const T amn = fabs(mn), amx = fabs(mx);
  const bool flat = fmax_t(amn, amx) < T(U2_TINY);
  return !nan &&
         (flat || ((mn * mx >= T(0)) && (amn >= amx * T(1.0 - U2_EPS))));
}

// In float32 the hardware's NaN-propagating min and max (min.NaN, max.NaN)
// are the plain version's torch.minimum and torch.maximum up to the sign of
// a zero, so no NaN test is needed.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <>
__device__ __forceinline__ bool u2_ok<float>(float a0, float w, float e,
                                             float s, float n, bool vW,
                                             bool vE, bool vS, bool vN) {
  float mn = a0, mx = a0;
  if (vW) { mn = min_nan(mn, w); mx = max_nan(mx, w); }
  if (vE) { mn = min_nan(mn, e); mx = max_nan(mx, e); }
  if (vS) { mn = min_nan(mn, s); mx = max_nan(mx, s); }
  if (vN) { mn = min_nan(mn, n); mx = max_nan(mx, n); }
  const float amn = fabsf(mn), amx = fabsf(mx);
  const bool flat = max_nan(amn, amx) < float(U2_TINY);
  return flat || ((mn * mx >= 0.0f) && (amn >= amx * float(1.0 - U2_EPS)));
}

// the DMP test of a cell's mean rho against its bounds (+-DMP_EPS)
template <typename T>
__device__ __forceinline__ bool dmp_ok(T rho, T lo, T hi) {
  return (rho - lo > -T(DMP_EPS)) && (rho - hi < T(DMP_EPS));
}

// four consecutive values of a staged plane (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  const double2 r = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = r.x;
  v[3] = r.y;
}

// the operands of one launch; vec: bit i set where staged plane i (rho0,
// dmin, dmax, D2xx, D2yy, deg, lim) may be read in 16-byte vectors, bit 7
// where the outputs may be written in vectors of four cells
template <typename T>
struct CheckArgs {
  const T *rho0, *dmin, *dmax, *d2a, *d2b;
  const int* deg;
  const uint8_t* lim;
  int* deg_out;
  uint8_t *lim_out, *chg_out;
  int ny, nx, per_x, per_y, vec;
  T avg0;
};

// A staged plane's rows: a halo of H cells around the tile's TX columns,
// the column x0 at element V (the elements of one 16-byte vector), so that
// the tile's vectors land 16-byte aligned; the pitch TX + 2V
template <typename E>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(E);
}

template <typename E>
__host__ __device__ constexpr int plane_pitch(int tx) {
  return tx + 2 * vec_elems<E>();
}

// The geometry of a check tile and its dynamic shared memory: byte offsets
// of the staged planes D2 [2][TY + 4][pitch] (halo 2), RHO, DMIN, DMAX
// [TY + 2][pitch] (halo 1), DEG (int) and LIM (bytes) [TY + 2][pitch] and
// the flags FAIL, SPREAD [TY + 2][TX + 8] (column rx at rx + 3), each region
// 16-byte aligned.
// ops/kernels.check_smem mirrors it.
struct CheckGeo {
  int TY, TX, ntx, nty, bD2, bRHO, bMIN, bMAX, bDEG, bLIM, bFAIL, bSPR, bytes;
};

inline int align16(int b) { return (b + 15) & ~15; }

inline CheckGeo check_geo(int tsize, int ty, int tx, int ny, int nx) {
  CheckGeo g{};
  g.TY = ty;
  g.TX = tx;
  g.ntx = (nx + tx - 1) / tx;
  g.nty = (ny + ty - 1) / ty;
  const int pt = tx + 2 * (16 / tsize), rows = ty + 2;
  int b = 0;
  g.bD2 = b;   b += align16(2 * (ty + 4) * pt * tsize);
  g.bRHO = b;  b += align16(rows * pt * tsize);
  g.bMIN = b;  b += align16(rows * pt * tsize);
  g.bMAX = b;  b += align16(rows * pt * tsize);
  g.bDEG = b;  b += align16(rows * plane_pitch<int>(tx) * 4);
  g.bLIM = b;  b += align16(rows * plane_pitch<uint8_t>(tx));
  g.bFAIL = b; b += align16(rows * (tx + 8));
  g.bSPR = b;  b += align16(rows * (tx + 8));
  g.bytes = b;
  return g;
}

// one element from global to shared memory: cp.async for 4 and 8 bytes, a
// load and a store for a byte (cp.async moves 4, 8 or 16)
template <typename E>
__device__ __forceinline__ void copy_elem(E* dst, const E* src) {
  if constexpr (sizeof(E) >= 4)
    copy_async(dst, src);
  else
    *dst = __ldg(src);
}

// Stage the plane src [ny, nx] over the tile's rows and columns with a
// halo of H cells into dst [TY + 2H][pitch] (column x0 at element V):
// rows and columns wrapped where periodic and left out where off the
// domain or beyond what a grid cell reads (H past the grid's last row and
// column); a vector of V elements where vec allows it and it lies in the
// grid, the rest element by element.
template <typename E, typename T>
__device__ __forceinline__ void stage_plane(E* dst, const E* __restrict__ src,
                                            int H, bool vec,
                                            const CheckArgs<T>& a, int y0,
                                            int x0, int TY, int TX) {
  constexpr int V = vec_elems<E>();
  const int P = plane_pitch<E>(TX), nch = TX / V, per_row = nch + 2 * H;
  const int ny = a.ny, nx = a.nx;
  const FDiv dr(per_row);
  for (int i = threadIdx.x; i < (TY + 2 * H) * per_row; i += TNT) {
    const int r = dr.q(i), k = i - r * per_row;
    int gy = y0 + r - H;
    if (gy > ny - 1 + H || !map_axis(gy, ny, a.per_y)) continue;
    E* drow = dst + r * P + V;
    const E* srow = src + (long)gy * nx;
    if (k < nch) {
      const int gx = x0 + k * V;
      if (vec && gx + V <= nx) {
        copy_async16(drow + k * V, srow + gx);
        continue;
      }
      for (int e = 0; e < V; ++e) {
        int g = gx + e;
        if (g > nx - 1 + H) break;
        if (map_axis(g, nx, a.per_x)) copy_elem(drow + k * V + e, srow + g);
      }
    } else {
      const int j = k - nch, col = j < H ? j - H : TX + j - H;
      int g = x0 + col;
      if (g <= nx - 1 + H && map_axis(g, nx, a.per_x))
        copy_elem(drow + col, srow + g);
    }
  }
}

template <typename T>
__device__ __forceinline__ void tile_check(const CheckArgs<T>& a,
                                           const CheckGeo& g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TY = g.TY, TX = g.TX, tid = threadIdx.x, ny = a.ny, nx = a.nx;
  const int y0 = (blockIdx.x / g.ntx) * TY, x0 = (blockIdx.x % g.ntx) * TX;
  const bool per_x = a.per_x != 0, per_y = a.per_y != 0;
  constexpr int VT = vec_elems<T>();
  const int PT = plane_pitch<T>(TX), PI = plane_pitch<int>(TX);
  const int PB = plane_pitch<uint8_t>(TX), PF = TX + 8;
  T* sD2 = reinterpret_cast<T*>(smem + g.bD2);
  T* sRHO = reinterpret_cast<T*>(smem + g.bRHO);
  T* sMIN = reinterpret_cast<T*>(smem + g.bMIN);
  T* sMAX = reinterpret_cast<T*>(smem + g.bMAX);
  int* sDEG = reinterpret_cast<int*>(smem + g.bDEG);
  uint8_t* sLIM = smem + g.bLIM;
  uint8_t* sFAIL = smem + g.bFAIL;
  uint8_t* sSPR = smem + g.bSPR;

  // ---- 1. stage every plane once ------------------------------------------
  stage_plane(sD2, a.d2a, 2, a.vec & 8, a, y0, x0, TY, TX);
  stage_plane(sD2 + (TY + 4) * PT, a.d2b, 2, a.vec & 16, a, y0, x0, TY,
                  TX);
  stage_plane(sRHO, a.rho0, 1, a.vec & 1, a, y0, x0, TY, TX);
  stage_plane(sMIN, a.dmin, 1, a.vec & 2, a, y0, x0, TY, TX);
  stage_plane(sMAX, a.dmax, 1, a.vec & 4, a, y0, x0, TY, TX);
  stage_plane(sDEG, a.deg, 1, a.vec & 32, a, y0, x0, TY, TX);
  stage_plane(sLIM, a.lim, 1, a.vec & 64, a, y0, x0, TY, TX);
  copy_async_wait();
  __syncthreads();

  // ---- 2. fail and spread flags on the tile and its ring (no corners):
  // runs of four cells of a row (the tile's columns), then the ring's two
  // columns cell by cell; a flag (ry, rx) at FLAG + ry * PF + rx + 3, so that
  // a run's four flags are one aligned word
  const int nrun = TX / 4, nruns = (TY + 2) * nrun;
  const FDiv dRun(nrun);
  for (int i = tid; i < nruns + 2 * TY; i += TNT) {
    if (i >= nruns) {   // a ring column's cell of tile row ry
      const int j = i - nruns, ry = 1 + (j >> 1), rx = (j & 1) ? TX + 1 : 0;
      int gy = y0 + ry - 1, gx = x0 + rx - 1;
      if (gy > ny || gx > nx) continue;   // no grid cell reads it
      uint8_t fail = 0, spread = 0;
      if (map_axis(gy, ny, per_y) && map_axis(gx, nx, per_x)) {
        const bool vW = per_x || gx > 0, vE = per_x || gx < nx - 1;
        const bool vS = per_y || gy > 0, vN = per_y || gy < ny - 1;
        bool ok = true;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          // the cell in the two-cell-halo planes: row ry + 1, column rx - 1
          const T* c = sD2 + pl * (TY + 4) * PT + (ry + 1) * PT + VT + rx - 1;
          ok = ok && u2_ok(c[0], c[-1], c[1], c[-PT], c[PT], vW, vE, vS, vN);
        }
        const int o = ry * PT + VT + rx - 1;
        fail = !(dmp_ok(a.avg0 * sRHO[o], sMIN[o], sMAX[o]) || ok);
        spread = fail && sDEG[ry * PI + 4 + rx - 1] == 1 &&
                 sLIM[ry * PB + 16 + rx - 1] != 0;
      }
      sFAIL[ry * PF + rx + 3] = fail;
      sSPR[ry * PF + rx + 3] = spread;
      continue;
    }
    const int ry = dRun.q(i), m = i - ry * nrun;
    int gy = y0 + ry - 1;
    if (gy > ny) continue;   // no grid cell reads it
    uchar4 fail4 = make_uchar4(0, 0, 0, 0), spread4 = fail4;
    // the run's flags; INNER: a run off the domain's edges, where every cell
    // and neighbour counts (most runs: the conditions fold away)
    auto run = [&](auto inner) {
      constexpr bool INNER = decltype(inner)::value;
      bool vS = true, vN = true, in[4], vW[4], vE[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) in[e] = vW[e] = vE[e] = true;
      if constexpr (!INNER) {
        vS = per_y || gy > 0;
        vN = per_y || gy < ny - 1;
        // the run's cells x0 + 4m + e: mapped, and their x neighbours' flags
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int gx = x0 + 4 * m + e;
          in[e] = gx <= nx && map_axis(gx, nx, per_x);
          vW[e] = per_x || gx > 0;
          vE[e] = per_x || gx < nx - 1;
        }
      }
      bool ok[4] = {true, true, true, true};
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        // the run in the two-cell-halo planes: row ry + 1, column 4m
        const T* c = sD2 + pl * (TY + 4) * PT + (ry + 1) * PT + VT + 4 * m;
        // the row from column 4m - 1 to 4m + 4, the rows above and below
        T mid[4], up[4], dn[4];
        load4(c, mid);
        load4(c - PT, up);
        load4(c + PT, dn);
        const T row[6] = {c[-1], mid[0], mid[1], mid[2], mid[3], c[4]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ok[e] = ok[e] & u2_ok(row[e + 1], row[e], row[e + 2], up[e],
                                dn[e], vW[e], vE[e], vS, vN);
      }
      // the run in the one-cell-halo planes: row ry, column 4m
      const int o = ry * PT + VT + 4 * m;
      T rho[4], lo[4], hi[4];
      load4(sRHO + o, rho);
      load4(sMIN + o, lo);
      load4(sMAX + o, hi);
      const int4 d4 = *reinterpret_cast<const int4*>(sDEG + ry * PI + 4 + 4 * m);
      const uchar4 l4 =
          *reinterpret_cast<const uchar4*>(sLIM + ry * PB + 16 + 4 * m);
      const int dg[4] = {d4.x, d4.y, d4.z, d4.w};
      const int lm[4] = {l4.x, l4.y, l4.z, l4.w};
      int f[4], sp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = in[e] && !(dmp_ok(a.avg0 * rho[e], lo[e], hi[e]) || ok[e]);
        sp[e] = f[e] && dg[e] == 1 && lm[e] != 0;
      }
      fail4 = make_uchar4(f[0], f[1], f[2], f[3]);
      spread4 = make_uchar4(sp[0], sp[1], sp[2], sp[3]);
    };
    if (gy > 0 && gy < ny - 1 && x0 + 4 * m > 0 && x0 + 4 * m + 4 < nx)
      run(std::true_type{});
    else if (map_axis(gy, ny, per_y))
      run(std::false_type{});
    *reinterpret_cast<uchar4*>(sFAIL + ry * PF + 4 + 4 * m) = fail4;
    *reinterpret_cast<uchar4*>(sSPR + ry * PF + 4 + 4 * m) = spread4;
  }
  __syncthreads();

  // ---- 3. each run of four cells: the bookkeeping, stored as vectors ----
  for (int q = tid; q < TY * nrun; q += TNT) {
    const int ly = dRun.q(q), lx0 = 4 * (q - ly * nrun);
    const int y = y0 + ly, x = x0 + lx0;
    if (y >= ny || x >= nx) continue;
    const bool vS = per_y || y > 0, vN = per_y || y < ny - 1;
    // the run's flags (row ly + 1), its neighbours' spread flags
    const int f = (ly + 1) * PF + 4 + lx0;
    const uchar4 fl4 = *reinterpret_cast<const uchar4*>(sFAIL + f);
    const uchar4 sc4 = *reinterpret_cast<const uchar4*>(sSPR + f);
    const uchar4 su4 = *reinterpret_cast<const uchar4*>(sSPR + f - PF);
    const uchar4 sd4 = *reinterpret_cast<const uchar4*>(sSPR + f + PF);
    const int4 d4 =
        *reinterpret_cast<const int4*>(sDEG + (ly + 1) * PI + 4 + lx0);
    const uchar4 l4 =
        *reinterpret_cast<const uchar4*>(sLIM + (ly + 1) * PB + 16 + lx0);
    const int fl[4] = {fl4.x, fl4.y, fl4.z, fl4.w};
    const int sc[6] = {sSPR[f - 1], sc4.x, sc4.y, sc4.z, sc4.w, sSPR[f + 4]};
    const int su[4] = {su4.x, su4.y, su4.z, su4.w};
    const int sd[4] = {sd4.x, sd4.y, sd4.z, sd4.w};
    const int dg[4] = {d4.x, d4.y, d4.z, d4.w};
    const int lm[4] = {l4.x, l4.y, l4.z, l4.w};
    int dn[4], ln[4], cn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xe = x + e;
      const bool vW = per_x || xe > 0, vE = per_x || xe < nx - 1;
      const bool fail = fl[e] != 0;
      const int d = dg[e];
      const bool l = lm[e] != 0;
      const bool red_self = fail && d > 1;
      const bool mark_self = fail && d == 1 && !l;
      const bool nb = sc[e + 1] || (vW && sc[e]) || (vE && sc[e + 2]) ||
                      (vS && su[e]) || (vN && sd[e]);
      const bool red_nb = nb && d > 1 && !red_self;
      const bool mark_nb = nb && d == 1 && !l && !mark_self;
      const bool chg = red_self || red_nb;
      dn[e] = d - (chg ? 1 : 0);
      ln[e] = l || mark_self || mark_nb;
      cn[e] = chg;
    }
    const long cell = (long)y * nx + x;
    if ((a.vec & 128) && x + 4 <= nx) {
      *reinterpret_cast<int4*>(a.deg_out + cell) =
          make_int4(dn[0], dn[1], dn[2], dn[3]);
      *reinterpret_cast<uchar4*>(a.lim_out + cell) =
          make_uchar4(ln[0], ln[1], ln[2], ln[3]);
      *reinterpret_cast<uchar4*>(a.chg_out + cell) =
          make_uchar4(cn[0], cn[1], cn[2], cn[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (x + e < nx) {
          a.deg_out[cell + e] = dn[e];
          a.lim_out[cell + e] = ln[e];
          a.chg_out[cell + e] = cn[e];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TNT)
tile_check_kernel(const CheckArgs<T> a, const CheckGeo g) {
  tile_check<T>(a, g);
}

// the per-cell check: a thread per cell on a BY x BX block
template <typename T>
__global__ void __launch_bounds__(BX * BY)
cell_check_kernel(const T* __restrict__ u, int K, int p,
                  const T* __restrict__ dmin, const T* __restrict__ dmax,
                  const int* __restrict__ deg, const uint8_t* __restrict__ lim,
                  int* __restrict__ deg_out, uint8_t* __restrict__ lim_out,
                  uint8_t* __restrict__ chg_out, int ny, int nx, int per_x,
                  int per_y, T avg0) {
  __shared__ T s_d2[2][BY + 4][BX + 4];
  __shared__ uint8_t s_fail[BY + 2][BX + 2];
  __shared__ uint8_t s_spread[BY + 2][BX + 2];
  const long plane = (long)ny * nx;
  const T* rho0 = u + (long)(RHO * K) * plane;
  const T* d2[2] = {u + (long)(RHO * K + 2) * plane,
                    u + (long)(RHO * K + 2 * p + 1) * plane};
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;

  // ---- D2 planes on the tile with a two-cell halo ---------------------------
  for (int i = tid; i < (BY + 4) * (BX + 4); i += BX * BY) {
    const int wy = i / (BX + 4), wx = i % (BX + 4);
    int gy = y0 + wy - 2, gx = x0 + wx - 2;
    const bool ok = map_axis(gy, ny, per_y) && map_axis(gx, nx, per_x);
    const long g = (long)gy * nx + gx;
    s_d2[0][wy][wx] = ok ? __ldg(d2[0] + g) : T(0);
    s_d2[1][wy][wx] = ok ? __ldg(d2[1] + g) : T(0);
  }
  __syncthreads();

  // ---- fail and spread flags on the tile and a one-cell ring ---------------
  const T inf = T(INFINITY);
  for (int i = tid; i < (BY + 2) * (BX + 2); i += BX * BY) {
    const int ry = i / (BX + 2), rx = i % (BX + 2);
    int gy = y0 + ry - 1, gx = x0 + rx - 1;
    uint8_t fail = 0, spread = 0;
    if (map_axis(gy, ny, per_y) && map_axis(gx, nx, per_x)) {
      const bool vW = per_x || gx > 0, vE = per_x || gx < nx - 1;
      const bool vS = per_y || gy > 0, vN = per_y || gy < ny - 1;
      const int cy = ry + 1, cx = rx + 1;   // in the two-cell-halo window
      bool ok = true;
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const T a = s_d2[pl][cy][cx];
        T mn = a, mx = a;
        mn = nmin(mn, vW ? s_d2[pl][cy][cx - 1] : inf);
        mn = nmin(mn, vE ? s_d2[pl][cy][cx + 1] : inf);
        mn = nmin(mn, vS ? s_d2[pl][cy - 1][cx] : inf);
        mn = nmin(mn, vN ? s_d2[pl][cy + 1][cx] : inf);
        mx = nmax(mx, vW ? s_d2[pl][cy][cx - 1] : -inf);
        mx = nmax(mx, vE ? s_d2[pl][cy][cx + 1] : -inf);
        mx = nmax(mx, vS ? s_d2[pl][cy - 1][cx] : -inf);
        mx = nmax(mx, vN ? s_d2[pl][cy + 1][cx] : -inf);
        const T amn = fabs(mn), amx = fabs(mx);
        const bool flat = nmax(amn, amx) < T(U2_TINY);
        ok = ok && (flat || ((mn * mx >= T(0)) &&
                             (amn >= amx * T(1.0 - U2_EPS))));
      }
      const long g = (long)gy * nx + gx;
      const T rho = avg0 * __ldg(rho0 + g);
      const bool dmp = (rho - __ldg(dmin + g) > -T(DMP_EPS)) &&
                       (rho - __ldg(dmax + g) < T(DMP_EPS));
      fail = !(dmp || ok);
      spread = fail && __ldg(deg + g) == 1 && lim[g] != 0;
    }
    s_fail[ry][rx] = fail;
    s_spread[ry][rx] = spread;
  }
  __syncthreads();

  // ---- this cell's bookkeeping ---------------------------------------------
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long cell = (long)y * nx + x;
  const int ry = threadIdx.y + 1, rx = threadIdx.x + 1;
  const bool vW = per_x || x > 0, vE = per_x || x < nx - 1;
  const bool vS = per_y || y > 0, vN = per_y || y < ny - 1;
  const bool fail = s_fail[ry][rx] != 0;
  const int d = deg[cell];
  const bool l = lim[cell] != 0;
  const bool red_self = fail && d > 1;
  const bool mark_self = fail && d == 1 && !l;
  const bool nb = s_spread[ry][rx] || (vW && s_spread[ry][rx - 1]) ||
                  (vE && s_spread[ry][rx + 1]) || (vS && s_spread[ry - 1][rx]) ||
                  (vN && s_spread[ry + 1][rx]);
  const bool red_nb = nb && d > 1 && !red_self;
  const bool mark_nb = nb && d == 1 && !l && !mark_self;
  const bool chg = red_self || red_nb;
  deg_out[cell] = d - (chg ? 1 : 0);
  lim_out[cell] = l || mark_self || mark_nb;
  chg_out[cell] = chg;
}

// The check's tile (ops/kernels.CHECK_TILE mirrors it): the fastest on the
// DMR (1152 x 288) in float32 in the tile sweep on the H100 (kernel_ab.py,
// PERF.md).
constexpr int CHECK_TY = 16, CHECK_TX = 64;
static_assert(CHECK_TX % 16 == 0, "a tile row is whole byte vectors");

// the dtypes whose check runs its per-cell kernel (cell_check_kernel):
// float64, where the tile kernel ran slower on the H100 (kernel_ab.py,
// PERF.md); every other the tile kernel.  A choice made at build time
// (ops/kernels.CHECK_PER_CELL mirrors it); kernel_ab.py builds the library
// with other values, -DDFLO_CHECK_PER_CELL_F32=... and _F64, to time both
// kernels in a dtype.
#ifndef DFLO_CHECK_PER_CELL_F32
#define DFLO_CHECK_PER_CELL_F32 0
#endif
#ifndef DFLO_CHECK_PER_CELL_F64
#define DFLO_CHECK_PER_CELL_F64 1
#endif
template <typename T>
constexpr bool CHECK_PER_CELL =
    sizeof(T) > 4 ? DFLO_CHECK_PER_CELL_F64 : DFLO_CHECK_PER_CELL_F32;

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
static int launch(const void* u, int K, int p, const void* dmin,
                  const void* dmax, const void* deg, const void* lim,
                  void* deg_out, void* lim_out, void* chg_out, int ny, int nx,
                  int per_x, int per_y, double avg0, cudaStream_t stream) {
  if (ny < 1 || nx < 1) return 0;
  if constexpr (CHECK_PER_CELL<T>) {
    cell_check_kernel<T><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
        (const T*)u, K, p, (const T*)dmin, (const T*)dmax, (const int*)deg,
        (const uint8_t*)lim, (int*)deg_out, (uint8_t*)lim_out,
        (uint8_t*)chg_out, ny, nx, per_x, per_y, T(avg0));
    return (int)cudaGetLastError();
  } else {
    const CheckGeo g =
        check_geo((int)sizeof(T), CHECK_TY, CHECK_TX, ny, nx);
    if (g.bytes > MAX_SMEM) return -1;
    const long plane = (long)ny * nx;
    const T* ut = (const T*)u;
    const T* planes[5] = {ut + (long)(RHO * K) * plane, (const T*)dmin,
                          (const T*)dmax, ut + (long)(RHO * K + 2) * plane,
                          ut + (long)(RHO * K + 2 * p + 1) * plane};
    // a plane's rows are vectors where its row length and its start are
    int vec = 0;
    for (int i = 0; i < 5; ++i)
      vec |= (nx % vec_elems<T>() == 0 && aligned16(planes[i])) << i;
    vec |= (nx % 4 == 0 && aligned16(deg)) << 5;
    vec |= (nx % 16 == 0 && aligned16(lim)) << 6;
    vec |= (nx % 4 == 0 && aligned16(deg_out) &&
            ((uintptr_t)lim_out & 3) == 0 && ((uintptr_t)chg_out & 3) == 0)
           << 7;
    const CheckArgs<T> a{planes[0], planes[1], planes[2], planes[3],
                         planes[4], (const int*)deg, (const uint8_t*)lim,
                         (int*)deg_out, (uint8_t*)lim_out, (uint8_t*)chg_out,
                         ny, nx, per_x, per_y, vec, T(avg0)};
    return launch_tile_kernel(tile_check_kernel<T>, g.ntx * g.nty, g.bytes,
                              stream, a, g);
  }
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 2..6 (the u2 test reads the D2
// modes 2 and 2p+1 of the K = (p+1)(p+2)/2; below p = 2 the reference has
// no check kernel and runs its plain check with the u2 test off).  lim,
// lim_out and chg_out hold one byte (0/1) per cell.  The dtypes of
// CHECK_PER_CELL on the per-cell kernel, the others on CHECK_TY x CHECK_TX
// tiles.  Returns cudaGetLastError() after the launch, -1 for an
// unsupported case.
extern "C" int dflo_fused_mood_check(int dtype, int p, const void* u,
                                     const void* dmin, const void* dmax,
                                     const void* deg, const void* lim,
                                     void* deg_out, void* lim_out,
                                     void* chg_out, int ny, int nx, int per_x,
                                     int per_y, double avg0, void* stream) {
  if (p < 2 || p > 6) return -1;
  const int K = (p + 1) * (p + 2) / 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dflo::launch<float>(u, K, p, dmin, dmax, deg, lim, deg_out, lim_out,
                               chg_out, ny, nx, per_x, per_y, avg0, s);
  if (dtype == 1)
    return dflo::launch<double>(u, K, p, dmin, dmax, deg, lim, deg_out,
                                lim_out, chg_out, ny, nx, per_x, per_y, avg0,
                                s);
  return -1;
}

// The dynamic shared memory in bytes of one tile block (dtype as above): 0
// for the per-cell kernel, -1 for another dtype.  For the build's report
// and the check of ops/kernels.check_smem (chip_smoke.py phase 1).
extern "C" int dflo_mood_check_smem(int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype ? dflo::CHECK_PER_CELL<double> : dflo::CHECK_PER_CELL<float>)
    return 0;
  return dflo::check_geo(dtype ? 8 : 4, dflo::CHECK_TY, dflo::CHECK_TX, 1, 1)
      .bytes;
}
