// Fused stabilization chain of one RK stage, hand-written for Hopper as a
// tile kernel.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_post (the single-chip
// kernel, with and without its diag outputs), masked or not, and the
// per-device kernel of make_fused_post_sharded (pallas_kernels.py:1536-1652,
// the block form below).  Per cell, in this order: its cell average and its
// four neighbors' averages; the KXRCF jump of the indicator variable across
// its faces (pallas_kernels.py:1290-1323), or with the `limiter` indicator
// every cell marked (:1158-1160); the characteristic TVB limiter with
// minmod, Mdx2 and the change > 1e-10 gate (:1325-1365); Zhang-Shu
// positivity with the dtype-aware floors (:1367-1425); with diag, the CFL
// wave speed and min(rho, p) of the cell average (the chain preserves cell
// means), reduced per tile with NaN-propagating max/min into partials that
// the wrapper reduces with torch.amax/amin (:1527).  Neighbor-exists flags
// come from edge arithmetic (:1277-1288): a cell off the block's border
// always has its neighbor, a border cell has one where the argument nb_w /
// nb_e / nb_s / nb_n says so (the periodic flags on one device; under a
// device mesh, 0 only at a true, non-periodic domain edge, the runtime edge
// flags of :1599-1609); on a masked domain the static flag plane vflags
// [5, ny, nx] (uint8: the W, E, S, N fluid-neighbor flags and the cell's
// own fluid flag, :1135-1151) gives them instead; a solid cell enters
// neither diag reduction (:1442-1447).
//
// The block form (one block of a domain split over a device mesh): the
// neighbor DoF lines across the block's four borders come in as halo lines
// hW, hE [4, K, ny] and hS, hN [4, K, nx] (the neighbor blocks' edge
// columns and rows).  A ring cell across the block's border is staged from
// the halo line where one is given, so the border cell computes the same
// neighbor average and trace from the same numbers in the same order as on
// one device, and the sharded post equals the single-device post bitwise.
// A null halo pointer keeps the block wrap (one device, or a true domain
// edge, where the edge flag switches the neighbor off).
//
// What bounds it on the H100: bytes at Q1-Q2 (the state read once and
// written once; a cell's chain is a few hundred operations), the positivity
// points' products beyond (QP x 4 x K multiply-adds a cell, 4,000 at Q4).
//
// What the tile design does about it: one block of TNT threads per tile of
// TY x TX cells (ops/kernels.post_tile sizes it from the degree and the
// dtype: the largest whose shared memory leaves room for two blocks per SM
// in float32, for the one block per SM of the float64 kernel in float64).
//  1. Stage once: the transposed positivity points, the tile's DoFs and its
//     one-cell ring (the corners, which no cell reads, left out) go to
//     shared memory, a ring cell across the block's border from its halo
//     line, with the tile cells' five flag bytes on a masked domain.
//  2. Averages, traces and gradients once: the average of every staged
//     cell, the indicator variable's four face traces of every tile cell
//     and the one facing trace of each ring cell, and the mean derivatives
//     GX, GY of every tile cell, each an ordered sum over k, as register
//     tiles in one pass.
//  3. The chain, two threads per tile cell, the x and the y half of KXRCF
//     and the TVB slopes (chain_half), their parts exchanged across the
//     pair and summed in the plain version's order (chain_gate), the
//     neighbours' averages and traces read from shared memory; the linear
//     rebuild written back to the staged planes.
//  4. Zhang-Shu with the positivity points' products as register tiles of
//     points x cells (tile.cuh tile_thetas, then tile_scale: every DoF
//     about the mean), then the tile written out coalesced along x.
//  5. The diag reduced per tile (tile.cuh tile_diag): one partial a tile.
// Degrees 1-3 have an instantiation each (euler.cuh BDims); degrees 4-6 share
// the general dims (GDims: sizes at run time), which size nothing but shared
// memory: no per-thread cell arrays.  Float32 Q1-Q2 and float64 Q1 take
// the per-cell kernel instead (cell_post_kernel: the cell in registers, its
// neighbours read through L1): at K <= 9 a cell's work is too small to pay
// for the tile's barriers, and the tile form ran 7-160 % slower there on
// the H100 (float64 Q2 40 % faster: kernel_ab.py, PERF.md);
// ops/kernels.post_tile gives those forms the BY x BX block as their tile.
//
// The chain follows stab/indicator, stab/limiter and stab/positivity
// operation by operation.  Every quantity that feeds a threshold decision
// (KXRCF > 1, change > 1e-10, the positivity branches) is computed with the
// IEEE operations of the torch version in the same order (ordered sums, no
// contraction: every source is built with -fmad=false), so the kernel and
// the plain version take the same decisions.
#include <stdint.h>

#include "tile.cuh"

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
        GY(GX + d.K),         // [K] mean d/dy (GX, GY one [2][K] matrix)
        DRX(GY + d.K),        // [K] node x - centre
        DRY(DRX + d.K),       // [K] node y - centre
        PM(DRY + d.K) {}      // [QP][K] positivity points
};

// the operands of one launch
template <typename T>
struct PostArgs {
  const T *u, *ops, *hW, *hE, *hS, *hN;
  const uint8_t* vflags;
  T *out, *lam_part, *minq_part;
  int ny, nx;
  PostParams prm;
};

// The geometry of a post tile and its dynamic shared memory: offsets in
// elements of T of the transposed positivity points PMT [K][QPP] (with
// positivity; tile.cuh stage_points), the staged DoFs U [4][K][SS] (SS =
// (TY + 2)(TX + 2), the tile and its ring), the averages AVG [4][SS], the
// indicator traces TR [4][NQ][SS] (a tile cell on its four faces, a ring
// cell on the face it shares with the tile), the unscaled mean derivatives
// G [4][2][NC], the points' values SCR [QPP][NC] and the per-cell values
// TPS [7][NC] (with positivity); the byte offset of the flag bytes FLG
// [5][SS] (masked) after them.  ops/kernels.post_smem mirrors it.
struct PostGeo {
  int TY, TX, NC, SX, SS, ntx, nty;
  int oPMT, oU, oAVG, oTR, oG, oSCR, oTPS, bFLG, bytes;
};

inline PostGeo post_geo(int K, int NQ, int QP, int tsize, bool masked,
                        bool pos, int ty, int tx, int ny, int nx) {
  PostGeo g{};
  g.TY = ty;
  g.TX = tx;
  g.NC = ty * tx;
  g.SX = tx + 2;
  g.SS = (ty + 2) * (tx + 2);
  g.ntx = (nx + tx - 1) / tx;
  g.nty = (ny + ty - 1) / ty;
  const int QPP = pad_points(QP);
  int off = 0;
  g.oPMT = off; off += pos ? K * QPP : 0;
  g.oU = off;   off += 4 * K * g.SS;
  g.oAVG = off; off += 4 * g.SS;
  g.oTR = off;  off += 4 * NQ * g.SS;
  g.oG = off;   off += 8 * g.NC;
  g.oSCR = off; off += pos ? QPP * g.NC : 0;
  g.oTPS = off; off += pos ? 7 * g.NC : 0;
  int b = off * tsize;
  g.bFLG = b;   b += masked ? 5 * g.SS : 0;
  g.bytes = (b + 15) & ~15;
  return g;
}

// face integral of the indicator jump: sum_q wq[q] * (t(q) - tn(q)) * valid,
// an ordered sum over q, t and tn a cell's and its neighbor's traces
template <typename T, class Tr, class Tn>
__device__ __forceinline__ T face_jump(int NQ, const T* __restrict__ wq,
                                       Tr t, Tn tn, T valid) {
  T acc = __ldg(wq) * ((t(0) - tn(0)) * valid);
  for (int q = 1; q < NQ; ++q)
    acc = acc + __ldg(wq + q) * ((t(q) - tn(q)) * valid);
  return acc;
}

// sum_k op[k] * v[k] for k < n, one multiply and one add per term in k
// order (the per-cell kernel's sums)
template <typename T>
__device__ __forceinline__ T dot_len(const T* __restrict__ op, const T* v,
                                     int n) {
  T acc = op[0] * v[0];
#pragma unroll
  for (int k = 1; k < n; ++k) acc = acc + op[k] * v[k];
  return acc;
}

// load one cell's component c (the per-cell kernel)
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

// One direction's half of the chain of one cell, dir 0 the x faces (W, E)
// and slopes, dir 1 the y faces (S, N) and slopes: the KXRCF jumps across
// the two faces (src/indicator.cc:48-198), this direction's parts of the
// indicator ind and of the inflow measure meas, and the TVB slope
// (src/limiter.cc:224-370) of the direction, Dn, with its change measure
// chg.  t(f, q): the cell's own trace on face f, tn(f, q): the trace its
// neighbour across f shows it; ubA, ubB the neighbours' averages (W, E or
// S, N), D the mean derivative (times h / dx or h / dy).
template <typename T, class Tr, class Tn>
__device__ __forceinline__ void chain_half(
    const PostParams& prm, int dir, int NQ, const T* __restrict__ wq, Tr t,
    Tn tn, const T ub[4], const T ubA[4], const T ubB[4], T D[4], bool vA,
    bool vB, T& ind, T& meas, T& chg, T Dn[4]) {
  const int f = 2 * dir;
  const T fA = face_jump<T>(NQ, wq, [&](int q) { return t(f, q); },
                            [&](int q) { return tn(f, q); }, T(vA));
  const T fB = face_jump<T>(NQ, wq, [&](int q) { return t(f + 1, q); },
                            [&](int q) { return tn(f + 1, q); }, T(vB));
  const T v = (dir == 0 ? ub[MX] : ub[MY]) / ub[RHO];
  const T inA = T(-v < T(0)) * T(vA);
  const T inB = T(v < T(0)) * T(vB);
  const T len = dir == 0 ? T(prm.dy) : T(prm.dx);   // the faces' length
  ind = (inA * fA + inB * fB) * len;
  meas = (inA + inB) * len;
  T db[4], df[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    db[c] = vA ? ub[c] - ubA[c] : D[c];
    df[c] = vB ? ubB[c] - ub[c] : D[c];
  }
  chg = tvb_dir(ub, dir, D, db, df, prm.char_lim != 0, T(prm.beta),
                T(prm.Mdx2), Dn);
}

// Whether a cell takes the linear rebuild: marked by KXRCF (|ind| over
// diam_pow * meas * ubi above 1; every cell with the `limiter` indicator,
// src/indicator.cc:19-22) and its change measure above 1e-10; ind, meas and
// change summed x half first, as stab/indicator and stab/limiter do
template <typename T>
__device__ __forceinline__ bool chain_gate(const PostParams& prm, T ind,
                                           T meas, T ubi, T change) {
  const T denom = T(prm.diam_pow) * meas * ubi;
  const bool marked =
      prm.mark_all ||
      (fabs(denom) > T(0) ? fabs(ind) / (denom == T(0) ? T(1) : denom)
                          : T(0)) > T(1);
  return marked && change > T(1.0e-10);
}

template <typename T, class D>
__device__ __forceinline__ void tile_post(const PostArgs<T>& a, const D& d,
                                          const PostGeo& g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int K = d.K, NQ = d.NQ;
  const int TY = g.TY, TX = g.TX, NC = g.NC, SX = g.SX, SS = g.SS;
  const int tid = threadIdx.x, tile = blockIdx.x;
  const int ny = a.ny, nx = a.nx;
  const int y0 = (tile / g.ntx) * TY, x0 = (tile % g.ntx) * TX;
  const long plane = (long)ny * nx;
  const PostParams& prm = a.prm;
  const PostOps<D> O(d);
  const T* ops = a.ops;
  const bool masked = a.vflags != nullptr;
  T* Us = sm + g.oU;
  T* Av = sm + g.oAVG;
  T* TR = sm + g.oTR;
  T* G = sm + g.oG;
  uint8_t* Fl = smem + g.bFLG;
  const FDiv dSX(SX), dTX(TX);
  // staged index of tile cell i
  auto tile_s = [=](int i) {
    const int ly = dTX.q(i);
    return (ly + 1) * SX + i - ly * TX + 1;
  };

  // ---- 1. stage the positivity points, the tile and its ring: a ring cell
  // across the block's border from its halo line where one is given, else
  // wrapped by index; cells no tile cell reads (the corners, past the
  // grid) left out
  if (prm.pos_lim) stage_points(ops + O.PM, K, d.QP, sm + g.oPMT);
  stage_tile<T>(
      Us, SS, 4 * K,
      [&](int s, const T*& src, long& stride) {
        const int sy = dSX.q(s), gy = y0 + sy - 1, gx = x0 + s - sy * SX - 1;
        const bool oy = gy < 0 || gy >= ny, ox = gx < 0 || gx >= nx;
        if ((oy && ox) || gy > ny || gx > nx) return false;
        stride = ny;
        if (gx < 0 && a.hW != nullptr) {
          src = a.hW + gy;
        } else if (gx == nx && a.hE != nullptr) {
          src = a.hE + gy;
        } else {
          stride = nx;
          if (gy < 0 && a.hS != nullptr) {
            src = a.hS + gx;
          } else if (gy == ny && a.hN != nullptr) {
            src = a.hN + gx;
          } else {
            src = a.u + (long)wrap_index(gy, ny) * nx + wrap_index(gx, nx);
            stride = plane;
          }
        }
        return true;
      },
      [&](int s) {
        const int sy = dSX.q(s), sx = s - sy * SX;
        const int gy = y0 + sy - 1, gx = x0 + sx - 1;
        if (masked && sy >= 1 && sy <= TY && sx >= 1 && sx <= TX && gy < ny &&
            gx < nx)
#pragma unroll
          for (int f = 0; f < 5; ++f)
            Fl[f * SS + s] = __ldg(a.vflags + f * plane + (long)gy * nx + gx);
      });

  // ---- 2. averages of every staged cell as register tiles; the indicator
  // variable's traces (TR[f][q][s]: a tile cell's four faces as register
  // tiles of the one [4 NQ][K] matrix faceV, a ring cell's facing face one
  // sum each); the tile cells' mean derivatives as register tiles of [GX;
  // GY]; one pass over the four kinds of work
  {
    const int comp = prm.comp;
    const int nrb = (4 * NQ + RB - 1) / RB, ncb = (NC + CB - 1) / CB;
    const int ga = avg_groups(SS);             // the averages' tiles
    const int gt = nrb * ncb;                  // the tile's trace tiles
    // the ring's facing traces: per side (0 W, column 0; 1 E, column
    // TX + 1; 2 S, row 0; 3 N, row TY + 1) the register tiles of its face
    // facing the tile, NQ rows x the side's cells
    const int nqb = (NQ + RB - 1) / RB;
    const int gx = nqb * ((TY + CB - 1) / CB), gy = nqb * ((TX + CB - 1) / CB);
    const int gr = 2 * gx + 2 * gy;
    const int gg = 4 * ncb;                    // the gradients' tiles
    for (int g1 = tid; g1 < ga + gt + gr + gg; g1 += TNT) {
      if (g1 < ga) {
        avg_group<T>(d, ops + O.AVG, Us, SS, Av, g1);
        continue;
      }
      const int g0 = g1 - ga;
      if (g0 < gt) {
        // component comp's groups of the four-component product
        row_group<RB, CB, T>(
            d, ops, 4 * NQ, Us, SS, NC, tile_s,
            [=](int, int r, int, int s) { return r * SS + s; }, TR,
            comp * gt + g0);
      } else if (g0 < gt + gr) {
        int h = g0 - gt, side = 0;
        while (h >= (side < 2 ? gx : gy)) h -= side++ < 2 ? gx : gy;
        const int f = side ^ 1;   // W ring: E face, E: W, S: N, N: S
        const int s0 = side == 0 ? SX : side == 1 ? SX + TX + 1
                     : side == 2 ? 1 : (TY + 1) * SX + 1;
        const int step = side < 2 ? SX : 1;
        // component comp's groups of the face's product
        row_group<RB, CB, T>(
            d, ops + f * NQ * K, NQ, Us, SS, side < 2 ? TY : TX,
            [=](int i) { return s0 + i * step; },
            [=](int, int r, int, int s) { return (f * NQ + r) * SS + s; },
            TR, comp * (side < 2 ? gx : gy) + h);
      } else {
        row_group<2, CB, T>(
            d, ops + O.GX, 2, Us, SS, NC, tile_s,
            [=](int c, int r, int i, int) { return (c * 2 + r) * NC + i; },
            G, g0 - gt - gr);
      }
    }
  }
  __syncthreads();

  // ---- 3. the chain, two threads per tile cell (the x half and the y
  // half, chain_half, their parts exchanged across the pair), the rebuild
  // written back, each thread two of the four components
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (tid < 2 * NC) {
    const int i = tid >> 1, dir = tid & 1, ly = dTX.q(i), lx = i - ly * TX;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy < ny && gx < nx) {
      const unsigned pair = 3u << (tid & 30);   // the two lanes of the cell
      const int s = tile_s(i);
      // the neighbours along this thread's direction and their flags
      const int sA = dir == 0 ? s - 1 : s - SX, sB = dir == 0 ? s + 1 : s + SX;
      bool vA = dir == 0 ? prm.nb_w || gx > 0 : prm.nb_s || gy > 0;
      bool vB = dir == 0 ? prm.nb_e || gx < nx - 1 : prm.nb_n || gy < ny - 1;
      bool fluid = true;
      if (masked) {
        vA = Fl[2 * dir * SS + s] != 0;
        vB = Fl[(2 * dir + 1) * SS + s] != 0;
        fluid = Fl[4 * SS + s] != 0;
      }
      T ub[4], ubA[4], ubB[4], Dd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ub[c] = Av[c * SS + s];
        ubA[c] = Av[c * SS + sA];
        ubB[c] = Av[c * SS + sB];
        Dd[c] = (dir == 0 ? T(prm.hdx) : T(prm.hdy)) * G[(c * 2 + dir) * NC + i];
      }
      T ind, meas, chg, Dn[4];
      chain_half<T>(
          prm, dir, NQ, ops + O.WQ,
          [&](int f, int q) { return TR[(f * NQ + q) * SS + s]; },
          [&](int f, int q) {
            return TR[((f ^ 1) * NQ + q) * SS + ((f & 1) ? sB : sA)];
          },
          ub, ubA, ubB, Dd, vA, vB, ind, meas, chg, Dn);
      // the pair's parts, summed x half first
      const T ind_o = __shfl_xor_sync(pair, ind, 1);
      const T meas_o = __shfl_xor_sync(pair, meas, 1);
      const T chg_o = __shfl_xor_sync(pair, chg, 1);
      const T ix = dir == 0 ? ind : ind_o, iy = dir == 0 ? ind_o : ind;
      const T mx = dir == 0 ? meas : meas_o, my = dir == 0 ? meas_o : meas;
      const T cx = dir == 0 ? chg : chg_o, cy = dir == 0 ? chg_o : chg;
      T Do[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) Do[c] = __shfl_xor_sync(pair, Dn[c], 1);
      if (chain_gate<T>(prm, ix + iy, mx + my, Av[prm.comp * SS + s],
                        (T(0) + cx) + cy)) {
        // the linear rebuild ub + drx (Dxn / h) + dry (Dyn / h) of this
        // thread's two components
        const T inv_h = T(prm.inv_h);
        const T* drx = ops + O.DRX;
        const T* dry = ops + O.DRY;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          // component 2 dir + cc, each array read at a constant index
          const T ubc = dir == 0 ? ub[cc] : ub[2 + cc];
          const T sx = (dir == 0 ? Dn[cc] : Do[2 + cc]) * inv_h;
          const T sy = (dir == 0 ? Do[cc] : Dn[2 + cc]) * inv_h;
          T* u = Us + (2 * dir + cc) * K * SS + s;
          for (int k = 0; k < K; ++k)
            u[k * SS] = ubc + __ldg(drx + k) * sx + __ldg(dry + k) * sy;
        }
      }
      if (a.lam_part != nullptr && dir == 0) {
        cell_diag(ub, T(1) / T(prm.h), lam, mq);
        if (!fluid) {   // solid cells enter neither reduction
          lam = T(0);
          mq = T(INFINITY);
        }
      }
    }
  }
  __syncthreads();

  // ---- 4. Zhang-Shu on the points (tile.cuh: the scale factors, then every
  // DoF scaled about the mean), then the tile written out coalesced along
  // x: a thread per tile cell j (NC divides TNT), its planes in turn
  if (prm.pos_lim) {
    tile_thetas<T>(
        d, Us, SS, NC, tile_s,
        [&](int j, T ub[4]) {
          const int sj = tile_s(j);
#pragma unroll
          for (int c = 0; c < 4; ++c) ub[c] = Av[c * SS + sj];
        },
        sm + g.oPMT, sm + g.oSCR, sm + g.oTPS);
    tile_scale<false, T>(Us, K, SS, NC, tile_s, sm + g.oTPS);
  }
  {
    const int j = tid % NC, ly = dTX.q(j), gy = y0 + ly, gx = x0 + j - ly * TX;
    if (gy < ny && gx < nx) {
      const long gc = (long)gy * nx + gx;
      const int sj = tile_s(j);
      for (int ck = tid / NC; ck < 4 * K; ck += TNT / NC)
        a.out[ck * plane + gc] = Us[ck * SS + sj];
    }
  }

  // ---- 5. the diag's partials, one per tile ---------------------------------
  if (a.lam_part != nullptr) tile_diag(lam, mq, a.lam_part, a.minq_part);
}

// The kernels: float32 with three blocks per SM (at most 85 registers a
// thread: the third block hides the chain's and the staging's latency),
// float64 allowed 255 registers with one block per SM (as residual.cuh's).
template <typename T, class D>
__global__ void __launch_bounds__(TNT, 3)
tile_post_kernel(const PostArgs<T> a, const D d, const PostGeo g) {
  tile_post<T, D>(a, d, g);
}

template <typename T, class D>
__global__ void __launch_bounds__(TNT, 1)
tile_post_kernel_wide(const PostArgs<T> a, const D d, const PostGeo g) {
  tile_post<T, D>(a, d, g);
}

// The per-cell post (the degrees up to CELL_MAX_P): a thread per cell
// on a BY x BX block, the cell's DoFs in registers, each neighbour's
// average and facing trace from its DoFs (from a halo line where the
// wrapped index would leave the block); the same chain and positivity
// operations as the tile kernel.  At K <= 9 a cell's work is too small to
// pay for a tile's barriers (ops/kernels.post_tile).
template <typename T, class D>
__global__ void __launch_bounds__(BX * BY)
cell_post_kernel(const PostArgs<T> a, const D d) {
  const int K = d.K, NQ = d.NQ;
  constexpr int KA = D::KMAX, NA = D::NQMAX;
  const PostParams& prm = a.prm;
  const PostOps<D> O(d);
  const T* ops = a.ops;
  const int ny = a.ny, nx = a.nx;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (x < nx && y < ny) {
    const long plane = (long)ny * nx;
    const long cell = (long)y * nx + x;
    const int xw = x == 0 ? nx - 1 : x - 1;
    const int xe = x == nx - 1 ? 0 : x + 1;
    const int ys = y == 0 ? ny - 1 : y - 1;
    const int yn = y == ny - 1 ? 0 : y + 1;
    bool vW = prm.nb_w || x > 0, vE = prm.nb_e || x < nx - 1;
    bool vS = prm.nb_s || y > 0, vN = prm.nb_n || y < ny - 1;
    bool fluid = true;
    if (a.vflags != nullptr) {
      vW = __ldg(a.vflags + cell) != 0;
      vE = __ldg(a.vflags + plane + cell) != 0;
      vS = __ldg(a.vflags + 2 * plane + cell) != 0;
      vN = __ldg(a.vflags + 3 * plane + cell) != 0;
      fluid = __ldg(a.vflags + 4 * plane + cell) != 0;
    }
    const int comp = prm.comp;
    // the neighbours' averages and their facing traces (W's E face, E's
    // W, S's N, N's S)
    T ubn[4][4], tn[4][NA];
    if (x == 0 && a.hW != nullptr)
      avg_and_trace<T>(d, a.hW, ops, 1, comp, ny, y, ubn[0], tn[0]);
    else
      avg_and_trace<T>(d, a.u, ops, 1, comp, plane, (long)y * nx + xw,
                       ubn[0], tn[0]);
    if (x == nx - 1 && a.hE != nullptr)
      avg_and_trace<T>(d, a.hE, ops, 0, comp, ny, y, ubn[1], tn[1]);
    else
      avg_and_trace<T>(d, a.u, ops, 0, comp, plane, (long)y * nx + xe,
                       ubn[1], tn[1]);
    if (y == 0 && a.hS != nullptr)
      avg_and_trace<T>(d, a.hS, ops, 3, comp, nx, x, ubn[2], tn[2]);
    else
      avg_and_trace<T>(d, a.u, ops, 3, comp, plane, (long)ys * nx + x,
                       ubn[2], tn[2]);
    if (y == ny - 1 && a.hN != nullptr)
      avg_and_trace<T>(d, a.hN, ops, 2, comp, nx, x, ubn[3], tn[3]);
    else
      avg_and_trace<T>(d, a.u, ops, 2, comp, plane, (long)yn * nx + x,
                       ubn[3], tn[3]);

    // own state, average, traces of the indicator variable and the mean
    // derivatives
    T w[4][KA], ub[4], Dx[4], Dy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      load_comp<T>(d, a.u, c, plane, cell, w[c]);
      ub[c] = dot_len<T>(ops + O.AVG, w[c], K);
      Dx[c] = T(prm.hdx) * dot_len<T>(ops + O.GX, w[c], K);
      Dy[c] = T(prm.hdy) * dot_len<T>(ops + O.GY, w[c], K);
    }
    T wi[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) wi[k] = comp == ENE ? w[ENE][k] : w[RHO][k];
    T tr[4][NA];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        tr[f][q] = dot_len<T>(ops + (f * NQ + q) * K, wi, K);
    T Dxn[4], Dyn[4], ix, mx, cx, iy, my, cy;
    const auto t = [&](int f, int q) { return tr[f][q]; };
    const auto n = [&](int f, int q) { return tn[f][q]; };
    chain_half<T>(prm, 0, NQ, ops + O.WQ, t, n, ub, ubn[0], ubn[1], Dx, vW,
                  vE, ix, mx, cx, Dxn);
    chain_half<T>(prm, 1, NQ, ops + O.WQ, t, n, ub, ubn[2], ubn[3], Dy, vS,
                  vN, iy, my, cy, Dyn);
    if (chain_gate<T>(prm, ix + iy, mx + my,
                      comp == ENE ? ub[ENE] : ub[RHO], (T(0) + cx) + cy)) {
      const T inv_h = T(prm.inv_h);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T sx = Dxn[c] * inv_h, sy = Dyn[c] * inv_h;
#pragma unroll
        for (int k = 0; k < K; ++k)
          w[c][k] = ub[c] + ops[O.DRX + k] * sx + ops[O.DRY + k] * sy;
      }
    }

    // Zhang-Shu positivity (src/positivity.cc:16-208)
    if (prm.pos_lim) {
      T theta1, theta2;
      zs_thetas<T>(d, w, ub, ops + O.PM, theta1, theta2);
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
      for (int k = 0; k < K; ++k)
        a.out[(long)(c * K + k) * plane + cell] = w[c][k];
    if (a.lam_part != nullptr) {
      cell_diag(ub, T(1) / T(prm.h), lam, mq);
      if (!fluid) {   // solid cells enter neither reduction
        lam = T(0);
        mq = T(INFINITY);
      }
    }
  }
  if (a.lam_part != nullptr) block_diag(lam, mq, a.lam_part, a.minq_part);
}

// the positivity points of the nodal post at degree p: GLL(N) x Gauss(p+1),
// twice (stab/positivity._pos_points; euler.cuh BDims::QP)
inline int post_points(int p) {
  const int ng = (p + 3) % 2 == 0 ? (p + 3) / 2 : (p + 4) / 2;
  return 2 * ng * (p + 1);
}

// the degrees that take the per-cell kernel (cell_post_kernel): Q1-Q2 in
// float32, Q1 in float64; every other degree the tile kernel.  A choice made
// at build time (ops/kernels.POST_CELL_MAX_P mirrors it); kernel_ab.py builds
// the library with other values, -DDFLO_POST_CELL_MAX_P_F32=... and _F64, to
// time both kernels at a degree.
#ifndef DFLO_POST_CELL_MAX_P_F32
#define DFLO_POST_CELL_MAX_P_F32 2
#endif
#ifndef DFLO_POST_CELL_MAX_P_F64
#define DFLO_POST_CELL_MAX_P_F64 1
#endif
template <typename T>
constexpr int CELL_MAX_P =
    sizeof(T) > 4 ? DFLO_POST_CELL_MAX_P_F64 : DFLO_POST_CELL_MAX_P_F32;
inline bool post_per_cell(int dtype, int p) {
  return p <= (dtype == 0 ? CELL_MAX_P<float> : CELL_MAX_P<double>);
}

template <typename T, class D>
int launch_post(const D& d, const PostArgs<T>& a, int ty, int tx,
                cudaStream_t stream) {
  if (ty < 1 || tx < 1 || 2 * ty * tx > TNT || TNT % (ty * tx) != 0) return -1;
  const PostGeo g = post_geo(d.K, d.NQ, d.QP, (int)sizeof(T),
                             a.vflags != nullptr, a.prm.pos_lim != 0, ty, tx,
                             a.ny, a.nx);
  if (g.bytes > MAX_SMEM) return -1;
  if (a.ny < 1 || a.nx < 1) return 0;
  void (*kern)(const PostArgs<T>, const D, const PostGeo);
  if constexpr (sizeof(T) > 4)
    kern = tile_post_kernel_wide<T, D>;
  else
    kern = tile_post_kernel<T, D>;
  return launch_tile_kernel(kern, g.ntx * g.nty, g.bytes, stream, a, d, g);
}

// the per-cell kernel on BY x BX blocks: its "tile" is the block
template <typename T, class D>
int launch_cell_post(const D& d, const PostArgs<T>& a, int ty, int tx,
                     cudaStream_t stream) {
  if (ty != BY || tx != BX) return -1;
  if (a.ny < 1 || a.nx < 1) return 0;
  cell_post_kernel<T, D><<<grid_for(a.ny, a.nx), dim3(BX, BY), 0, stream>>>(
      a, d);
  return (int)cudaGetLastError();
}

// degree P (1-3) on its own instantiation of the kernel CELL_MAX_P picks
template <int P, typename T>
int launch_fixed(const PostArgs<T>& a, int ty, int tx, cudaStream_t stream) {
  if constexpr (P <= CELL_MAX_P<T>)
    return launch_cell_post(Dims<P>{}, a, ty, tx, stream);
  else
    return launch_post(Dims<P>{}, a, ty, tx, stream);
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 (the degrees up to CELL_MAX_P
// on the per-cell kernel, every other degree on the tile kernel; 1-3 on
// their own instantiations, 4-6 on the general dims of one instantiation
// per dtype).
// vflags: uint8 [5, ny, nx] flag plane of a masked domain, or NULL.  hW, hE
// ([4, K, ny]) and hS, hN ([4, K, nx]): the block form's halo lines, each
// NULL for the block wrap (the single-device form passes four NULLs); not
// with vflags.  nb_w, nb_e, nb_s, nb_n: 1 where the cells on that border
// have a neighbor across it.  ty x tx: the tile (ops/kernels.post_tile;
// BY x BX for the per-cell kernel); lam_part/minq_part NULL for the form
// without diag, else one entry per tile (ops/kernels.tile_count).
// mark_all: the `limiter` indicator.  Returns cudaGetLastError() after the
// launch, -1 for an unsupported case.
extern "C" int dflo_fused_post(int dtype, int p, const void* u, const void* ops,
                               const void* vflags, const void* hW,
                               const void* hE, const void* hS, const void* hN,
                               void* out, void* lam_part, void* minq_part,
                               int ny, int nx, int nb_w, int nb_e, int nb_s,
                               int nb_n, int comp, int mark_all, int char_lim,
                               int pos_lim, double dx, double dy, double h,
                               double hdx, double hdy, double inv_h,
                               double diam_pow, double Mdx2, double beta,
                               int ty, int tx, void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  if (vflags != nullptr && (hW || hE || hS || hN)) return -1;
  if (p < 1 || p > 6 || (dtype != 0 && dtype != 1)) return -1;
  const dflo::PostParams prm{nb_w,     nb_e,     nb_s,    nb_n, comp,
                             mark_all, char_lim, pos_lim, dx,   dy,
                             h,        hdx,      hdy,     inv_h, diam_pow,
                             Mdx2,     beta};
  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto zero) {
    using T = decltype(zero);
    return dflo::PostArgs<T>{(const T*)u,  (const T*)ops, (const T*)hW,
                             (const T*)hE, (const T*)hS,  (const T*)hN,
                             (const uint8_t*)vflags,      (T*)out,
                             (T*)lam_part, (T*)minq_part, ny, nx, prm};
  };
  const auto run = [&](auto zero) {
    using T = decltype(zero);
    const dflo::PostArgs<T> a = args(zero);
    if (p == 1) return dflo::launch_fixed<1>(a, ty, tx, s);
    if (p == 2) return dflo::launch_fixed<2>(a, ty, tx, s);
    if (p == 3) return dflo::launch_fixed<3>(a, ty, tx, s);
    // degrees 4-6: the general dims of Q_p on its p + 1 Gauss points, with
    // the positivity points of stab/positivity._pos_points(p)
    return dflo::launch_post(
        dflo::general_dims<false>((p + 1) * (p + 1), p + 1,
                                  dflo::post_points(p)),
        a, ty, tx, s);
  };
  return dtype == 0 ? run(0.0f) : run(0.0);
}

// The dynamic shared memory in bytes of one post block at degree p (dtype
// as above), masked 0/1, pos_lim 0/1, on the ty x tx tile: 0 for the
// per-cell kernel, -1 for a tile the kernel does not take.  For the build's
// report and the check of ops/kernels.post_smem (chip_smoke.py phase 1).
extern "C" int dflo_post_smem(int dtype, int p, int masked, int pos_lim,
                              int ty, int tx) {
  if (p < 1 || p > 6 || ty < 1 || tx < 1) return -1;
  if (dflo::post_per_cell(dtype, p)) return 0;
  if (2 * ty * tx > dflo::TNT) return -1;
  const int nq = p + 1;
  return dflo::post_geo(nq * nq, nq, dflo::post_points(p), dtype ? 8 : 4,
                        masked, pos_lim, ty, tx, 1, 1)
      .bytes;
}
