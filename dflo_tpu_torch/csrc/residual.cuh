// The DG residual as a tile kernel, shared by fused_residual*.cu (the dense
// residual, its SSP-stage and forward-Euler forms, every source arm) and
// fused_mood_candidate*.cu (the MOOD candidate on {truncated ->
// positivity-limited} states, TP = true).
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual, kernel body
// _fused_kernel (:268), whose row bands are loaded once and whose traces and
// face fluxes are computed once per tile in VMEM (:180-193), and its sparse
// pass (:945-1056).
//
// What bounds it on the H100: operations.  A cell's residual is a handful
// of small matrix products over its K DoFs (the V contraction to the Q
// volume points on a modal basis, the four face traces, the lift of 2Q + 4nq
// flux columns into K rows) plus one physical flux per volume point and one
// numerical flux per face point: P2 about 4,000 operations per cell
// against 48 bytes of state per DoF read and written, P4-P6 15,000-50,000.
// Every multiply and add is a separate IEEE operation (-fmad=false, below),
// so the bound is the card's f32 rate without FMA; the state's bytes bound
// only the low degrees.
//
// What the tile design does about it: one block of TNT threads per tile of
// TY x TX cells (ops/kernels.residual_tile sizes it from K and the dtype).
//  1. Stage once: the tile's DoFs and a one-cell ring (wrapped periodically
//     at the domain edge, by index) go from U[4, K, ny, nx] to shared memory
//     with cp.async, with the mask bytes and, for the candidate, the degrees.
//     The candidate applies the {truncation -> positivity} chain to every
//     staged cell there once (its positivity points spread over the
//     threads, tile.cuh).
//  2. Traces and averages once: the W/E traces of the x faces' two sides
//     and the S/N traces of the y faces', the ring cells only the one that
//     faces the tile; each is the ordered sum over k of trace_mem.
//  3. Each face flux once, from the same operands in the same order as
//     before, the slip-wall mirror applied per face; a face's flux is stored
//     before any strip, and each cell adds its own strip when it lifts (the
//     wrap face's two cells add different strips).
//  4. Volume fluxes once per (cell, point), a chunk of points at a time
//     (W = V u first on a modal basis).
//  5. The lift is a register-tiled product: each thread owns RB modes x CB
//     cells of one component and accumulates R[c][k] in the old order (the
//     volume points, each its x then its y column; the faces W, E, S, N,
//     each by q; then the source arm; then the mask), so no thread holds a
//     cell's arrays: no local memory at any degree.  It writes R, the stage
//     or u + dt*R coalesced along x.
// The operator buffer stays behind the read-only cache (__ldg).
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
// change.  On a masked domain (a uint8 fluid-flag plane) a fluid|solid face,
// the wrap faces included, takes the slip-wall mirror of the fluid side's
// trace and average (pallas_kernels.py:472-533) and a solid cell's residual
// is zeroed (:598-599).
//
// Basis dims d (euler.cuh): BDims for degrees 1-3 on their default
// quadrature (sizes constant), GDims for degrees 4-6 and any nq != p + 1 up
// to K_MAX and NQ_MAX (sizes read at run time, one instantiation per dtype,
// kind of dims and flux, its source arm read at run time too).  Both run
// the same code: nothing is sized by the dims but shared memory.
//
// Every contraction is an ordered sum (one multiply and one add per term,
// in the order of ops/kernels.fused_residual_plain) and the .cu files are
// built with -fmad=false, so kernel and plain version round alike: the
// MOOD cascade re-applies positivity to the stage predictor, whose branch at
// the pressure floor rounding decides, so an ulp in a residual would change
// later stages.  No tensor cores for that reason.
#pragma once

#include <stdint.h>

#include "tile.cuh"

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

// the operands of one tile launch; the candidate's (TP) degrees, cell set,
// tile list and its count, positivity points and mode-0 mean weight
template <typename T>
struct TileArgs {
  const T *u, *dfw, *dfe, *dfs, *dfn, *uold, *sc, *ops, *Pm;
  const uint8_t *mask, *cells;
  const int *deg, *list, *count;
  T avg0;
  T* out;
  int ny, nx;
  SrcArgs<T> src;
};

// The geometry of a tile and the layout of its dynamic shared memory:
// offsets in elements of T for the staged DoFs U [4][K][SS], the averages
// AVG [4][SS], the traces TR [4][4 NQ][SS] of every staged cell on its four
// faces (after the flux phase a cell's E rows hold the flux of the x face
// it shares with its east neighbour, its N rows that of the y face it
// shares with its north neighbour), the scratch SCR (a chunk of NCH volume
// points, the isothermal arm's E and its additions, the candidate's
// positivity points) and the candidate's per-cell chain values TPS [7][SS],
// after the candidate's transposed positivity points PMT [K][QPP] (tile.cuh
// stage_points); byte offsets of the mask and degree planes after them.
struct TileGeo {
  int TY, TX, NC, SX, SS, NCH, ntx, nty;
  int oPMT, oU, oAVG, oTR, oSCR, oTPS, bMSK, bDEG, bytes;
};

template <typename T, class D>
TileGeo tile_geo(const D& d, bool avg, bool masked, bool tp, bool body,
                 bool wb, int ty, int tx, int ny, int nx) {
  TileGeo g{};
  g.TY = ty;
  g.TX = tx;
  g.NC = ty * tx;
  g.SX = tx + 2;
  g.SS = (ty + 2) * (tx + 2);
  g.ntx = (nx + tx - 1) / tx;
  g.nty = (ny + ty - 1) / ty;
  const int K = d.K, NQ = d.NQ, NC = g.NC;
  // the regions but the scratch, in elements of T, and the bytes after them
  const int pmt = tp ? K * pad_points(d.QP) : 0;
  const int fixed = pmt + 4 * K * g.SS + (avg ? 4 * g.SS : 0) +
                    16 * NQ * g.SS + (tp ? 7 * g.SS : 0);
  const int tail = (masked ? g.SS : 0) + 4 + (tp ? 4 * g.SS : 0) + 16;
  // volume points per chunk: a multiple of RB (the products' row tile); on
  // a modal basis 1024 point-cells (the W product then gives every thread a
  // register tile), else 512; no more than a budget of shared memory allows
  // (106 kB in float32: two blocks per SM; 220 kB in float64), nor than Q
  // rounded up
  const int per = (D::MODAL ? 12 : 8) * NC;    // scratch per chunk point
  const int budget = (sizeof(T) > 4 ? 220 : 106) * 1024;
  int nch = (D::MODAL ? 1024 : 512) / NC;
  const int fit = ((budget - tail) / (int)sizeof(T) - fixed) / per;
  nch = fit < nch ? fit : nch;
  const int q4 = (d.Q + RB - 1) / RB * RB;
  nch = nch < q4 ? nch : q4;
  nch = nch / RB * RB;
  g.NCH = nch < RB ? RB : nch;
  const int NCH = g.NCH;
  const int w = D::MODAL ? 4 * NCH * NC : 0;
  int scr = w + 8 * NCH * NC;                    // W and the volume fluxes
  if (body && w + 4 * NCH * NC > scr) scr = w + 4 * NCH * NC;
  if (wb && 5 * K * NC > scr) scr = 5 * K * NC;  // E and the additions
  if (tp && pad_points(d.QP) * g.SS > scr) scr = pad_points(d.QP) * g.SS;
  int off = 0;
  g.oPMT = off; off += pmt;
  g.oU = off;   off += 4 * K * g.SS;
  g.oAVG = off; off += avg ? 4 * g.SS : 0;
  g.oTR = off;  off += 16 * NQ * g.SS;
  g.oSCR = off; off += scr;
  g.oTPS = off; off += tp ? 7 * g.SS : 0;
  int b = off * (int)sizeof(T);
  g.bMSK = b;   b += masked ? g.SS : 0;
  b = (b + 3) & ~3;
  g.bDEG = b;   b += tp ? 4 * g.SS : 0;
  g.bytes = (b + 15) & ~15;
  return g;
}

// the numerical flux at one face point, l/r the left/right states along the
// +x (nx=1) or +y (ny=1) normal, AL/AR the left/right cell averages (read by
// LxF and KEP only)
template <typename T, int FLUX>
__device__ __forceinline__ void point_flux(const T l[4], const T r[4],
                                           const T AL[4], const T AR[4], T nx,
                                           T ny, T f[4]) {
  if constexpr (FLUX == LXF) lxf(l, r, AL, AR, nx, ny, f);
  else if constexpr (FLUX == KEP) kep(l, r, AL, AR, nx, ny, f);
  else if constexpr (FLUX == ROE) roe(l, r, nx, ny, f);
  else if constexpr (FLUX == SW) steger_warming(l, r, nx, ny, f);
  else if constexpr (FLUX == KFVS) kfvs(l, r, nx, ny, f);
  else hllc(l, r, nx, ny, f);
}

// Slip-wall mirror operands at a fluid|solid face point (physics/euler.
// wall_fix): left solid, right fluid -> the left state and average become
// the right ones with the normal momentum (component MX for an x face, MY
// for a y face) negated; left fluid, right solid -> the other way round.
template <typename T>
__device__ __forceinline__ void wall_fix(T l[4], T r[4], T AL[4], T AR[4],
                                         bool mL, bool mR, int nc) {
  if (!mL && mR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      l[c] = c == nc ? -r[c] : r[c];
      AL[c] = c == nc ? -AR[c] : AR[c];
    }
  } else if (mL && !mR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r[c] = c == nc ? -l[c] : l[c];
      AR[c] = c == nc ? -AL[c] : AL[c];
    }
  }
}

// The tile kernel's body: one block per tile of TY x TX cells (TP: per
// entry of the tile list, blocks past its count exit).  Forms, by the
// pointers: uold and sc = [a, dt] -> the SSP stage a*u_old + (1-a)*(u +
// dt*R); sc = [dt] alone -> u + dt*R (TP: u_t + dt*R(u_t), written in place
// on the set cells only); neither -> R.  [a, dt] are read on the device:
// the host never waits on dt.
template <typename T, class D, int FLUX, int SRC, bool TP>
__device__ __forceinline__ void tile_residual(const TileArgs<T>& a,
                                              const D& d, const TileGeo& g) {
  static_assert(D::MODAL || !TP, "truncation needs the modal basis");
  static_assert(SRC == SRC_NONE || !TP, "the candidate takes no source");
  static_assert(SRC != WB_ISO || !D::MODAL,
                "well-balanced gravity needs a collocated basis");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int K = d.K, NQ = d.NQ, Q = d.Q, NL = d.NL;
  const int TY = g.TY, TX = g.TX, NC = g.NC, SX = g.SX, SS = g.SS;
  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  if constexpr (TP) {
    if (tile >= __ldg(a.count)) return;
    tile = __ldg(a.list + tile);
  }
  const int ny = a.ny, nx = a.nx;
  const int y0 = (tile / g.ntx) * TY, x0 = (tile % g.ntx) * TX;
  const long plane = (long)ny * nx;
  const ResOps<D> O(d);
  const T* ops = a.ops;
  const bool masked = a.mask != nullptr;
  const int kind = SRC == SRC_ANY ? a.src.kind : SRC;
  const bool body = kind == FORCE_CONST || kind == FORCE_PLANES;
  const bool wb = !D::MODAL && kind == WB_ISO;
  const bool need_avg = reads_averages<FLUX>() || wb;
  const FDiv dSX(SX), dNC(NC), dTX(TX);
  T* Us = sm + g.oU;
  T* Av = sm + g.oAVG;
  T* TR = sm + g.oTR;
  T* scr = sm + g.oSCR;
  uint8_t* Ms = smem + g.bMSK;
  int* Ds = reinterpret_cast<int*>(smem + g.bDEG);
  // staged index and global cell (wrapped) of tile cell i
  auto tile_s = [=](int i) {
    const int ly = dTX.q(i);
    return (ly + 1) * SX + i - ly * TX + 1;
  };
  auto gcell = [=](int i) {
    const int ly = dTX.q(i);
    return (long)wrap_index(y0 + ly, ny) * nx + wrap_index(x0 + i - ly * TX, nx);
  };

  // ---- 1. stage the tile and its ring (wrapped by index), with the mask
  // bytes and the candidate's degrees
  auto staged_gc = [=](int s) {
    const int sy = dSX.q(s);
    return (long)wrap_index(y0 + sy - 1, ny) * nx +
           wrap_index(x0 + s - sy * SX - 1, nx);
  };
  if constexpr (TP) stage_points(a.Pm, K, d.QP, sm + g.oPMT);
  stage_tile<T>(
      Us, SS, 4 * K,
      [&](int s, const T*& src, long& stride) {
        src = a.u + staged_gc(s);
        stride = plane;
        return true;
      },
      [&](int s) {
        if (masked) Ms[s] = __ldg(a.mask + staged_gc(s));
        if constexpr (TP) Ds[s] = __ldg(a.deg + staged_gc(s));
      });

  // ---- 1b. the candidate: {truncation -> positivity} of every staged cell,
  // the positivity points spread over the threads (tile.cuh)
  if constexpr (TP) {
    auto ident = [](int s) { return s; };
    tile_truncate<T>(d, Us, SS, SS, ident, Ds);
    tile_thetas<T>(
        d, Us, SS, SS, ident,
        [&](int s, T ub[4]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) ub[c] = a.avg0 * Us[c * K * SS + s];
        },
        sm + g.oPMT, scr, sm + g.oTPS);
    tile_scale<true, T>(Us, K, SS, SS, ident, sm + g.oTPS);
  }

  // ---- 2. averages (LxF, KEP; the isothermal source's RT) and the traces:
  // each tile cell on its four faces (faceV as one [4 NQ][K] matrix), each
  // ring cell on the face it shares with the tile (the W ring's E trace,
  // the E ring's W, the S ring's N, the N ring's S), into TR[c][f NQ + q][s]
  if (need_avg) tile_averages<T>(d, ops + O.AVG, Us, SS, Av);
  {
    const int gt = row_groups<RB, CB>(4 * NQ, NC);
    const int gx = row_groups<RB, CB>(NQ, TY), gy = row_groups<RB, CB>(NQ, TX);
    for (int g0 = tid; g0 < gt + 2 * gx + 2 * gy; g0 += TNT) {
      if (g0 < gt) {
        row_group<RB, CB, T>(
            d, ops, 4 * NQ, Us, SS, NC, tile_s,
            [=](int c, int r, int, int s) { return (c * 4 * NQ + r) * SS + s; },
            TR, g0);
        continue;
      }
      // ring side h: 0 W (column 0), 1 E (column TX + 1), 2 S (row 0), 3 N
      // (row TY + 1); its face f (the one facing the tile) and first cell
      int h = g0 - gt, side = 0;
      while (side < 4 && h >= (side < 2 ? gx : gy)) h -= side++ < 2 ? gx : gy;
      const int f = side ^ 1;   // W ring: E face, E: W, S: N, N: S
      const int s0 = side == 0 ? SX : side == 1 ? SX + TX + 1
                   : side == 2 ? 1 : (TY + 1) * SX + 1;
      const int step = side < 2 ? SX : 1;
      row_group<RB, CB, T>(
          d, ops + f * NQ * K, NQ, Us, SS, side < 2 ? TY : TX,
          [=](int i) { return s0 + i * step; },
          [=](int c, int r, int, int s) {
            return (c * 4 * NQ + f * NQ + r) * SS + s;
          },
          TR, h);
    }
  }
  __syncthreads();

  // ---- 3. one numerical flux per face point, into the left cell's E (x
  // face) or N (y face) trace rows
  const int NFX = TY * (TX + 1), NFY = (TY + 1) * TX;
  {
    const FDiv dX(NFX), dY(NFY), dTX1(TX + 1);
    for (int i = tid; i < NQ * (NFX + NFY); i += TNT) {
      const bool xf = i < NQ * NFX;
      const int j = xf ? i : i - NQ * NFX;
      const int q = xf ? dX.q(j) : dY.q(j), f = j - q * (xf ? NFX : NFY);
      int sL, sR;
      if (xf) {
        const int ly = dTX1.q(f);
        sL = (ly + 1) * SX + f - ly * (TX + 1);
        sR = sL + 1;
      } else {
        const int fy = dTX.q(f);
        sL = fy * SX + f - fy * TX + 1;
        sR = sL + SX;
      }
      // the left cell's E (N) trace, the right cell's W (S) trace
      T* L = TR + ((xf ? 1 : 3) * NQ + q) * SS + sL;
      const T* Rt = TR + ((xf ? 0 : 2) * NQ + q) * SS + sR;
      T l[4], r[4], AL[4] = {T(0), T(0), T(0), T(0)},
                    AR[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        l[c] = L[c * 4 * NQ * SS];
        r[c] = Rt[c * 4 * NQ * SS];
      }
      if constexpr (reads_averages<FLUX>()) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          AL[c] = Av[c * SS + sL];
          AR[c] = Av[c * SS + sR];
        }
      }
      if (masked)
        wall_fix(l, r, AL, AR, Ms[sL] != 0, Ms[sR] != 0, xf ? MX : MY);
      T F[4];
      point_flux<T, FLUX>(l, r, AL, AR, xf ? T(1) : T(0), xf ? T(0) : T(1),
                          F);
#pragma unroll
      for (int c = 0; c < 4; ++c) L[c * 4 * NQ * SS] = F[c];
    }
  }
  __syncthreads();

  // ---- 3b. the delta strips of a tile on the domain's edge, added to the
  // flux of each edge face (F + strip, as each cell added it before it
  // lifted): such a face's slot is read by one valid tile cell only (the
  // other cell sharing it is a ring cell or lies past the domain)
  if (x0 == 0 || x0 + TX >= nx || y0 == 0 || y0 + TY >= ny) {
    const int lxe = nx - 1 - x0, lyn = ny - 1 - y0;
    const FDiv dTY(TY);
    for (int i = tid; i < 8 * NQ * (TY + TX); i += TNT) {
      const bool xs = i < 8 * NQ * TY;   // a W or E strip (else S or N)
      const int j = xs ? i : i - 8 * NQ * TY;
      const int cqe = xs ? dTY.q(j) : dTX.q(j);
      const int t = j - cqe * (xs ? TY : TX);   // the row (W/E), column (S/N)
      const int e = cqe & 1, cq = cqe >> 1, c = cq / NQ, q = cq - c * NQ;
      int ls, slot;
      const T* strip;
      if (xs) {
        ls = e == 0 ? (x0 == 0 ? 0 : -1) : lxe;
        slot = (t + 1) * SX + (e == 0 ? 0 : lxe + 1);
        strip = (e == 0 ? a.dfw : a.dfe) + (long)cq * ny + y0 + t;
        if (y0 + t >= ny) continue;
      } else {
        ls = e == 0 ? (y0 == 0 ? 0 : -1) : lyn;
        slot = (e == 0 ? 0 : lyn + 1) * SX + t + 1;
        strip = (e == 0 ? a.dfs : a.dfn) + (long)cq * nx + x0 + t;
        if (x0 + t >= nx) continue;
      }
      if (ls < 0 || ls >= (xs ? TX : TY)) continue;
      T* F = TR + (c * 4 * NQ + (xs ? 1 : 3) * NQ + q) * SS + slot;
      *F = *F + __ldg(strip);
    }
  }

  // ---- 4. the lift: thread (c, kb, cb) owns modes kb*RB.. and tile cells
  // cb + j*ncb; threads past the groups only help the other phases
  const int nkb = (K + RB - 1) / RB, ncb = NC / CB;
  const bool lifter = tid < 4 * nkb * ncb;
  const int cb = tid % ncb, kb = (tid / ncb) % nkb, c = tid / (ncb * nkb);
  const T* lift = ops + O.LIFT;
  int kk[RB], lo[RB];   // the thread's modes and their lift rows' offsets
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    kk[i] = kb * RB + i;
    lo[i] = (kk[i] < K ? kk[i] : K - 1) * NL;
  }
  int cl[CB], st[CB];   // the thread's tile cells and their staged indices
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    cl[j] = cb + j * ncb;
    st[j] = tile_s(cl[j]);
  }
  T R[RB][CB];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < CB; ++j) R[i][j] = T(0);

  const T* V = ops + O.VOL;
  T* W = scr;                                      // [4][nch][NC], modal
  T* VF = scr + (D::MODAL ? 4 * g.NCH * NC : 0);   // [8][nch][NC]
  // the point states of a chunk: W = V u (modal) or the nodal values
  auto point_state = [&](int n0, int nch, int i, T wq[4]) {
    const int n = dNC.q(i), cc = i - n * NC;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wq[e] = D::MODAL ? W[(e * nch + n) * NC + cc]
                       : Us[(e * K + n0 + n) * SS + tile_s(cc)];
  };
  for (int n0 = 0; n0 < Q; n0 += g.NCH) {
    const int nch = Q - n0 < g.NCH ? Q - n0 : g.NCH;
    if (n0 > 0) __syncthreads();
    if constexpr (D::MODAL) {
      apply_rows<RB, CB, T>(d, V + n0 * K, nch, Us, SS, NC, tile_s, W);
      __syncthreads();
    }
    for (int i = tid; i < nch * NC; i += TNT) {
      T wq[4], fx[4], fy[4];
      point_state(n0, nch, i, wq);
      flux_xy(wq, fx, fy);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        VF[(e * nch) * NC + i] = fx[e];
        VF[((4 + e) * nch) * NC + i] = fy[e];
      }
    }
    __syncthreads();
    if (lifter) {
#pragma unroll 2   // the next point's loads ahead of this one's products
      for (int n = 0; n < nch; ++n) {
        const T* fxp = VF + (c * nch + n) * NC;
        const T* fyp = VF + ((4 + c) * nch + n) * NC;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const T lx = __ldg(lift + lo[i] + n0 + n);
          const T ly = __ldg(lift + lo[i] + Q + n0 + n);
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            R[i][j] = R[i][j] + lx * fxp[cl[j]];
            R[i][j] = R[i][j] + ly * fyp[cl[j]];
          }
        }
      }
    }
  }

  // faces W, E, S, N, each by q (the strips already in the edge faces)
  if (lifter) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // the face's flux: the E (x) or N (y) rows of the cell on its left
      const int rows = (f < 2 ? 1 : 3) * NQ, shift = f == 0 ? 1 : f == 2 ? SX : 0;
      const T* Ff = TR + (c * 4 * NQ + rows) * SS - shift;
      for (int q = 0; q < NQ; ++q) {
        T F[CB];
#pragma unroll
        for (int j = 0; j < CB; ++j) F[j] = Ff[q * SS + st[j]];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const T l = __ldg(lift + lo[i] + 2 * Q + f * NQ + q);
#pragma unroll
          for (int j = 0; j < CB; ++j) R[i][j] = R[i][j] + l * F[j];
        }
      }
    }
  }

  // ---- 5. source arms, after the lifts -----------------------------------
  if (body) {
    // R += src[:, n] S(W(n)), point by point (ops/kernels._source_plain)
    const T* sop = ops + O.SRCOP;
    T* S = VF;   // [4][nch][NC]
    for (int n0 = 0; n0 < Q; n0 += g.NCH) {
      const int nch = Q - n0 < g.NCH ? Q - n0 : g.NCH;
      __syncthreads();
      if constexpr (D::MODAL) {
        apply_rows<RB, CB, T>(d, V + n0 * K, nch, Us, SS, NC, tile_s, W);
        __syncthreads();
      }
      for (int i = tid; i < nch * NC; i += TNT) {
        T wq[4], s[4];
        point_state(n0, nch, i, wq);
        if (kind == FORCE_CONST) {
          // physics/euler.forcing_gravity
          s[MX] = a.src.gx * wq[RHO];
          s[MY] = a.src.gy * wq[RHO];
          s[RHO] = T(0);
          s[ENE] = a.src.gx * wq[MX] + a.src.gy * wq[MY];
        } else {
          // physics/euler.forcing_external
          const int n = dNC.q(i);
          const long pi = (long)(n0 + n) * plane + gcell(i - n * NC);
          const T fx = __ldg(a.src.fx + pi), fy = __ldg(a.src.fy + pi);
          s[MX] = wq[RHO] * fx;
          s[MY] = wq[RHO] * fy;
          s[RHO] = T(0);
          s[ENE] = wq[MX] * fx + wq[MY] * fy;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) S[e * nch * NC + i] = s[e];
      }
      __syncthreads();
      if (lifter) {
        for (int n = 0; n < nch; ++n) {
          const T* sp = S + (c * nch + n) * NC;
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const T l = __ldg(sop + (kk[i] < K ? kk[i] : K - 1) * Q + n0 + n);
#pragma unroll
            for (int j = 0; j < CB; ++j) R[i][j] = R[i][j] + l * sp[cl[j]];
          }
        }
      }
    }
  } else if (wb) {
    // isothermal well-balanced gravity on the nodes (pallas_kernels.py:
    // 578-593): RT of the cell average, E = exp(-phi/RT), the nodal
    // derivatives of E times the baked 1/dx, 1/dy, then S = rho RT / E grad
    // E added node by node
    const T* gxn = ops + O.GXN;
    const T* gyn = ops + O.GYN;
    const T inv_dx = __ldg(ops + O.INVD), inv_dy = __ldg(ops + O.INVD + 1);
    T* E = scr;             // [K][NC]
    T* add = scr + K * NC;  // [4][K][NC]
    auto rt_of = [&](int cc) {
      T ub[4];
      const int s = tile_s(cc);
#pragma unroll
      for (int e = 0; e < 4; ++e) ub[e] = Av[e * SS + s];
      return pressure(ub) / ub[RHO];
    };
    __syncthreads();
    for (int i = tid; i < K * NC; i += TNT) {
      const int k = dNC.q(i), cc = i - k * NC;
      E[i] = ieee_exp(-__ldg(a.src.phi + (long)k * plane + gcell(cc)) /
                      rt_of(cc));
    }
    __syncthreads();
    for (int i = tid; i < K * NC; i += TNT) {
      const int k = dNC.q(i), cc = i - k * NC, s = tile_s(cc);
      T dex = __ldg(gxn + k * K) * E[cc], dey = __ldg(gyn + k * K) * E[cc];
      for (int jn = 1; jn < K; ++jn) {
        dex = dex + __ldg(gxn + k * K + jn) * E[jn * NC + cc];
        dey = dey + __ldg(gyn + k * K + jn) * E[jn * NC + cc];
      }
      dex = dex * inv_dx;
      dey = dey * inv_dy;
      T wk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) wk[e] = Us[(e * K + k) * SS + s];
      const T fac = wk[RHO] * rt_of(cc) / E[i];
      const T sx = fac * dex, sy = fac * dey;
      add[(MX * K + k) * NC + cc] = sx;
      add[(MY * K + k) * NC + cc] = sy;
      add[(RHO * K + k) * NC + cc] = T(0);
      add[(ENE * K + k) * NC + cc] = (wk[MX] * sx + wk[MY] * sy) / wk[RHO];
    }
    __syncthreads();
    if (lifter) {
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (kk[i] < K)
#pragma unroll
          for (int j = 0; j < CB; ++j)
            R[i][j] = R[i][j] + add[(c * K + kk[i]) * NC + cl[j]];
    }
  }
  if (!lifter) return;

  // ---- 6. the mask, then R, the SSP stage, u + dt*R or the candidate -----
  const int form = a.uold != nullptr ? 2 : a.sc != nullptr ? 1 : 0;
  const T av = form == 2 ? a.sc[0] : T(0);
  const T dt = form == 2 ? a.sc[1] : form == 1 ? a.sc[0] : T(0);
  long cell[CB];   // the global cell of each of the thread's cells, or -1
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const int ly = dTX.q(cl[j]), lx = cl[j] - ly * TX;
    const int gy = y0 + ly, gxc = x0 + lx;
    cell[j] = gy < ny && gxc < nx ? (long)gy * nx + gxc : -1;
    if constexpr (TP) {
      if (cell[j] >= 0 && __ldg(a.cells + cell[j]) == 0) cell[j] = -1;
    }
  }
  // the stage's u_old, every load issued before the first store (out and
  // u_old are not known apart)
  T uo[RB][CB];
  if (form == 2) {
#pragma unroll
    for (int j = 0; j < CB; ++j)
#pragma unroll
      for (int i = 0; i < RB; ++i)
        uo[i][j] = cell[j] >= 0 && kk[i] < K
                       ? __ldg(a.uold + (long)(c * K + kk[i]) * plane + cell[j])
                       : T(0);
  }
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    if (cell[j] < 0) continue;
    const T m = masked && Ms[st[j]] == 0 ? T(0) : T(1);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (kk[i] >= K) continue;
      T r = R[i][j];
      if (masked) r = r * m;   // solid cells are frozen (R * mask)
      const long o = (long)(c * K + kk[i]) * plane + cell[j];
      const T uv = Us[(c * K + kk[i]) * SS + st[j]];
      if (form == 2)
        a.out[o] = av * uo[i][j] + (T(1) - av) * (uv + dt * r);
      else if (form == 1)
        a.out[o] = uv + dt * r;
      else
        a.out[o] = r;
    }
  }
}

// The kernels.  float32 under the block size alone: ptxas then holds most
// forms to 64-80 registers a thread (a bound of 80 or 128 of our own spilled
// more, as it unrolled and hoisted further).  float64 with one block per SM,
// up to 255 registers: its fluxes' temporaries then stay out of local
// memory, and shared memory holds most f64 tiles to one or two blocks per SM
// anyway.
template <typename T, class D, int FLUX, int SRC, bool TP>
__global__ void __launch_bounds__(TNT)
tile_residual_kernel(const TileArgs<T> a, const D d, const TileGeo g) {
  tile_residual<T, D, FLUX, SRC, TP>(a, d, g);
}

template <typename T, class D, int FLUX, int SRC, bool TP>
__global__ void __launch_bounds__(TNT, 1)
tile_residual_kernel_wide(const TileArgs<T> a, const D d, const TileGeo g) {
  tile_residual<T, D, FLUX, SRC, TP>(a, d, g);
}

// The operands of one residual launch (the C entry points' pointers, as
// void*; fx, fy, phi, gx, gy only for a source arm) and the tile.
struct ResArgs {
  const void *u, *dfw, *dfe, *dfs, *dfn, *uold, *sc, *ops, *mask;
  const void *fx, *fy, *phi;
  double gx, gy;
  void* out;
  int ny, nx, ty, tx;
};

// Launch one tile kernel: checks the tile against the block (every
// register tile of the lift on a thread) and shared memory, sizes the
// block's dynamic shared memory and launches one block per tile (TP: per
// possible entry of the tile list).  Returns cudaGetLastError(), -1 for a
// tile the kernel does not take.
template <typename T, int FLUX, int SRC, bool TP, class D>
int launch_tiles(const D& d, const TileArgs<T>& a, int kind, int ty, int tx,
                 cudaStream_t stream) {
  if (ty < 1 || tx < 1 || (ty * tx) % CB != 0) return -1;
  if (4 * ((d.K + RB - 1) / RB) * (ty * tx / CB) > TNT) return -1;
  const bool wb = !D::MODAL && kind == WB_ISO;
  const TileGeo g = tile_geo<T>(
      d, reads_averages<FLUX>() || wb, a.mask != nullptr, TP,
      kind == FORCE_CONST || kind == FORCE_PLANES, wb, ty, tx, a.ny, a.nx);
  if (g.bytes > MAX_SMEM) return -1;
  if (a.ny < 1 || a.nx < 1) return 0;
  void (*kern)(const TileArgs<T>, const D, const TileGeo);
  if constexpr (sizeof(T) > 4)
    kern = tile_residual_kernel_wide<T, D, FLUX, SRC, TP>;
  else
    kern = tile_residual_kernel<T, D, FLUX, SRC, TP>;
  return launch_tile_kernel(kern, g.ntx * g.nty, g.bytes, stream, a, d, g);
}

template <typename T, int FLUX, int SRC, class D>
int launch_residual(const D& d, const ResArgs& r, cudaStream_t stream,
                    int kind = SRC) {
  TileArgs<T> a{};
  a.u = (const T*)r.u;
  a.dfw = (const T*)r.dfw;
  a.dfe = (const T*)r.dfe;
  a.dfs = (const T*)r.dfs;
  a.dfn = (const T*)r.dfn;
  a.uold = (const T*)r.uold;
  a.sc = (const T*)r.sc;
  a.ops = (const T*)r.ops;
  a.mask = (const uint8_t*)r.mask;
  a.out = (T*)r.out;
  a.ny = r.ny;
  a.nx = r.nx;
  a.src.kind = kind;
  a.src.fx = (const T*)r.fx;
  a.src.fy = (const T*)r.fy;
  a.src.phi = (const T*)r.phi;
  a.src.gx = T(r.gx);
  a.src.gy = T(r.gy);
  return launch_tiles<T, FLUX, SRC, false>(d, a, kind, r.ty, r.tx, stream);
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
// basis beyond the bounds, a tile the kernel does not take).  Each source
// arm's table is instantiated in a translation unit of its own
// (fused_residual_src*.cu, _planes*.cu, _wb*.cu), so nvcc builds them side
// by side.
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
