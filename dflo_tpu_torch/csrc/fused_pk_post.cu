// Fused Pk post of one MOOD stage, hand-written for Hopper as a tile kernel.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_pk_post (with and
// without its diag outputs).  Per cell of a modal Pk state: the mode-0 mean
// and the four neighbors' mode-0 means (neighbor-exists flags from
// global-edge arithmetic, non-wrapping on non-periodic sides); the modal TVB
// limiter (src/limiter.cc:376-516: slopes sqrt(3) x the (1,0) and (0,1)
// modes, beta / 2, characteristic decomposition) on the cells whose shock
// plane exceeds 1 (the cells the cascade marked) and whose change exceeds
// 1e-10, rebuilt as [mean, x-slope, y-slope]; Zhang-Shu positivity about
// the pre-limit mean; with diag, the CFL wave speed and min(rho, p) of the
// means (the chain preserves them), reduced per tile into partials.
//
// What bounds it on the H100: bytes at f32 (the state read and written once,
// four mode-0 values of each neighbor, the shock plane), with ~2,000
// operations per P2 cell (two 4x4 eigen systems, 18 positivity points) and
// ~7,000 at P4 (40 points x 4 components x 15 modes, each a multiply and an
// add with contraction off), where the points' products lead.
//
// What the tile design does about it: one block of TNT threads per tile of
// TY x TX cells (ops/kernels.pk_post_tile: at most TNT cells, at most 2,700
// of a component's modes in float32 and 2,000 in float64, the sweep's).
//  1. Stage once with cp.async: the transposed positivity points (tile.cuh
//     stage_points), the tile's 4K planes and shock values (stage_tile),
//     and the one-cell ring's four mode-0 values alone (no corners): the
//     chain reads nothing else of a neighbour.
//  2. The means avg0 x mode 0 of every staged cell (the points' values
//     later take their space).
//  3. The modal TVB on two threads per tile cell, the x and the y half
//     (euler.cuh tvb_dir), their changes exchanged across the pair with
//     __shfl_xor_sync and summed x first, as tvb_slopes does, so the
//     change > 1e-10 gate and shock > 1 decide as the plain version; the
//     rebuild [mean, x-slope / sqrt3, y-slope / sqrt3], every other mode
//     zero, written back to the staged planes, each thread two components.
//     A tile of more than TNT / 2 cells takes a thread per cell, both
//     halves in turn: at low K a larger tile keeps more cells on an SM.
//  4. Zhang-Shu about the pre-limit mean with the points' products as
//     register tiles (tile.cuh tile_thetas, then tile_scale), as
//     fused_modal_pos.cu does.
//  5. The tile written out coalesced along x; the diag reduced per tile
//     (tile.cuh tile_diag), one partial a tile.
// Degrees 1-3 take their fixed dims (BDims), 4-6 the general modal dims
// (GDims, K and the points at run time), which size nothing but shared
// memory: no thread holds a cell's arrays.  The per-cell kernel (a thread
// per cell on a BY x BX block, the cell's [4][K] DoFs in registers) stays
// for the fixed dims a build-time cap names (DFLO_PK_POST_CELL_MAX_P_F32 /
// _F64: float32 P1-P3 and float64 P1-P2, where a cell's work is too small
// to pay for the tile's phases and the tile ran 1-85 % slower).
// Built with -fmad=false, and every quantity that feeds the TVB gate is
// computed with the plain version's IEEE operations in its order, so in
// float32 kernel and plain version take the same limiter decisions (the
// fault seen in fused_post.cu's first chip run).
#include <stdint.h>

#include "tile.cuh"

namespace dflo {

struct PkPostParams {
  int per_x, per_y, char_lim;
  double avg0, beta, Mdx2, h;
};

// the operands of one launch
template <typename T>
struct PkPostArgs {
  const T *u, *shock, *Pm;
  T *out, *lam_part, *minq_part;
  int ny, nx;
  PkPostParams prm;
};

// The geometry of a Pk post tile and its dynamic shared memory: offsets in
// elements of T of the transposed positivity points PMT [K][QPP] (tile.cuh
// stage_points), the tile's staged modes U [4][K][NC], the means UB [4][SS]
// of the tile and its one-cell ring (SS = (TY + 2)(TX + 2), the ring's
// mode 0 staged there first; the chain is their last reader, so the
// points' values SCR [QPP][NC] take the same space after it), the tile's
// shock values SHK [NC] and the per-cell values TPS [7][NC].
// ops/kernels.pk_post_smem mirrors it.
struct PkPostGeo {
  int TY, TX, NC, SX, SS, ntx, nty, oU, oUB, oSHK, oSCR, oTPS, bytes;
};

inline PkPostGeo pk_post_geo(int K, int QP, int tsize, int ty, int tx,
                             int ny, int nx) {
  PkPostGeo g{};
  g.TY = ty;
  g.TX = tx;
  g.NC = ty * tx;
  g.SX = tx + 2;
  g.SS = (ty + 2) * (tx + 2);
  g.ntx = (nx + tx - 1) / tx;
  g.nty = (ny + ty - 1) / ty;
  g.oU = K * pad_points(QP);
  g.oUB = g.oU + 4 * K * g.NC;
  g.oSCR = g.oUB;
  const int scr = pad_points(QP) * g.NC;
  g.oSHK = g.oUB + (4 * g.SS > scr ? 4 * g.SS : scr);
  g.oTPS = g.oSHK + g.NC;
  g.bytes = ((g.oTPS + 7 * g.NC) * tsize + 15) & ~15;
  return g;
}

template <typename T, class D>
__device__ __forceinline__ void tile_pk_post(const PkPostArgs<T>& a,
                                             const D& d, const PkPostGeo& g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  T* Us = sm + g.oU;
  T* UB = sm + g.oUB;
  T* SHK = sm + g.oSHK;
  const int K = d.K, IX = 1, IY = d.P + 1;   // (1,0) and (0,1) modes
  const int TY = g.TY, TX = g.TX, NC = g.NC, SX = g.SX, SS = g.SS;
  const int tid = threadIdx.x, tile = blockIdx.x, ny = a.ny, nx = a.nx;
  const int y0 = (tile / g.ntx) * TY, x0 = (tile % g.ntx) * TX;
  const long plane = (long)ny * nx;
  const PkPostParams& prm = a.prm;
  const T avg0 = T(prm.avg0);
  const FDiv dTX(TX), dSX(SX), dSS(SS);
  // the global cell of tile cell j, or -1 past the grid
  auto gcell = [=](int j) {
    const int ly = dTX.q(j), gy = y0 + ly, gx = x0 + j - ly * TX;
    return gy < ny && gx < nx ? (long)gy * nx + gx : -1L;
  };
  // the index in the ring window of tile cell j
  auto tile_s = [=](int j) {
    const int ly = dTX.q(j);
    return (ly + 1) * SX + j - ly * TX + 1;
  };
  auto ident = [](int j) { return j; };

  // ---- 1. stage: the ring's mode 0 (wrapped by index; a window cell of
  // the tile past the grid, which a grid cell's neighbour may wrap to, as
  // well; corners and cells no grid cell reads left out), the points, the
  // tile's modes and shock values; stage_tile's wait covers every copy
  for (int i = tid; i < 4 * SS; i += TNT) {
    const int c = dSS.q(i), s = i - c * SS;
    const int sy = dSX.q(s), sx = s - sy * SX;
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    const bool oy = gy < 0 || gy >= ny, ox = gx < 0 || gx >= nx;
    const bool ry = sy == 0 || sy == TY + 1, rx = sx == 0 || sx == TX + 1;
    if ((ry && rx) || (!oy && !ox && !ry && !rx)) continue;
    if ((oy && ox) || gy > ny || gx > nx) continue;
    copy_async(UB + i, a.u + (long)(c * K) * plane +
                           (long)wrap_index(gy, ny) * nx + wrap_index(gx, nx));
  }
  stage_points(a.Pm, K, d.QP, sm);
  stage_tile<T>(
      Us, NC, 4 * K,
      [&](int j, const T*& src, long& stride) {
        const long gc = gcell(j);
        src = a.u + gc;
        stride = plane;
        return gc >= 0;
      },
      [&](int j) { SHK[j] = __ldg(a.shock + gcell(j)); });

  // ---- 2. the means of the tile (from its staged mode 0; also in TPS, where
  // Zhang-Shu reads them after the chain) and of the ring
  T* tps = sm + g.oTPS;
  for (int i = tid; i < 4 * SS; i += TNT) {
    const int c = dSS.q(i), s = i - c * SS;
    const int sy = dSX.q(s), sx = s - sy * SX;
    const int ly = sy - 1, lx = sx - 1;
    if (ly >= 0 && ly < TY && lx >= 0 && lx < TX && y0 + ly < ny &&
        x0 + lx < nx) {
      const T ub = avg0 * Us[(c * K) * NC + ly * TX + lx];
      UB[i] = ub;
      tps[c * NC + ly * TX + lx] = ub;
    } else {
      UB[i] = avg0 * UB[i];
    }
  }
  __syncthreads();

  // ---- 3. the modal TVB: on tiles of at most TNT / 2 cells two threads
  // per tile cell (dir 0 the x half, dir 1 the y half), each writing two of
  // the four components of the rebuild; on larger tiles a thread per cell,
  // both halves in turn
  const T sqrt3 = T(1.7320508075688772);   // float(np.sqrt(3.0))
  const T inv_sqrt3 = T(1) / sqrt3;        // stab/limiter's inv_sqrt3
  // one direction's half of tile cell j at (gy, gx), staged at s: its
  // slopes' change measure, the limited slopes in Dn
  auto half = [&](int j, int s, int gy, int gx, int dir, const T ub[4],
                  T Dn[4]) {
    const int sA = dir == 0 ? s - 1 : s - SX, sB = dir == 0 ? s + 1 : s + SX;
    const bool vA = dir == 0 ? prm.per_x || gx > 0 : prm.per_y || gy > 0;
    const bool vB =
        dir == 0 ? prm.per_x || gx < nx - 1 : prm.per_y || gy < ny - 1;
    const int km = dir == 0 ? IX : IY;
    T Dd[4], db[4], df[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dd[c] = sqrt3 * Us[(c * K + km) * NC + j];
      db[c] = vA ? ub[c] - UB[c * SS + sA] : Dd[c];
      df[c] = vB ? UB[c * SS + sB] - ub[c] : Dd[c];
    }
    return tvb_dir(ub, dir, Dd, db, df, prm.char_lim != 0, T(prm.beta),
                   T(prm.Mdx2), Dn);
  };
  // [mean, x-slope / sqrt3, y-slope / sqrt3] into component c of cell j,
  // every other mode zero; mode 0 takes the mean itself, as the plain
  // limiter (stab/limiter.py) does
  auto rebuild = [&](int j, int c, T ubc, T sx, T sy) {
    T* u = Us + c * K * NC + j;
    for (int k = 0; k < K; ++k)
      u[k * NC] = k == 0    ? ubc
                  : k == IX ? sx * inv_sqrt3
                  : k == IY ? sy * inv_sqrt3
                            : T(0);
  };
  const bool pairs = 2 * NC <= TNT;
  if (tid < (pairs ? 2 * NC : NC)) {
    const int j = pairs ? tid >> 1 : tid, ly = dTX.q(j), lx = j - ly * TX;
    const int gy = y0 + ly, gx = x0 + lx, s = tile_s(j);
    if (gy < ny && gx < nx) {
      T ub[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ub[c] = UB[c * SS + s];
      if (pairs) {
        const int dir = tid & 1;
        const unsigned pair = 3u << (tid & 30);   // the two lanes of the cell
        T Dn[4], Do[4];
        const T chg = half(j, s, gy, gx, dir, ub, Dn);
        // the pair's changes, summed x half first (tvb_slopes' order)
        const T chg_o = __shfl_xor_sync(pair, chg, 1);
        const T cx = dir == 0 ? chg : chg_o, cy = dir == 0 ? chg_o : chg;
#pragma unroll
        for (int c = 0; c < 4; ++c) Do[c] = __shfl_xor_sync(pair, Dn[c], 1);
        if (SHK[j] > T(1) && (T(0) + cx) + cy > T(1.0e-10)) {
          // this thread's components 2 dir and 2 dir + 1, each array read
          // at a constant index
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            rebuild(j, 2 * dir + cc, dir == 0 ? ub[cc] : ub[2 + cc],
                    dir == 0 ? Dn[cc] : Do[2 + cc],
                    dir == 0 ? Do[cc] : Dn[2 + cc]);
        }
      } else {
        T Dxn[4], Dyn[4];
        const T cx = half(j, s, gy, gx, 0, ub, Dxn);
        const T cy = half(j, s, gy, gx, 1, ub, Dyn);
        if (SHK[j] > T(1) && (T(0) + cx) + cy > T(1.0e-10)) {
#pragma unroll
          for (int c = 0; c < 4; ++c) rebuild(j, c, ub[c], Dxn[c], Dyn[c]);
        }
      }
    }
  }
  __syncthreads();

  // ---- 4. Zhang-Shu about the pre-limit mean ----------------------------
  tile_thetas<T>(
      d, Us, NC, NC, ident,
      [&](int j, T ub[4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ub[c] = tps[c * NC + j];
      },
      sm, sm + g.oSCR, tps);
  tile_scale<true, T>(Us, K, NC, NC, ident, tps);

  // ---- 5. the tile written out, the diag's partials, one per tile ------
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (a.lam_part != nullptr && tid < NC && gcell(tid) >= 0) {
    T ub[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ub[c] = tps[c * NC + tid];
    cell_diag(ub, T(1) / T(prm.h), lam, mq);
  }
  {
    // a thread per tile cell j (NC divides TNT), its planes in turn
    const int j = tid % NC;
    const long gc = gcell(j);
    if (gc >= 0)
      for (int ck = tid / NC; ck < 4 * K; ck += TNT / NC)
        a.out[ck * plane + gc] = Us[ck * NC + j];
  }
  if (a.lam_part != nullptr) tile_diag(lam, mq, a.lam_part, a.minq_part);
}

// float32 with two blocks per SM (at most 128 registers a thread), float64
// allowed 255 registers with one block per SM (as the post's)
template <typename T, class D>
__global__ void __launch_bounds__(TNT, 2)
tile_pk_post_kernel(const PkPostArgs<T> a, const D d, const PkPostGeo g) {
  tile_pk_post<T, D>(a, d, g);
}

template <typename T, class D>
__global__ void __launch_bounds__(TNT, 1)
tile_pk_post_kernel_wide(const PkPostArgs<T> a, const D d,
                         const PkPostGeo g) {
  tile_pk_post<T, D>(a, d, g);
}

// The per-cell Pk post (the fixed dims up to PK_CELL_MAX_P): a thread per
// cell on a BY x BX block, the cell's DoFs in registers, the neighbours'
// mode 0 read through L1; the same operations as the tile kernel.  Its
// operands one by one, the pointers __restrict__ (the loads free to pass
// the stores).
template <typename T, class D>
__global__ void __launch_bounds__(BX * BY)
cell_pk_post_kernel(const T* __restrict__ u, const T* __restrict__ shock,
                    const T* __restrict__ Pm, T* __restrict__ out,
                    T* __restrict__ lam_part, T* __restrict__ minq_part,
                    int ny, int nx, PkPostParams prm, D d) {
  const int K = d.K;
  const int IX = 1, IY = d.P + 1;       // (1,0) and (0,1) modes
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
    const bool vW = prm.per_x || x > 0, vE = prm.per_x || x < nx - 1;
    const bool vS = prm.per_y || y > 0, vN = prm.per_y || y < ny - 1;
    const T avg0 = T(prm.avg0);
    const T sqrt3 = T(1.7320508075688772);   // float(np.sqrt(3.0))
    const T inv_sqrt3 = T(1) / sqrt3;        // stab/limiter's inv_sqrt3

    T w[4][D::KMAX], ub[4], ubW[4], ubE[4], ubS[4], ubN[4];
    load_cell<T>(d, u, plane, cell, w);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* m0 = u + (long)(c * K) * plane;
      ub[c] = avg0 * w[c][0];
      ubW[c] = avg0 * __ldg(m0 + (long)y * nx + xw);
      ubE[c] = avg0 * __ldg(m0 + (long)y * nx + xe);
      ubS[c] = avg0 * __ldg(m0 + (long)ys * nx + x);
      ubN[c] = avg0 * __ldg(m0 + (long)yn * nx + x);
    }

    // ---- modal TVB limiter ----------------------------------------------
    T Dx[4], Dy[4], dbx[4], dfx[4], dby[4], dfy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      Dx[c] = sqrt3 * w[c][IX];
      Dy[c] = sqrt3 * w[c][IY];
      dbx[c] = vW ? ub[c] - ubW[c] : Dx[c];
      dfx[c] = vE ? ubE[c] - ub[c] : Dx[c];
      dby[c] = vS ? ub[c] - ubS[c] : Dy[c];
      dfy[c] = vN ? ubN[c] - ub[c] : Dy[c];
    }
    T Dxn[4], Dyn[4];
    const T change = tvb_slopes(ub, Dx, Dy, dbx, dfx, dby, dfy,
                                prm.char_lim != 0, T(prm.beta), T(prm.Mdx2),
                                Dxn, Dyn);
    if (__ldg(shock + cell) > T(1) && change > T(1.0e-10)) {
      // keep [mean, x-slope, y-slope]; mode 0 takes the mean itself, as the
      // plain limiter (stab/limiter.py) does
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int k = 0; k < K; ++k) w[c][k] = T(0);
        w[c][0] = ub[c];
        w[c][IX] = Dxn[c] * inv_sqrt3;
        w[c][IY] = Dyn[c] * inv_sqrt3;
      }
    }

    // ---- Zhang-Shu positivity about the pre-limit mean -------------------
    modal_pos<T>(d, w, ub, Pm);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) out[(long)(c * K + k) * plane + cell] = w[c][k];

    if (lam_part != nullptr) cell_diag(ub, T(1) / T(prm.h), lam, mq);
  }
  if (lam_part != nullptr) block_diag(lam, mq, lam_part, minq_part);
}

// the degrees that take the per-cell kernel (cell_pk_post_kernel): P1-P3
// in float32, P1-P2 in float64, where it ran faster than the tile kernel on
// the H100 (kernel_ab.py, PERF.md; at float32 P3 with a stack frame of
// 280 B, as before the tile kernel); every other degree the tile kernel.  A choice made at build time
// (ops/kernels.PK_POST_CELL_MAX_P mirrors it); kernel_ab.py builds the
// library with other values, -DDFLO_PK_POST_CELL_MAX_P_F32=... and _F64, to
// time both kernels at a degree.  At most 3: the general dims have no
// per-cell form.
#ifndef DFLO_PK_POST_CELL_MAX_P_F32
#define DFLO_PK_POST_CELL_MAX_P_F32 3
#endif
#ifndef DFLO_PK_POST_CELL_MAX_P_F64
#define DFLO_PK_POST_CELL_MAX_P_F64 2
#endif
static_assert(DFLO_PK_POST_CELL_MAX_P_F32 <= 3 &&
                  DFLO_PK_POST_CELL_MAX_P_F64 <= 3,
              "the per-cell Pk post runs on the fixed dims alone");
template <typename T>
constexpr int PK_CELL_MAX_P =
    sizeof(T) > 4 ? DFLO_PK_POST_CELL_MAX_P_F64 : DFLO_PK_POST_CELL_MAX_P_F32;
inline bool pk_post_per_cell(int dtype, int p) {
  return p <= (dtype == 0 ? PK_CELL_MAX_P<float> : PK_CELL_MAX_P<double>);
}

template <typename T, class D>
int launch_tile(const D& d, const PkPostArgs<T>& a, int ty, int tx,
                cudaStream_t stream) {
  if (ty < 1 || tx < 1 || TNT % (ty * tx) != 0) return -1;
  const PkPostGeo g =
      pk_post_geo(d.K, d.QP, (int)sizeof(T), ty, tx, a.ny, a.nx);
  if (g.bytes > MAX_SMEM) return -1;
  if (a.ny < 1 || a.nx < 1) return 0;
  void (*kern)(const PkPostArgs<T>, const D, const PkPostGeo);
  if constexpr (sizeof(T) > 4)
    kern = tile_pk_post_kernel_wide<T, D>;
  else
    kern = tile_pk_post_kernel<T, D>;
  return launch_tile_kernel(kern, g.ntx * g.nty, g.bytes, stream, a, d, g);
}

// the dims d on the kernel PK_CELL_MAX_P picks for their degree (the
// general dims and the fixed dims above it on the tile kernel; the per-cell
// kernel only up to it); the per-cell kernel's "tile" is its BY x BX
// block
template <class D>
constexpr bool FIXED_DIMS = false;
template <int P, bool MODAL>
constexpr bool FIXED_DIMS<BDims<P, MODAL>> = true;

template <typename T, class D>
int launch_pk_post(const D& d, const PkPostArgs<T>& a, int ty, int tx,
                   cudaStream_t stream) {
  if constexpr (FIXED_DIMS<D>) {
    if constexpr (D::P <= PK_CELL_MAX_P<T>) {
      if (ty != BY || tx != BX) return -1;
      if (a.ny < 1 || a.nx < 1) return 0;
      cell_pk_post_kernel<T, D>
          <<<grid_for(a.ny, a.nx), dim3(BX, BY), 0, stream>>>(
              a.u, a.shock, a.Pm, a.out, a.lam_part, a.minq_part, a.ny, a.nx,
              a.prm, d);
      return (int)cudaGetLastError();
    }
  }
  return launch_tile(d, a, ty, tx, stream);
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 with K = (p+1)(p+2)/2 modes
// and qp positivity points (the rows of Pm): p 1-3 take their own
// instantiations (BDims), p 4-6 the general modal dims (GDims, one
// instantiation per dtype; modal.cuh modal_dims_case); the degrees up to
// PK_CELL_MAX_P on the per-cell kernel, every other on the tile kernel.
// beta is the Pk limiter's effective beta (half the configured one).
// ty x tx: the tile (ops/kernels.pk_post_tile; BY x BX for the per-cell
// kernel).  lam_part/minq_part NULL for the form without diag, else one
// entry per tile each (ops/kernels.tile_count).  Returns cudaGetLastError()
// after the launch, -1 for an unsupported case.
extern "C" int dflo_fused_pk_post(int dtype, int p, int K, int qp,
                                  const void* u, const void* shock,
                                  const void* Pm, void* out, void* lam_part,
                                  void* minq_part, int ny, int nx, int per_x,
                                  int per_y, int char_lim, double avg0,
                                  double beta, double Mdx2, double h, int ty,
                                  int tx, void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  const dflo::PkPostParams prm{per_x, per_y, char_lim, avg0, beta, Mdx2, h};
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto zero, const auto& d) {
    using T = decltype(zero);
    const dflo::PkPostArgs<T> a{(const T*)u,  (const T*)shock,
                                (const T*)Pm, (T*)out,
                                (T*)lam_part, (T*)minq_part,
                                ny,           nx,
                                prm};
    return dflo::launch_pk_post<T>(d, a, ty, tx, s);
  };
  // no quadrature is read: nq = p + 1 picks the fixed dims of P1-P3
  return dflo::modal_dims_case(dtype, p, K, p + 1, qp, run);
}

// The dynamic shared memory in bytes of one tile block at degree p (K
// modes, qp positivity points; dtype as above) on the ty x tx tile: 0 for
// the per-cell kernel, -1 for a tile the kernel does not take.  For the
// build's report and the check of ops/kernels.pk_post_smem (chip_smoke.py
// phase 1).
extern "C" int dflo_pk_post_smem(int dtype, int p, int K, int qp, int ty,
                                 int tx) {
  if (p < 1 || p > 6 || K != (p + 1) * (p + 2) / 2 || ty < 1 || tx < 1 ||
      dflo::TNT % (ty * tx) != 0)
    return -1;
  if (dflo::pk_post_per_cell(dtype, p)) return 0;
  return dflo::pk_post_geo(K, qp, dtype ? 8 : 4, ty, tx, 1, 1).bytes;
}
