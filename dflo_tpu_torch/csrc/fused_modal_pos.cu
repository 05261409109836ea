// Fused modal positivity, hand-written for Hopper as a tile kernel.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_modal_pos (all four
// forms: with and without the truncation to a per-cell degree, with and
// without the diag outputs).  Per cell of a modal Pk state: {truncation to
// deg ->} Zhang-Shu positivity about the mode-0 mean (the same operations
// as the MOOD candidate's staged cells, tile.cuh); with diag, the CFL wave
// speed and min(rho, p) of the mean (truncation keeps mode 0 and Zhang-Shu
// scales about the mean), reduced per tile with NaN-propagating max/min
// into partials the wrapper reduces with torch.amax/amin.
//
// What bounds it on the H100: at f32 the arithmetic (18 positivity points x
// 4 components x 6 modes plus a quadratic per point at p = 2, ~1,600
// operations per cell; 40 x 4 x 15 at p = 4, ~6,800) against 2 x 4K values
// of traffic, so roughly balanced; in f64 the operations.
//
// What the tile design does about it: one block of TNT threads per tile of
// TY x TX cells (ops/kernels.post_tile: in float32 at most 2,000 of a
// component's modes a tile), no ring.
//  1. Stage the tile's 4K planes and its degrees with cp.async.
//  2. The truncation (tile.cuh tile_truncate).
//  3. Zhang-Shu's scale factors with the positivity points' products as
//     register tiles (tile.cuh tile_thetas), the candidate's phase.
//  4. The scaling (mode 0 about the mean, the others toward 0; tile.cuh
//     tile_scale), the diag from the mode-0 means the positivity phase
//     kept, the tile written out coalesced along x and the partials
//     reduced per tile.
// No thread holds a cell's arrays at any degree.  Built with -fmad=false so
// its decisions at the pressure floor match the plain version's.
#include <stdint.h>

#include "tile.cuh"

namespace dflo {

// the operands of one launch
template <typename T>
struct ModalPosArgs {
  const T *u, *Pm;
  const int* deg;
  T *out, *lam_part, *minq_part;
  T avg0, h;
  int ny, nx;
};

// The geometry of a tile and its dynamic shared memory: offsets in
// elements of T of the transposed positivity points PMT [K][QPP] (tile.cuh
// stage_points), the staged modes U [4][K][NC], the points' values SCR
// [QPP][NC], whose first bytes hold the degrees DEG [NC] (int) until the
// truncation has read them, and the per-cell values TPS [7][NC].
// ops/kernels.post_smem mirrors it.
struct ModalPosGeo {
  int TY, TX, NC, ntx, nty, oU, oSCR, oTPS, bytes;
};

inline ModalPosGeo modal_pos_geo(int K, int QP, int tsize, int ty, int tx,
                                 int ny, int nx) {
  ModalPosGeo g{};
  g.TY = ty;
  g.TX = tx;
  g.NC = ty * tx;
  g.ntx = (nx + tx - 1) / tx;
  g.nty = (ny + ty - 1) / ty;
  g.oU = K * pad_points(QP);
  g.oSCR = g.oU + 4 * K * g.NC;
  g.oTPS = g.oSCR + pad_points(QP) * g.NC;
  g.bytes = ((g.oTPS + 7 * g.NC) * tsize + 15) & ~15;
  return g;
}

template <typename T, class D>
__device__ __forceinline__ void tile_modal_pos(const ModalPosArgs<T>& a,
                                               const D& d,
                                               const ModalPosGeo& g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  T* Us = sm + g.oU;
  int* Ds = reinterpret_cast<int*>(sm + g.oSCR);
  const int K = d.K, TX = g.TX, NC = g.NC, tid = threadIdx.x;
  const int tile = blockIdx.x, ny = a.ny, nx = a.nx;
  const int y0 = (tile / g.ntx) * g.TY, x0 = (tile % g.ntx) * TX;
  const long plane = (long)ny * nx;
  const FDiv dTX(TX);
  // the global cell of tile cell j, or -1 past the grid
  auto gcell = [=](int j) {
    const int ly = dTX.q(j), gy = y0 + ly, gx = x0 + j - ly * TX;
    return gy < ny && gx < nx ? (long)gy * nx + gx : -1L;
  };
  auto ident = [](int j) { return j; };

  // ---- 1. stage the positivity points, the tile's modes and degrees
  stage_points(a.Pm, K, d.QP, sm);
  stage_tile<T>(
      Us, NC, 4 * K,
      [&](int j, const T*& src, long& stride) {
        const long gc = gcell(j);
        src = a.u + gc;
        stride = plane;
        return gc >= 0;
      },
      [&](int j) {
        if (a.deg != nullptr) Ds[j] = __ldg(a.deg + gcell(j));
      });

  // ---- 2. the truncation, 3. positivity about the mode-0 mean
  if (a.deg != nullptr) tile_truncate<T>(d, Us, NC, NC, ident, Ds);
  T* tps = sm + g.oTPS;
  tile_thetas<T>(
      d, Us, NC, NC, ident,
      [&](int j, T ub[4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) ub[c] = a.avg0 * Us[c * K * NC + j];
      },
      sm, sm + g.oSCR, tps);
  tile_scale<true, T>(Us, K, NC, NC, ident, tps);

  // ---- 4. the diag of the means, the tile written out, the partials
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  if (a.lam_part != nullptr && tid < NC && gcell(tid) >= 0) {
    T ub[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) ub[c] = tps[c * NC + tid];
    cell_diag(ub, T(1) / a.h, lam, mq);
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

// float32 under the block size alone, float64 allowed 255 registers with
// one block per SM (as residual.cuh's)
template <typename T, class D>
__global__ void __launch_bounds__(TNT)
tile_modal_pos_kernel(const ModalPosArgs<T> a, const D d,
                      const ModalPosGeo g) {
  tile_modal_pos<T, D>(a, d, g);
}

template <typename T, class D>
__global__ void __launch_bounds__(TNT, 1)
tile_modal_pos_kernel_wide(const ModalPosArgs<T> a, const D d,
                           const ModalPosGeo g) {
  tile_modal_pos<T, D>(a, d, g);
}

template <typename T, class D>
int launch_modal_pos(const D& d, const ModalPosArgs<T>& a, int ty, int tx,
                     cudaStream_t stream) {
  if (ty < 1 || tx < 1 || TNT % (ty * tx) != 0) return -1;
  const ModalPosGeo g =
      modal_pos_geo(d.K, d.QP, (int)sizeof(T), ty, tx, a.ny, a.nx);
  if (g.bytes > MAX_SMEM) return -1;
  if (a.ny < 1 || a.nx < 1) return 0;
  void (*kern)(const ModalPosArgs<T>, const D, const ModalPosGeo);
  if constexpr (sizeof(T) > 4)
    kern = tile_modal_pos_kernel_wide<T, D>;
  else
    kern = tile_modal_pos_kernel<T, D>;
  return launch_tile_kernel(kern, g.ntx * g.nty, g.bytes, stream, a, d, g);
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 1..6 with K = (p+1)(p+2)/2 modes
// and qp positivity points (the rows of Pm): p 1-3 take their own
// instantiations (BDims), p 4-6 the general modal dims (GDims, one
// instantiation per dtype; modal.cuh modal_dims_case).  deg NULL:
// positivity only; lam_part/minq_part NULL for the form without diag, else
// one entry per ty x tx tile (ops/kernels.tile_count).  ty x tx: the tile
// (ops/kernels.post_tile).  Returns cudaGetLastError() after the launch,
// -1 for an unsupported case.
extern "C" int dflo_fused_modal_pos(int dtype, int p, int K, int qp,
                                    const void* u, const void* deg,
                                    const void* Pm, void* out, void* lam_part,
                                    void* minq_part, int ny, int nx,
                                    double avg0, double h, int ty, int tx,
                                    void* stream) {
  if ((lam_part == nullptr) != (minq_part == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto zero, const auto& d) {
    using T = decltype(zero);
    const dflo::ModalPosArgs<T> a{(const T*)u,     (const T*)Pm,
                                  (const int*)deg, (T*)out,
                                  (T*)lam_part,    (T*)minq_part,
                                  T(avg0),         T(h),
                                  ny,              nx};
    return dflo::launch_modal_pos<T>(d, a, ty, tx, s);
  };
  // no quadrature is read: nq = p + 1 picks the fixed dims of P1-P3
  return dflo::modal_dims_case(dtype, p, K, p + 1, qp, run);
}

// The dynamic shared memory in bytes of one block at K modes and qp
// positivity points (dtype as above) on the ty x tx tile; -1 for a tile the
// kernel does not take.  For the build's report and the check of
// ops/kernels.post_smem (chip_smoke.py phase 1).
extern "C" int dflo_modal_pos_smem(int dtype, int K, int qp, int ty, int tx) {
  if (K < 1 || K > dflo::K_MAX || ty < 1 || tx < 1 ||
      dflo::TNT % (ty * tx) != 0)
    return -1;
  return dflo::modal_pos_geo(K, qp, dtype ? 8 : 4, ty, tx, 1, 1).bytes;
}
