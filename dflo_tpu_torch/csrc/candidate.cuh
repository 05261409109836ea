// The MOOD candidate, shared by fused_mood_candidate.cu (hllc) and
// fused_mood_candidate_{lxf,roe,sw,kfvs,kep}.cu: one source per flux so
// that nvcc builds the six fluxes' instantiations side by side.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_residual(...).sparse
// (the sparse MOOD re-update, :945-1056, a 1-D pallas grid over a compact
// list of the affected tiles, :945-953).
//
// What bounds it on the H100: operations on the flagged tiles.  Per staged
// cell the {truncation -> positivity} chain (QP positivity points x 4
// components x K modes plus a quadratic per point), then the residual of
// residual.cuh; bytes are u_pre's tiles and one write of the set cells.
//
// What the design does about it: the residual's tile kernel with TP = true
// (residual.cuh), launched over a compact list of the tiles that hold a set
// cell, which the entry point builds on the device first (tile_list_kernel:
// indices and a count, no host sync, no nonzero(); its plain twin is
// ops/kernels.tile_list_plain).  Block b takes list entry b and exits past
// the count, so the work scales with the flagged tiles and an empty set
// does no tile work.  Each staged cell's chain runs once per tile (not once
// per cell and neighbour), its positivity points spread over the threads
// (tile.cuh tile_thetas).
// Unset cells keep u_prev: the kernel writes in place and reads only u_pre
// (the analogue of the TPU's input_output_aliases, :1044).  Each flux's
// source instantiates its fixed P1-P3 candidates and its one general
// candidate per dtype (GDims<true>: degrees 4-6 and the over-integrated Pk
// bases), as residual.cuh's launch_general does for the residual.
#pragma once

#include <stdint.h>

#include "residual.cuh"

namespace dflo {

// The compact list of the ty x tx tiles that hold a set cell of `cells`:
// one thread per tile; a set tile takes the next slot of `list` through an
// atomic on count[0] (zeroed before the launch), so the list's order varies
// from run to run and does not matter: each tile's block writes only its
// own cells.
static __global__ void __launch_bounds__(256)
tile_list_kernel(const uint8_t* __restrict__ cells, int ny, int nx, int ty,
                 int tx, int ntx, int ntiles, int* __restrict__ list,
                 int* __restrict__ count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const int y0 = (t / ntx) * ty, x0 = (t % ntx) * tx;
  const int y1 = y0 + ty < ny ? y0 + ty : ny;
  const int x1 = x0 + tx < nx ? x0 + tx : nx;
  bool any = false;
  for (int y = y0; y < y1 && !any; ++y)
    for (int x = x0; x < x1; ++x)
      any |= __ldg(cells + (long)y * nx + x) != 0;
  if (any) list[atomicAdd(count, 1)] = t;
}

// Zero the count and build the list; list holds ceil(ny/ty) ceil(nx/tx)
// slots.  Returns cudaGetLastError() after the launch.
static inline int launch_tile_list(const uint8_t* cells, int ny, int nx,
                                   int ty, int tx, int* list, int* count,
                                   cudaStream_t s) {
  if (ty < 1 || tx < 1) return -1;
  const int ntx = (nx + tx - 1) / tx, ntiles = ntx * ((ny + ty - 1) / ty);
  const cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (ntiles > 0)
    tile_list_kernel<<<(ntiles + 255) / 256, 256, 0, s>>>(
        cells, ny, nx, ty, tx, ntx, ntiles, list, count);
  return (int)cudaGetLastError();
}

// The operands of one candidate launch (the C entry point's pointers).
struct CandArgs {
  const void *u, *deg, *cells;
  void *list, *count;   // scratch of the tile list (launch_tile_list)
  const void *dfw, *dfe, *dfs, *dfn, *dt, *ops, *Pm;
  double avg0;
  int ny, nx, ty, tx;
  void* out;
};

template <typename T, int FLUX, class D>
int launch_candidate(const D& d, const CandArgs& c, cudaStream_t stream) {
  TileArgs<T> a{};
  a.u = (const T*)c.u;
  a.deg = (const int*)c.deg;
  a.cells = (const uint8_t*)c.cells;
  a.list = (const int*)c.list;
  a.count = (const int*)c.count;
  a.dfw = (const T*)c.dfw;
  a.dfe = (const T*)c.dfe;
  a.dfs = (const T*)c.dfs;
  a.dfn = (const T*)c.dfn;
  a.sc = (const T*)c.dt;
  a.ops = (const T*)c.ops;
  a.Pm = (const T*)c.Pm;
  a.avg0 = T(c.avg0);
  a.out = (T*)c.out;
  a.ny = c.ny;
  a.nx = c.nx;
  return launch_tiles<T, FLUX, SRC_NONE, true>(d, a, SRC_NONE, c.ty, c.tx,
                                               stream);
}

// The launch table of one flux's candidate.  dtype: 0 = float32,
// 1 = float64; the modal Pk basis of degree p (1..6, K = (p+1)(p+2)/2
// modes) on nq x nq quadrature points (nq <= NQ_MAX), with qp positivity
// points (the rows of Pm).  Degrees 1-3 on their default quadrature
// (nq = p + 1) take their own instantiations (BDims); every other basis
// (degrees 4-6, and any over-integrated Pk basis, whose operator buffer
// and strips are laid out for its nq) the flux's general candidate
// (GDims<true>: sizes, the degree and the positivity points read at run
// time; one instantiation per dtype, compiled only in this flux's source;
// modal.cuh modal_dims_case).  list holds the ty x tx tiles (row-major,
// ceil(nx/tx) per row) that hold a set cell and count[0] their number,
// both built here (launch_tile_list) before the tile kernel's launch;
// cells one byte per cell; out is u_prev, updated in place.  Returns
// cudaGetLastError() after the launches, -1 for an unsupported case.
template <int FLUX>
int candidate_entry(int dtype, int p, int K, int nq, int qp,
                    const CandArgs& a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return modal_dims_case(dtype, p, K, nq, qp, [&](auto zero, const auto& d) {
    const int e = launch_tile_list((const uint8_t*)a.cells, a.ny, a.nx, a.ty,
                                   a.tx, (int*)a.list, (int*)a.count, s);
    if (e != 0) return e;
    return launch_candidate<decltype(zero), FLUX>(d, a, s);
  });
}

}  // namespace dflo

// The C entry point of one flux's candidate (FLUX) under the name NAME;
// arguments as dflo::candidate_entry, ty x tx the tile of the list.
#define DFLO_CANDIDATE_ENTRY(NAME, FLUX)                                    \
  extern "C" int NAME(int dtype, int p, int K, int nq, int qp,              \
                      const void* u, const void* deg, const void* cells,    \
                      void* list, void* count, const void* dfw,             \
                      const void* dfe, const void* dfs, const void* dfn,    \
                      const void* dt, const void* ops, const void* Pm,      \
                      double avg0, int ny, int nx, int ty, int tx,          \
                      void* out, void* stream) {                            \
    const dflo::CandArgs a{u,  deg, cells, list, count, dfw, dfe, dfs, dfn, \
                           dt, ops, Pm,    avg0, ny,    nx,  ty,  tx,  out}; \
    return dflo::candidate_entry<FLUX>(dtype, p, K, nq, qp, a, stream);     \
  }
