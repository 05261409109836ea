// Collocated volume residual, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py volume_residual (kernel body
// _volume_kernel, pallas_kernels.py:115-137): the Euler fluxes at the K
// collocated nodes of each cell (the DoFs are the point values), then the
// stacked lift R[c][m] = sum_k L[m][k] Fx[c][k] + L[m][K + k] Fy[c][k] with
// L = [dy GxW^T | dx GyW^T], as the TPU kernel does in its own body (no
// library matrix product).  It is the volume term of the plain residual of
// solver/spatial.make_rhs(volume_kernel="pallas").
//
// What bounds it on the H100: bytes, 4K values read and 4K written per
// cell.  The lift of a collocated Qk basis is a tensor product: node
// m = (im, jm) (x fastest, k = i + N j with N = p + 1) takes its x
// derivative from the N nodes of its own row and its y derivative from
// the N nodes of its own column, so a row of L holds 2N nonzero entries of
// its 2K (ops/kernels.check_volume_lift checks that once, on the host).
//
// The tile kernel (tile_volume_kernel, the degrees above the build-time
// cap CELL_MAX_P; one instantiation per degree): one block of VOL_THREADS
// threads per tile of TX = TILE_X cells along x of one row.
//   A. threads over (node k, cell) pairs load the node's four values
//      (each plane coalesced along x), compute its fluxes once and store
//      Fx and Fy to shared memory as [dir][c][k][cell];
//   B. threads over (output node m, cell) pairs sum m's row and column
//      entries, reading the 2N coefficients of row m from a table staged
//      in shared memory (a warp shares m: TX is a multiple of 32), and
//      write the four results coalesced along x.
// No per-thread cell arrays: the accumulators are four registers.  The
// sum walks m's nonzero k in ascending order, the x term before the y term
// at the k where m's row and column cross: the plain version's order
// (kernels.volume_residual_plain, per node its x then its y column) with
// its exact zeros left out, which adds nothing on a finite state; with
// -fmad=false the result is the plain version's.
//
// The per-cell kernel (cell_volume_kernel, p <= CELL_MAX_P): a thread per
// cell on a BY x BX block, the cell's 4K accumulators in registers, the
// whole [K, 2K] lift read with its zeros skipped at a branch the warp
// shares; the same order.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

constexpr int VOL_THREADS = 256;   // ops/kernels.TILE_THREADS
// the tile kernel's cells along x (ops/kernels.VOLUME_TILE_X): one warp's
// worth, the fastest of 32, 64 and 128 at Q4-Q6 in both dtypes on the H100
// (kernel_ab.py, PERF.md)
constexpr int TILE_X = 32;

// The degrees whose volume residual runs the per-cell kernel, a choice made
// at build time (ops/kernels.VOLUME_CELL_MAX_P mirrors it): float32 Q1-Q2
// and float64 Q1, where it ran faster than the tile kernel on the H100
// (kernel_ab.py, PERF.md); kernel_ab.py builds the library with other
// values, -DDFLO_VOLUME_CELL_MAX_P_F32=... and _F64, to time both kernels.
#ifndef DFLO_VOLUME_CELL_MAX_P_F32
#define DFLO_VOLUME_CELL_MAX_P_F32 2
#endif
#ifndef DFLO_VOLUME_CELL_MAX_P_F64
#define DFLO_VOLUME_CELL_MAX_P_F64 1
#endif
static_assert(DFLO_VOLUME_CELL_MAX_P_F32 <= 3 &&
                  DFLO_VOLUME_CELL_MAX_P_F64 <= 3,
              "the per-cell volume kernel holds its accumulators in "
              "registers up to Q3");
template <typename T>
constexpr int CELL_MAX_P =
    sizeof(T) > 4 ? DFLO_VOLUME_CELL_MAX_P_F64 : DFLO_VOLUME_CELL_MAX_P_F32;

// ---------------------------------------------------------------------------
// the per-cell kernel (Q1-Q3 up to the cap)
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(BX * BY)
cell_volume_kernel(const T* __restrict__ u, const T* __restrict__ L,
                   T* __restrict__ out, int ny, int nx) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long plane = (long)ny * nx;
  const long cell = (long)y * nx + x;
  T R[4][K];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < K; ++m) R[c][m] = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T w[4], fx[4], fy[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = __ldg(u + (long)(c * K + k) * plane + cell);
    flux_xy(w, fx, fy);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const T lx = __ldg(L + m * 2 * K + k);
      const T ly = __ldg(L + m * 2 * K + K + k);
      if (lx != T(0))
#pragma unroll
        for (int c = 0; c < 4; ++c) R[c][m] = R[c][m] + lx * fx[c];
      if (ly != T(0))
#pragma unroll
        for (int c = 0; c < 4; ++c) R[c][m] = R[c][m] + ly * fy[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int m = 0; m < K; ++m) out[(long)(c * K + m) * plane + cell] = R[c][m];
}

// ---------------------------------------------------------------------------
// the tile kernel
// ---------------------------------------------------------------------------

// dynamic shared memory of a tile of tx cells at degree p (ops/kernels
// .volume_smem): the fluxes [2][4][K][tx] and the coefficient table
// [K][2N], in T
template <typename T>
constexpr int tile_smem(int p, int tx) {
  return (8 * (p + 1) * (p + 1) * tx + 2 * (p + 1) * (p + 1) * (p + 1)) *
         (int)sizeof(T);
}

template <typename T, int P, int TX>
__global__ void __launch_bounds__(VOL_THREADS)
tile_volume_kernel(const T* __restrict__ u, const T* __restrict__ L,
                   T* __restrict__ out, int ny, int nx) {
  constexpr int N = P + 1, K = N * N;
  constexpr int ITER = (K * TX + VOL_THREADS - 1) / VOL_THREADS;
  static_assert(TX % 32 == 0, "a warp's cells share one node");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Fx = reinterpret_cast<T*>(smem_raw);   // [4][K][TX]
  T* Fy = Fx + 4 * K * TX;                  // [4][K][TX]
  T* C = Fy + 4 * K * TX;                   // [K][2N]: row, then column
  const int tiles_x = (nx + TX - 1) / TX;
  const int y = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x - y * tiles_x) * TX;
  const int nc = min(TX, nx - x0);          // the tile's cells
  const long plane = (long)ny * nx;
  const long base = (long)y * nx + x0;
  for (int i = threadIdx.x; i < K * 2 * N; i += VOL_THREADS) {
    const int m = i / (2 * N), a = i - m * (2 * N);
    const int im = m % N, jm = m / N;
    C[i] = a < N ? __ldg(L + m * 2 * K + N * jm + a)
                 : __ldg(L + m * 2 * K + K + im + N * (a - N));
  }
  // A: the fluxes at every (node, cell) of the tile (four iterations'
  // loads in flight)
#pragma unroll 4
  for (int it = 0; it < ITER; ++it) {
    const int i = it * VOL_THREADS + threadIdx.x;
    const int k = i / TX, cx = i - k * TX;
    if (i < K * TX && cx < nc) {
      T w[4], fx[4], fy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = __ldg(u + (long)(c * K + k) * plane + base + cx);
      flux_xy(w, fx, fy);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Fx[(c * K + k) * TX + cx] = fx[c];
        Fy[(c * K + k) * TX + cx] = fy[c];
      }
    }
  }
  __syncthreads();
  // B: each (output node, cell) from its row and column
#pragma unroll 1
  for (int it = 0; it < ITER; ++it) {
    const int i = it * VOL_THREADS + threadIdx.x;
    const int m = i / TX, cx = i - m * TX;
    if (i >= K * TX || cx >= nc) continue;
    const int im = m % N, jm = m / N;
    const T* Cm = C + m * 2 * N;
    T R[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int b = 0; b < N; ++b) {
      if (b != jm) {          // column node (im, b), y term only
        const T ly = Cm[N + b];
        const int k = im + N * b;
#pragma unroll
        for (int c = 0; c < 4; ++c) R[c] = R[c] + ly * Fy[(c * K + k) * TX + cx];
      } else {                // m's row, and at k = m its column entry
#pragma unroll
        for (int a = 0; a < N; ++a) {
          const T lx = Cm[a];
          const int k = N * jm + a;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            R[c] = R[c] + lx * Fx[(c * K + k) * TX + cx];
          if (a == im) {
            const T ly = Cm[N + jm];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              R[c] = R[c] + ly * Fy[(c * K + k) * TX + cx];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(long)(c * K + m) * plane + base + cx] = R[c];
  }
}

template <typename T, int P, int TX>
static int launch_tile(const void* u, const void* L, void* out, int ny,
                       int nx, cudaStream_t stream) {
  auto kern = tile_volume_kernel<T, P, TX>;
  const int bytes = tile_smem<T>(P, TX);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = ny * ((nx + TX - 1) / TX);
  kern<<<blocks, VOL_THREADS, bytes, stream>>>((const T*)u, (const T*)L,
                                               (T*)out, ny, nx);
  return (int)cudaGetLastError();
}

// degree P on the kernel CELL_MAX_P picks: the per-cell kernel (tx = 0)
// or the tile kernel on TILE_X cells (tx = TILE_X)
template <typename T, int P>
static int launch(const void* u, const void* L, void* out, int ny, int nx,
                  int tx, cudaStream_t stream) {
  if constexpr (P <= CELL_MAX_P<T>) {
    if (tx != 0) return -1;
    constexpr int K = (P + 1) * (P + 1);
    cell_volume_kernel<T, K><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
        (const T*)u, (const T*)L, (T*)out, ny, nx);
    return (int)cudaGetLastError();
  } else {
    if (tx != TILE_X) return -1;
    return launch_tile<T, P, TILE_X>(u, L, out, ny, nx, stream);
  }
}

template <typename T>
static int launch_degree(int p, const void* u, const void* L, void* out,
                         int ny, int nx, int tx, cudaStream_t s) {
  switch (p) {
    case 1: return launch<T, 1>(u, L, out, ny, nx, tx, s);
    case 2: return launch<T, 2>(u, L, out, ny, nx, tx, s);
    case 3: return launch<T, 3>(u, L, out, ny, nx, tx, s);
    case 4: return launch<T, 4>(u, L, out, ny, nx, tx, s);
    case 5: return launch<T, 5>(u, L, out, ny, nx, tx, s);
    case 6: return launch<T, 6>(u, L, out, ny, nx, tx, s);
    default: return -1;
  }
}

inline int degree_of(int K) {
  for (int p = 1; p <= 6; ++p)
    if ((p + 1) * (p + 1) == K) return p;
  return 0;
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; K in {4, 9, 16, 25, 36, 49}
// (collocated Q1-Q6); L: the [K, 2K] lift in u's dtype, nonzero only on
// the tensor-product pattern (kernels.check_volume_lift); tx: the tile's
// cells along x (ops/kernels.volume_tile), 0 for the degrees up to the
// per-cell cap.  Returns cudaGetLastError() after the launch, -1 for an
// unsupported case (a tx the degree does not take included).
extern "C" int dflo_volume_residual(int dtype, int K, const void* u,
                                    const void* L, void* out, int ny, int nx,
                                    int tx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int p = dflo::degree_of(K);
  if (p == 0 || ny < 1 || nx < 1) return -1;
  if (dtype == 0)
    return dflo::launch_degree<float>(p, u, L, out, ny, nx, tx, s);
  if (dtype == 1)
    return dflo::launch_degree<double>(p, u, L, out, ny, nx, tx, s);
  return -1;
}

// the dynamic shared memory per block of the volume residual at K (Q1-Q6),
// 0 where the degree runs the per-cell kernel (ops/kernels.volume_smem
// mirrors it; chip_smoke.py phase 1 checks)
extern "C" int dflo_volume_smem(int dtype, int K) {
  const int p = dflo::degree_of(K);
  if (p == 0) return -1;
  if (dtype == 0)
    return p <= dflo::CELL_MAX_P<float> ? 0
                                        : dflo::tile_smem<float>(p, dflo::TILE_X);
  return p <= dflo::CELL_MAX_P<double> ? 0
                                       : dflo::tile_smem<double>(p, dflo::TILE_X);
}
