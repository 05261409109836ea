// Fused step diagnostics, hand-written for Hopper.
//
// Replaces: dflo_tpu/ops/pallas_kernels.py make_fused_diag (single chip),
// masked or not, for any basis.  Per cell, from its cell average: the CFL
// wave speed (c + |vx|)/h + (c + |vy|)/h (compute_time_step_cartesian,
// src/claw.cc:483-512) and min(rho, p) for the fatal-negativity flag
// (src/positivity.cc:26-39).  On a masked domain a solid cell (uint8 fluid
// flag 0) counts as lam = 0 and min(rho, p) = inf, so it enters neither
// reduction (pallas_kernels.py:1675-1710).  The reductions are
// NaN-propagating max/min (a NaN cell must reach the driver's
// bad = ~(minq >= EPS)).
//
// The cell average: on a modal Pk basis mode 0 carries the mean (the other
// entries of the mean-weight row wq2 @ V are quadrature round-off), so the
// kernel reads the four mode-0 planes alone and the mean is avg[0] * u[c][0]
// (K = 0 below), as the reference's XLA path and its Pk post take it
// (dflo_tpu/driver.py:371-377, pallas_kernels.py:2026-2029).  A nodal
// basis (Qk, GLL, either over-integrated) reads its full row,
// sum_k avg[k] u[c][k], in k order (contract.basis_reduce).
//
// What bounds it on the H100: bytes, one read of the planes the mean needs
// and almost no arithmetic.  One launch per call: a grid-stride loop over
// one wave of blocks (the SMs times the blocks an SM holds, at most the
// workspace's: ops/kernels.diag_grid), each thread a
// run of RUN adjacent cells in x with 16-byte loads (float4, two double2;
// the mask as uchar4) where the rows' length and the pointers allow,
// element loads otherwise.  Each block reduces its cells and writes one
// pair of partials into a workspace the caller owns; the last block to
// finish (a __threadfence and an atomic ticket that wraps to 0 for the
// next launch) reduces the partials and writes (lam, minq).  Max and min
// are exact, so the result is the plain version's.
#include <stdint.h>

#include "euler.cuh"

namespace dflo {

constexpr int DIAG_THREADS = 256;   // ops/kernels.DIAG_THREADS
constexpr int DIAG_RUN = 4;         // cells per run, ops/kernels.DIAG_RUN
constexpr int DIAG_WARPS = DIAG_THREADS / 32;

// RUN values of one plane from p (16-byte aligned where VEC) into v; the
// cells past the row's end (n < RUN, element loads only) read as 0
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int n,
                                         T v[DIAG_RUN]) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < DIAG_RUN; ++i) v[i] = i < n ? __ldg(p + i) : T(0);
  }
}

// NaN-propagating max of lam and min of mq over the block, valid in
// thread 0 (every thread calls it; the shared slots may be reused after
// the next __syncthreads)
template <typename T>
__device__ __forceinline__ void block_reduce(T& lam, T& mq, T* s_lam,
                                             T* s_mq) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lam = nmax(lam, __shfl_down_sync(0xffffffffu, lam, off));
    mq = nmin(mq, __shfl_down_sync(0xffffffffu, mq, off));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lam[threadIdx.x >> 5] = lam;
    s_mq[threadIdx.x >> 5] = mq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < DIAG_WARPS; ++w) {
      lam = nmax(lam, s_lam[w]);
      mq = nmin(mq, s_mq[w]);
    }
  }
}

// K: the nodal row's length, or 0 for the mode-0 mean of a state of
// k_state modes.  VEC: nx % RUN == 0 and u (and the mask) 16-byte (4-byte)
// aligned; three blocks an SM (two for the element loads, which a ragged
// grid takes: their guards spilled at three).  part: 2 * gridDim.x partials (lam, then minq); ticket: the
// zeroed unsigned counter; out: (lam_max, minq).
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(DIAG_THREADS, VEC ? 3 : 2)
fused_diag_kernel(const T* __restrict__ u, const T* __restrict__ avg,
                  const uint8_t* __restrict__ mask, T* __restrict__ part,
                  unsigned* __restrict__ ticket, T* __restrict__ out, int ny,
                  int nx, int k_state, T h) {
  __shared__ T s_lam[DIAG_WARPS];
  __shared__ T s_mq[DIAG_WARPS];
  __shared__ bool s_last;
  const int runs_x = (nx + DIAG_RUN - 1) / DIAG_RUN;
  const long runs = (long)ny * runs_x;
  const long plane = (long)ny * nx;
  const T inv_h = T(1) / h;
  T lam = T(-INFINITY), mq = T(INFINITY);   // identities of the reductions
  for (long r = (long)blockIdx.x * DIAG_THREADS + threadIdx.x; r < runs;
       r += (long)gridDim.x * DIAG_THREADS) {
    const int y = (int)(r / runs_x);
    const int x0 = (int)(r - (long)y * runs_x) * DIAG_RUN;
    const int n = min(DIAG_RUN, nx - x0);
    const long cell = (long)y * nx + x0;
    T ub[4][DIAG_RUN];
    if constexpr (K == 0) {
      const T a0 = __ldg(avg);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T v[DIAG_RUN];
        load_run<T, VEC>(u + (long)c * k_state * plane + cell, n, v);
#pragma unroll
        for (int i = 0; i < DIAG_RUN; ++i) ub[c][i] = a0 * v[i];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T v[DIAG_RUN];
        load_run<T, VEC>(u + (long)(c * K) * plane + cell, n, v);
        const T a0 = __ldg(avg);
#pragma unroll
        for (int i = 0; i < DIAG_RUN; ++i) ub[c][i] = a0 * v[i];
        // a few planes' loads in flight per step (registers for no more)
#pragma unroll(sizeof(T) == 4 ? 4 : 2)
        for (int k = 1; k < K; ++k) {
          load_run<T, VEC>(u + (long)(c * K + k) * plane + cell, n, v);
          const T ak = __ldg(avg + k);
#pragma unroll
          for (int i = 0; i < DIAG_RUN; ++i) ub[c][i] = ub[c][i] + ak * v[i];
        }
      }
    }
    uint8_t fluid[DIAG_RUN] = {1, 1, 1, 1};
    if (mask != nullptr) {
      if constexpr (VEC) {
        const uchar4 f = __ldg(reinterpret_cast<const uchar4*>(mask + cell));
        fluid[0] = f.x; fluid[1] = f.y; fluid[2] = f.z; fluid[3] = f.w;
      } else {
#pragma unroll
        for (int i = 0; i < DIAG_RUN; ++i)
          fluid[i] = i < n ? __ldg(mask + cell + i) : uint8_t(1);
      }
    }
#pragma unroll
    for (int i = 0; i < DIAG_RUN; ++i) {
      if (i >= n) break;
      const T w[4] = {ub[0][i], ub[1][i], ub[2][i], ub[3][i]};
      T l, m;
      cell_diag(w, inv_h, l, m);
      if (fluid[i] == 0) {
        l = T(0);
        m = T(INFINITY);
      }
      lam = nmax(lam, l);
      mq = nmin(mq, m);
    }
  }
  block_reduce(lam, mq, s_lam, s_mq);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = lam;
    part[gridDim.x + blockIdx.x] = mq;
    __threadfence();   // the partials before the ticket, device-wide
    // atomicInc wraps the ticket to 0 at the last block: the workspace is
    // ready for the next launch without a reset of its own
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  lam = T(-INFINITY);
  mq = T(INFINITY);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += DIAG_THREADS) {
    lam = nmax(lam, __ldcg(part + b));   // past L1: other SMs wrote them
    mq = nmin(mq, __ldcg(part + gridDim.x + b));
  }
  block_reduce(lam, mq, s_lam, s_mq);
  if (threadIdx.x == 0) {
    out[0] = lam;
    out[1] = mq;
  }
}

// the blocks the current device holds at once: its SMs times per_sm, the
// blocks of a kernel one SM holds (0 on an error)
static int wave_of(int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

// one wave: at most the blocks the card holds at once (from the kernel's
// registers, asked once per instantiation: the same on every H100), and at
// most `blocks` (the workspace's partials)
template <typename T, int K, bool VEC>
static int launch_one(const void* u, const void* avg, const void* mask,
                      void* part, void* ticket, void* out, int ny, int nx,
                      int k_state, int blocks, double h, cudaStream_t stream) {
  auto kern = fused_diag_kernel<T, K, VEC>;
  static int per_sm = 0;
  if (per_sm < 1) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, DIAG_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int wave = wave_of(per_sm);
  if (wave < 1) return -1;
  kern<<<min(blocks, wave), DIAG_THREADS, 0, stream>>>(
      (const T*)u, (const T*)avg, (const uint8_t*)mask, (T*)part,
      (unsigned*)ticket, (T*)out, ny, nx, k_state, T(h));
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int launch(const void* u, const void* avg, const void* mask,
                  void* part, void* ticket, void* out, int ny, int nx,
                  int k_state, int blocks, double h, cudaStream_t stream) {
  const bool vec = nx % DIAG_RUN == 0 && (uintptr_t)u % 16 == 0 &&
                   (uintptr_t)mask % 4 == 0;
  return vec ? launch_one<T, K, true>(u, avg, mask, part, ticket, out, ny,
                                      nx, k_state, blocks, h, stream)
             : launch_one<T, K, false>(u, avg, mask, part, ticket, out, ny,
                                       nx, k_state, blocks, h, stream);
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; K: the DoFs per cell of u [4, K, ny,
// nx]; mode0: 1 for the modal Pk mean avg[0] * mode 0 (any K), 0 for a
// nodal row of K in {4, 9, 16, 25, 36, 49} (Qk and GLL, p = 1..6, on any
// quadrature); avg: the mean-weight row [K]; mask: uint8 [ny, nx] fluid
// flags, or NULL; part: 2 * blocks partials of u's dtype; ticket: one
// unsigned, 0 before the first launch (each launch leaves it at 0); out:
// (lam_max, minq) in u's dtype; blocks: the most blocks, the workspace's
// (ops/kernels.diag_grid), of which the kernel takes at most one wave.
// Returns cudaGetLastError() after the launch, -1 for an unsupported case.
extern "C" int dflo_fused_diag(int dtype, int K, int mode0, const void* u,
                               const void* avg, const void* mask, void* part,
                               void* ticket, void* out, int ny, int nx,
                               int blocks, double h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks < 1 || ny < 1 || nx < 1) return -1;
#define DFLO_CASE(T, KK)                                                   \
  return dflo::launch<T, KK>(u, avg, mask, part, ticket, out, ny, nx, K,   \
                             blocks, h, s)
#define DFLO_SIZES(T)              \
  {                                \
    if (mode0) DFLO_CASE(T, 0);    \
    switch (K) {                   \
      case 4: DFLO_CASE(T, 4);     \
      case 9: DFLO_CASE(T, 9);     \
      case 16: DFLO_CASE(T, 16);   \
      case 25: DFLO_CASE(T, 25);   \
      case 36: DFLO_CASE(T, 36);   \
      case 49: DFLO_CASE(T, 49);   \
      default: return -1;          \
    }                              \
  }
  if (dtype == 0) DFLO_SIZES(float)
  if (dtype == 1) DFLO_SIZES(double)
#undef DFLO_SIZES
#undef DFLO_CASE
  return -1;
}

// The thread block of the per-cell kernels (the Pk post, the check and the
// per-cell post), axis 0 its rows (BY), 1 its columns (BX): their diag
// partials number these blocks, which ops/kernels.BLOCK mirrors (checked
// in chip_smoke.py phase 1).
extern "C" int dflo_block_dims(int axis) {
  return axis == 0 ? dflo::BY : dflo::BX;
}
