// Fused MOOD acceptance check, hand-written for Hopper.
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
// neighbors' D2).  Each 32 x 4 block stages its tile's D2 planes with a
// two-cell halo in shared memory, evaluates fail and spread flags on the
// tile plus a one-cell ring, then each thread combines its own and its
// neighbors' flags.  Neighbors wrap only on periodic sides: off-domain halo
// cells are neither tested nor spread from, and the validity of every
// neighbor arm follows the global edges (the trap of 2561b31, where a
// wrapping spread silently stopped the cascade).
//
// What bounds it on the H100: bytes, a few planes in and three out with a
// few comparisons per cell.  The outputs are integers and flags; the
// comparisons are the plain version's IEEE operations, so kernel and plain
// version agree bitwise.
#include <stdint.h>

#include "euler.cuh"

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

template <typename T>
__global__ void __launch_bounds__(BX * BY)
fused_mood_check_kernel(const T* __restrict__ u, int K, int p,
                        const T* __restrict__ dmin, const T* __restrict__ dmax,
                        const int* __restrict__ deg,
                        const uint8_t* __restrict__ lim,
                        int* __restrict__ deg_out, uint8_t* __restrict__ lim_out,
                        uint8_t* __restrict__ chg_out, int ny, int nx,
                        int per_x, int per_y, T avg0) {
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

template <typename T>
static int launch(const void* u, int K, int p, const void* dmin,
                  const void* dmax, const void* deg, const void* lim,
                  void* deg_out, void* lim_out, void* chg_out, int ny, int nx,
                  int per_x, int per_y, double avg0, cudaStream_t stream) {
  fused_mood_check_kernel<T><<<grid_for(ny, nx), dim3(BX, BY), 0, stream>>>(
      (const T*)u, K, p, (const T*)dmin, (const T*)dmax, (const int*)deg,
      (const uint8_t*)lim, (int*)deg_out, (uint8_t*)lim_out, (uint8_t*)chg_out,
      ny, nx, per_x, per_y, T(avg0));
  return (int)cudaGetLastError();
}

}  // namespace dflo

// dtype: 0 = float32, 1 = float64; p in 2..6 (the u2 test reads the D2
// modes 2 and 2p+1 of the K = (p+1)(p+2)/2; below p = 2 the reference has
// no check kernel and runs its plain check with the u2 test off).  lim,
// lim_out and chg_out hold one byte (0/1) per cell.  Returns
// cudaGetLastError() after the launch, -1 for an unsupported case.
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
                                lim_out, chg_out, ny, nx, per_x, per_y, avg0, s);
  return -1;
}
