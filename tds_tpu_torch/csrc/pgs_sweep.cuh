// Projected Gauss-Seidel sweeps over one environment's contact MLCP, spread
// over a group of G lanes of a warp, row i on lane i. Shared by the PGS
// kernel (pgs.cu, K1) and the fused step kernel (megastep.cu, K2), so that
// both do the same arithmetic.
//
// `iterations` sweeps over the N rows of A x = b, continuing from the x[]
// the caller passes (the callers start from x = 0); rows are visited in
// order and each uses the already-updated x[j < i]; row i is clipped to
// [lo_i * s, hi_i * s] with s = max(x[dep_i], 0) when dep_i >= 0 (the
// Coulomb coupling of a friction row to its normal row), else s = 1.
//
// Each lane holds its own row in a LaneRow (K1 loads it from global memory,
// K2 computes it) and the whole x[] in registers. At row i every lane of
// the group evaluates the row update with its own row; lane i's value is
// the one kept, broadcast to the group with __shfl_sync. Lanes past N carry
// a dummy row whose values are discarded. Every lane of the warp must call
// pgs_sweeps the same number of times (the shuffles name the full warp),
// so a group past the end of the batch runs it too.
//
// N is a template parameter so that the row loops unroll fully and x[]
// stays in registers, indexed only by constants: each lane keeps x[dep] of
// its own row in a scalar, taken from x[j] as each x_j is broadcast (a
// select over x by a run-time index would move x to local memory). Each row sums
// A_ij x_j over j != i in increasing j, as the per-thread sweep of the
// first version did, so float64 results differ from it by nothing.

#pragma once

#include <cuda_runtime.h>

// Lane i's row of the problem: A_i., b_i, lo_i, hi_i and dep_i (-1: none).
template <typename T, int N>
struct LaneRow {
  T a[N];
  T b, lo, hi;
  int dep;
};

// Fills x[] from x = 0 and returns x[lane] on lanes below N.
//
// Each lane keeps a running sum of its row over the columns already done
// in this sweep, so that row i waits only for x_{i-1}: lane i's delta is
// that prefix, in increasing j, then (after the first sweep, where every
// x_j with j > i is still 0) the columns j > i in increasing j: the
// order of the plain sweep.
template <typename T, int N, int G>
__device__ __forceinline__ T pgs_sweeps(T (&x)[N], const LaneRow<T, N>& row, int iterations) {
  static_assert(N <= G && (G == 16 || G == 32), "a group of 16 or 32 lanes holds one row per lane");
  const int lane = threadIdx.x % G;
  T mine = T(0);   // x[lane]
  T x_dep = T(0);  // x[row.dep]
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = T(0);
  for (int it = 0; it < iterations; ++it) {
    T prefix = T(0);  // sum of A_lane,j x_j over the columns j < lane done so far
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T delta = prefix;
      if (it > 0) {
#pragma unroll
        for (int j = i + 1; j < N; ++j) delta += row.a[j] * x[j];
      }
      T xi = (row.b - delta) / row.a[i];
      const T s = row.dep >= 0 ? (x_dep > T(0) ? x_dep : T(0)) : T(1);
      // clip(xi, lo*s, hi*s) = min(max(xi, lo*s), hi*s), as jnp.clip
      const T l = row.lo * s;
      const T h = row.hi * s;
      xi = xi < l ? l : xi;
      xi = xi > h ? h : xi;
      x[i] = __shfl_sync(0xffffffffu, xi, i, G);
      mine = lane == i ? x[i] : mine;
      x_dep = row.dep == i ? x[i] : x_dep;
      prefix = lane > i ? prefix + row.a[i] * x[i] : prefix;
    }
  }
  return mine;
}
