// Projected Gauss-Seidel sweeps over one environment's contact MLCP, spread
// over a group of G lanes of a warp, row i on lane i. Shared by the PGS
// kernel (pgs.cu, K1) and the fused step kernel (megastep.cu, K2), so that
// both do the same arithmetic.
//
// `iterations` sweeps over the N rows of A x = b, from x = 0 or (Warm)
// from the x[] the caller passes; rows are visited in order and each uses
// the already-updated x[j < i]; row i is clipped to
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

// Fills x[] from x = 0 and returns x[lane] on lanes below N. With Warm
// the sweeps start from the x[] the caller filled (the warm start x0),
// `mine` its x[lane] and `x_dep` its x[row.dep] (0 without a dependency);
// the zero start's instantiations (Warm false, K1's and K2's) take neither.
//
// Each lane keeps a running sum of its row over the columns already done
// in this sweep, so that row i waits only for x_{i-1}: lane i's delta is
// that prefix, in increasing j, then (after the first sweep, where from
// x = 0 every x_j with j > i is still 0, or from a warm start) the
// columns j > i in increasing j: the order of the plain sweep.
template <typename T, int N, int G, bool Warm = false>
__device__ __forceinline__ T pgs_sweeps(T (&x)[N], const LaneRow<T, N>& row, int iterations, T mine = T(0),
                                        T x_dep = T(0)) {
  static_assert(N <= G && (G == 16 || G == 32), "a group of 16 or 32 lanes holds one row per lane");
  const int lane = threadIdx.x % G;
  if (!Warm) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T(0);
  }
  for (int it = 0; it < iterations; ++it) {
    T prefix = T(0);  // sum of A_lane,j x_j over the columns j < lane done so far
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T delta = prefix;
      if (Warm || it > 0) {
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

// d max(x, 0) / dx with jnp.maximum's tie rule: 1, 1/2 at x = 0, else 0.
template <typename T>
__device__ __forceinline__ T relu_slope(T x) {
  return x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
}

// x = min(max(p, l), h)'s partial derivatives in p, l and h, with
// jnp.maximum's and jnp.minimum's tie rule (a tie gives each side half, so
// clip(0, 0, 0) gives 1/4, 1/4 and 1/2): each in {0, 1/4, 1/2, 1}. The
// JVP of the clip is mp p' + ml l' + mh h'; its VJP for an adjoint g is
// (mp g, ml g, mh g).
template <typename T>
__device__ __forceinline__ void clip_factors(T p, T l, T h, T& mp, T& ml, T& mh) {
  const T m = p > l ? p : l;
  const T mm = m < h ? T(1) : (m > h ? T(0) : T(0.5));
  mh = m < h ? T(0) : (m > h ? T(1) : T(0.5));
  const T split = p > l ? T(1) : (p < l ? T(0) : T(0.5));
  mp = mm * split;
  ml = mm * (T(1) - split);
}

// The forward-mode (JVP) counterpart of pgs_sweeps: the same sweeps over
// (x, x') together, x' the tangent of x for the tangents (A', b', lo',
// hi') that `tangent` holds in a LaneRow's fields (its dep is unused). Per
// row, with u = (b_i - delta_i) / A_ii the unclipped value,
//   u' = (b'_i - delta'_i - u A'_ii) / A_ii,  delta'_i = sum_{j != i} A'_ij x_j + A_ij x'_j,
// s = max(x_dep, 0) with s' = x'_dep max'(x_dep), l = lo_i s,
// l' = lo'_i s + lo_i s', h likewise, and x'_i = mp u' + ml l' + mh h'
// (clip_factors): at a tie each side takes half, as jax.jvp of the
// unrolled sweep gives. Fills x[] and xd[] from 0 (with Warm from the x0
// and x0' the caller filled them with, and x_dep, xd_dep their entries at
// row.dep) and returns (x, x') of the lane's row in (mine, mined) on
// lanes below N (with Warm the caller sets both to x0 and x0' of the row).
template <typename T, int N, int G, bool Warm = false>
__device__ __forceinline__ void pgs_jvp_sweeps(T (&x)[N], T (&xd)[N], const LaneRow<T, N>& row,
                                               const LaneRow<T, N>& tangent, int iterations, T& mine, T& mined,
                                               T x_dep = T(0), T xd_dep = T(0)) {
  static_assert(N <= G && (G == 16 || G == 32), "a group of 16 or 32 lanes holds one row per lane");
  const int lane = threadIdx.x % G;
  if (!Warm) {
    mine = mined = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = xd[j] = T(0);
  }
  for (int it = 0; it < iterations; ++it) {
    T prefix = T(0), prefixd = T(0);  // the row's sums over the columns j < lane done so far
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T delta = prefix, deltad = prefixd;
      if (Warm || it > 0) {
#pragma unroll
        for (int j = i + 1; j < N; ++j) {
          delta += row.a[j] * x[j];
          deltad += tangent.a[j] * x[j] + row.a[j] * xd[j];
        }
      }
      const T u = (row.b - delta) / row.a[i];
      const T ud = (tangent.b - deltad - u * tangent.a[i]) / row.a[i];
      const bool dep = row.dep >= 0;
      const T s = dep ? (x_dep > T(0) ? x_dep : T(0)) : T(1);
      const T sd = dep ? xd_dep * relu_slope(x_dep) : T(0);
      const T l = row.lo * s, h = row.hi * s;
      const T ld = tangent.lo * s + row.lo * sd, hd = tangent.hi * s + row.hi * sd;
      T xi = u < l ? l : u;
      xi = xi > h ? h : xi;
      T mp, ml, mh;
      clip_factors(u, l, h, mp, ml, mh);
      const T xdi = mp * ud + ml * ld + mh * hd;
      x[i] = __shfl_sync(0xffffffffu, xi, i, G);
      xd[i] = __shfl_sync(0xffffffffu, xdi, i, G);
      mine = lane == i ? x[i] : mine;
      mined = lane == i ? xd[i] : mined;
      x_dep = row.dep == i ? x[i] : x_dep;
      xd_dep = row.dep == i ? xd[i] : xd_dep;
      if (lane > i) {
        prefix += row.a[i] * x[i];
        prefixd += tangent.a[i] * x[i] + row.a[i] * xd[i];
      }
    }
  }
}
