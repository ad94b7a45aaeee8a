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
// select over x by a run-time index would move x to local memory). The
// first sweep from x = 0 sums A_ij x_j over j < i in increasing j, as the
// per-thread sweep of the first version did, so float64 results differ
// from it by nothing.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Lane i's row of the problem: A_i., b_i, lo_i, hi_i and dep_i (-1: none).
template <typename T, int N>
struct LaneRow {
  T a[N];
  T b, lo, hi;
  int dep;
};

// Makes v opaque to the compiler at no cost. The sweeps below that
// change x_dep (and x'_dep) pass it through here at every row: else the
// compiler may rebuild x_dep at each row from x[] by a select over
// row.dep, a run-time index (an N-way select a row, and in float64 at
// N = 8 x[] in local memory: 56.96 us at n = 3, B = 4096, 10 sweeps, f32,
// against 26.18 with it, on an H100 80GB HBM3).
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void opaque(double& v) { asm volatile("" : "+d"(v)); }

// Fills x[] from x = 0 and returns x[lane] on lanes below N. With Warm
// the sweeps start from the x[] the caller filled (the warm start x0),
// `mine` its x[lane] and `x_dep` its x[row.dep] (0 without a dependency);
// the zero start's instantiations (Warm false, K1's and K2's) take neither.
//
// Each lane keeps a running sum of its row over the columns already done
// in this sweep, so that row i waits only for x_{i-1}: one shuffle and one
// FMA a row. A sweep that reads A's upper triangle (every sweep after the
// first from x = 0, where every x_j with j > i is still 0, and every sweep
// from a warm start) needs each row's columns j > i against the previous
// sweep's x (or x0) as well. With Split, each lane sums its row over its
// columns j > lane against this sweep's x as they are broadcast, one FMA a
// row off the chain, and the next sweep's chain starts from that sum
// (`upper`, from the caller's x0 with Warm): row i's delta is its columns
// j > i, then its columns j < i, each in increasing j.
// Without Split every lane sums row i's columns j > i at each row i, in
// increasing j after the prefix, the plain sweep's order: N^2 / 2 FMAs a
// sweep on every lane (144.4 us at n = 24, B = 4096, 10 sweeps, f32 on an
// H100 80GB HBM3). That is the code of K2 (whose one sweep skips it) and
// of K1's zero-start instances for one sweep, which K1 launches for at most
// one sweep from x = 0; K1 launches the Split instances for every other
// start and count, so that the one-sweep paths compile to what they were.
// With Save (K1's saving forward: its Split instances launched when a
// backward can follow), `saved` takes the lane's x after each sweep but the
// last, `saved_stride` apart (null on the lanes that store nothing), so
// that the backward reads the forward's own sweeps; the instances without
// Save (K2's, and K1's for every forward without grad) never read it and
// compile to what they were before it existed.
// The Split instances carry the lane's sums (prefix, next, upper) in double
// in both types, as the blocked and streaming forms do: in float32 their
// float sums from x0 strayed 1.94e-6 from the plain sweep in float64 at
// n = 24, B = 4096, past the float32 tolerance (rtol 1e-5, atol 1e-6; on an
// H100 80GB HBM3). In float32 the chain then keeps b_i minus the sum so far
// (`prefix`) and multiplies it, rounded once, by 1 / A_ii taken before the
// sweeps, so that a double FMA and two conversions take the place of the
// float FMA, subtraction and divide on it.

// The type of a sweep's running sums: double with Split, else T.
template <typename T, bool Split>
using SweepAcc = typename std::conditional<Split, double, T>::type;

// v in double, converted where it is used: a plain conversion of a row's
// entry is the same at every sweep, and the compiler then hoists the N
// conversions out of the sweep loop and holds them in 2N more registers
// (ptxas spilled 8-16 B a thread in the float32 N = 16 and 24 instances,
// and the N = 24 forward mode took 192 registers, not 117).
__device__ __forceinline__ double widen(float v) {
  double d;
  asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(v));
  return d;
}
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T, int N, int G, bool Warm = false, bool Split = Warm, bool Save = false>
__device__ __forceinline__ T pgs_sweeps(T (&x)[N], const LaneRow<T, N>& row, int iterations, T mine = T(0),
                                        T x_dep = T(0), SweepAcc<T, Split> upper = 0, T* saved = nullptr,
                                        int saved_stride = 0) {
  static_assert(N <= G && (G == 16 || G == 32), "a group of 16 or 32 lanes holds one row per lane");
  using Acc = SweepAcc<T, Split>;
  // float32 with Split: prefix holds b_i less the row's sum so far
  constexpr bool kRemainder = Split && std::is_same<T, float>::value;
  const int lane = threadIdx.x % G;
  if (!Warm) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T(0);
  }
  T inv = T(0);  // with kRemainder, 1 / the lane's A_ii
  if constexpr (kRemainder) {
#pragma unroll
    for (int i = 0; i < N; ++i) inv = lane == i ? row.a[i] : inv;
    inv = T(1) / inv;
  }
  for (int it = 0; it < iterations; ++it) {
    // the lane's row over the columns done so far: with Split, those after
    // it (the previous sweep's x) first, then those before it
    Acc prefix = Split ? upper : Acc(0);
    if constexpr (kRemainder) prefix = widen(row.b) - prefix;
    Acc next = Acc(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T xi;
      if constexpr (kRemainder) {
        xi = T(prefix) * inv;
      } else if (Split) {
        xi = T(Acc(row.b) - prefix) / row.a[i];
      } else {
        T delta = prefix;
        if (Warm || it > 0) {
#pragma unroll
          for (int j = i + 1; j < N; ++j) delta += row.a[j] * x[j];
        }
        xi = (row.b - delta) / row.a[i];
      }
      const T s = row.dep >= 0 ? (x_dep > T(0) ? x_dep : T(0)) : T(1);
      // clip(xi, lo*s, hi*s) = min(max(xi, lo*s), hi*s), as jnp.clip
      const T l = row.lo * s;
      const T h = row.hi * s;
      xi = xi < l ? l : xi;
      xi = xi > h ? h : xi;
      x[i] = __shfl_sync(0xffffffffu, xi, i, G);
      mine = lane == i ? x[i] : mine;
      x_dep = row.dep == i ? x[i] : x_dep;
      if (Split) opaque(x_dep);
      if constexpr (kRemainder) {
        const double a = widen(row.a[i]), xv = widen(x[i]);
        prefix = lane > i ? prefix - a * xv : prefix;
        next = lane < i ? next + a * xv : next;
      } else {
        prefix = lane > i ? prefix + Acc(row.a[i]) * Acc(x[i]) : prefix;
        if (Split) next = lane < i ? next + Acc(row.a[i]) * Acc(x[i]) : next;
      }
    }
    upper = next;
    if constexpr (Save) {
      if (saved != nullptr && it + 1 < iterations) {
        *saved = mine;
        saved += saved_stride;
      }
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

// The tangents of a lane's row for pgs_jvp_sweeps: A''s row stays in
// global memory, read once a sweep off the chain (cols values; a padding
// row has cols = 0 and reads nothing), never held through one.
template <typename T>
struct LaneTangent {
  const T* a;
  int cols;
  T b, lo, hi;
};

// A lane's row's sums over its columns j > lane that a sweep of
// pgs_jvp_sweeps starts from: A against x, A' against x, A against x'. In
// double in both types, as every sum of pgs_jvp_sweeps.
struct UpperSums {
  double x, a_dot_x, x_dot;
};

// The forward-mode (JVP) counterpart of pgs_sweeps: the same sweeps over
// (x, x') together, x' the tangent of x for the tangents (A', b', lo', hi')
// of `tangent`, "linearised" as K1's backward is. Per row, with
// u = (b_i - delta_i) / A_ii the unclipped value, s = max(x_dep, 0) and
// the clip's factors (mp, ml, mh) = clip_factors(u, lo_i s, hi_i s) (at a
// tie each side takes half, as jax.jvp of the unrolled sweep gives),
//   x'_i = mp (b'_i - c_i - sum_{j != i} A_ij x'_j) / A_ii + ml l'_i + mh h'_i,
//   c_i = sum_{j < i} A'_ij x_j + sum_{j > i} A'_ij x_j(prev) + u_i A'_ii,
// l' = lo'_i s + lo_i s', h' likewise, s' = x'_dep max'(x_dep). Once a
// sweep's x is known, u, s and so the factors are fixed and x' is linear:
// (1) the primal chain over A, as pgs_sweeps with Split, each lane keeping
// u and x_dep of its own row; (2) off the chain, one pass over A''s row in
// global memory against this sweep's x: the columns before the row for c,
// those after it for the next sweep's c; and the factors; (3) the tangent
// chain over A, x'_i = k1 (b'_i - c_i - sum) + k0 + k2 x'_dep with
// k1 = mp / A_ii, k0 = (ml lo'_i + mh hi'_i) s, k2 = (ml lo_i + mh hi_i)
// max'(x_dep): one shuffle and one FMA a row, as the primal's. Neither x'
// nor A''s row is held: the sums over the columns after each row (of A
// against x and x', of A' against x) are taken for the next sweep as the
// values are known. Fills x[] from 0 (with Warm from the x0 the caller
// filled it with, x_dep and xd_dep the entries of x0 and x0' at row.dep,
// and `upper` the lane's row's sums over its columns j > lane: A x0, A' x0
// and A x0') and returns (x, x') of the lane's row in (mine, mined) on
// lanes below N (with Warm the caller sets both to x0 and x0' of the row).
// The sums (of the chains, of c, and those after each row) run in double in
// both types, as pgs_sweeps' with Split: in float32 their float sums from
// x0 strayed 3.2e-6 from the plain version in float64 in x' at n = 24,
// B = 4096, past rtol 1e-5, atol 1e-6 max|x'| (on an H100 80GB HBM3).
template <typename T, int N, int G, bool Warm = false>
__device__ __forceinline__ void pgs_jvp_sweeps(T (&x)[N], const LaneRow<T, N>& row, const LaneTangent<T>& tangent,
                                               int iterations, T& mine, T& mined, T x_dep = T(0), T xd_dep = T(0),
                                               UpperSums upper = {0.0, 0.0, 0.0}) {
  static_assert(N <= G && (G == 16 || G == 32), "a group of 16 or 32 lanes holds one row per lane");
  const int lane = threadIdx.x % G;
  if (!Warm) {
    mine = mined = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T(0);
  }
  T aii = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) aii = lane == i ? row.a[i] : aii;
  const T aii_dot = lane < tangent.cols ? tangent.a[lane] : T(0);
  const bool has_dep = row.dep >= 0;
  for (int it = 0; it < iterations; ++it) {
    const bool last = it + 1 == iterations;
    // (1) the primal chain, from the row's columns after it
    double sum = upper.x, next = 0.0;
    T u = T(0), dep_at = T(0);  // u and x_dep of the lane's row, as its row saw them
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T ui = T(double(row.b) - sum) / row.a[i];
      const T s = has_dep ? (x_dep > T(0) ? x_dep : T(0)) : T(1);
      const T l = row.lo * s;
      const T h = row.hi * s;
      T xi = ui < l ? l : ui;
      xi = xi > h ? h : xi;
      x[i] = __shfl_sync(0xffffffffu, xi, i, G);
      u = lane == i ? ui : u;
      dep_at = lane == i ? x_dep : dep_at;
      mine = lane == i ? x[i] : mine;
      x_dep = row.dep == i ? x[i] : x_dep;
      opaque(x_dep);
      const double a = widen(row.a[i]), xv = widen(x[i]);
      sum = lane > i ? sum + a * xv : sum;
      next = lane < i ? next + a * xv : next;
    }
    upper.x = next;
    // (2) c: A''s columns after the row (the previous sweep's x), then
    // before it, and u A'_ii; the columns after it for the next sweep
    double c = upper.a_dot_x, c_next = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < lane && j < tangent.cols) c += double(tangent.a[j]) * double(x[j]);
      if (j > lane && j < tangent.cols && !last) c_next += double(tangent.a[j]) * double(x[j]);
    }
    c += double(u) * double(aii_dot);
    upper.a_dot_x = c_next;
    const T s = has_dep ? (dep_at > T(0) ? dep_at : T(0)) : T(1);
    T mp, ml, mh;
    clip_factors(u, row.lo * s, row.hi * s, mp, ml, mh);
    const T k1 = mp / aii;
    const double bc = double(tangent.b) - c;
    const T k0 = (ml * tangent.lo + mh * tangent.hi) * s;
    const T k2 = has_dep ? (ml * row.lo + mh * row.hi) * relu_slope(dep_at) : T(0);
    // (3) the tangent chain, from the row's columns after it (the previous
    // sweep's x')
    double sumd = upper.x_dot, nextd = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T xdi = T(double(k1) * (bc - sumd) + double(k0 + k2 * xd_dep));
      const T xdm = __shfl_sync(0xffffffffu, xdi, i, G);
      mined = lane == i ? xdm : mined;
      xd_dep = row.dep == i ? xdm : xd_dep;
      opaque(xd_dep);
      const double a = widen(row.a[i]), xd = widen(xdm);
      sumd = lane > i ? sumd + a * xd : sumd;
      nextd = lane < i ? nextd + a * xd : nextd;
    }
    upper.x_dot = nextd;
  }
}
