// Projected Gauss-Seidel sweeps over one environment's contact MLCP, shared
// by the PGS kernel (pgs.cu, K1) and the fused step kernel (megastep.cu,
// K2), so that both do the same arithmetic.
//
// `iterations` sweeps over the N rows of A x = b, continuing from the x[]
// the caller passes (the callers start from x = 0); rows are visited in
// order and each uses the already-updated x[j < i]; row i is clipped to
// [lo_i * s, hi_i * s] with s = max(x[dep_i], 0) when dep_i >= 0 (the
// Coulomb coupling of a friction row to its normal row), else s = 1.
//
// The problem is read through an accessor with a(i, j), b(i), lo(i),
// hi(i) and dep(i): K1 reads its operands from global memory, K2 from its
// own per-thread arrays. N is a template parameter so that the row loops
// unroll fully and x[] stays in registers; x[dep_i] is picked with an
// unrolled select, because a dynamic index into x would move it to local
// memory.

#pragma once

template <typename T, int N, typename Problem>
__device__ __forceinline__ void pgs_sweeps(T (&x)[N], const Problem& p,
                                           int iterations) {
  for (int it = 0; it < iterations; ++it) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T delta = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j != i) delta += p.a(i, j) * x[j];
      }
      T xi = (p.b(i) - delta) / p.a(i, i);
      const int d = p.dep(i);
      T s = T(1);
      if (d >= 0) {
        T xd = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) xd = (k == d) ? x[k] : xd;
        s = xd > T(0) ? xd : T(0);
      }
      // clip(xi, lo*s, hi*s) = min(max(xi, lo*s), hi*s), as jnp.clip
      const T l = p.lo(i) * s;
      const T h = p.hi(i) * s;
      xi = xi < l ? l : xi;
      xi = xi > h ? h : xi;
      x[i] = xi;
    }
  }
}
