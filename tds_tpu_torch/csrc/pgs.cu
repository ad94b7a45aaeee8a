// Batched projected Gauss-Seidel (PGS) solve of the contact MLCP, for any
// number of rows n. Built by tds_tpu_torch/contact/pgs.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpgs.so pgs.cu
// and called through the plain C functions at the bottom (ctypes).
//
// Replaces the TPU kernel tds_tpu/contact/pallas_pgs.py::_pgs_kernel
// (launched by solve_pgs_pallas), which unrolls any n. Same function:
// `iterations` sweeps over the n rows of A x = b starting from x = 0; row i
// is clipped to [lo_i s, hi_i s], s = max(x[dep_i], 0) when dep_i >= 0,
// else 1.
//
// What bounds it on an H100: memory, and below that the launch and the
// sweep's chain of dependent rows. Each env reads A (n*n values; with one
// sweep only its lower triangle matters) and b, lo, hi (3n) and writes x
// (n), against about 2*n*n*iterations flops. At B = 4096, n = 12, f32 that
// is ~3.1 MB, a bound of ~0.9 us at 3.35 TB/s; in the step A was just
// written and sits in L2, so the launch itself (~5 us on this card) is the
// real floor. At n = 105, B = 1024 A is 45 MB (f32): 13.5 us of bytes.
//
// Two designs, by n:
//
// n <= 32: a group of G lanes per env (16 for n <= 16, 32 above), row i on
// lane i, in pgs_sweep.cuh, which the fused step kernel (megastep.cu)
// shares. Lane i loads row i of A and b_i, lo_i, hi_i, so a group's loads
// cover the env's n*n contiguous values; each row's x_i is computed on
// lane i and broadcast with __shfl_sync, and every lane keeps the whole x
// in registers. The row loops are unrolled over a compile-time N: instances
// N = 8, 12, 16, 24 and 32. An n between instances runs the next larger
// N with rows n..N-1 padded in registers as identity rows (A_ii = 1, A_ij =
// 0, b = lo = hi = 0, no dependency): their x stays 0 and, with A_ij = 0 for
// j >= n in the real rows, adds only exact zeros to the real rows' sums, so
// the real rows' x are what an instance of N = n would give
// (pgs_kernel_padded). n = 12 and n = 24 run their own instances of
// pgs_kernel, the row-per-lane kernel as it was before padding existed. The first version of this kernel ran one
// thread per env, whose neighbouring threads read addresses n*n apart (13 us
// at n = 12 on an H100 80GB HBM3).
//
// n > 32: a row no longer fits in a lane's registers (A is 44 KB per env
// at n = 105 in f32), so one warp per env streams A row by row from global
// memory: lane l reads A_ij for j = l (mod 32), 32 consecutive values per
// load, coalesced, each row's loads issued a row ahead (up to 128 columns
// held in registers, the rest streamed). x lives in shared memory, n values
// per warp (its warp's lanes read x_j beside A_ij and lane (i mod 32)
// writes x_i), so any n fits without local memory, up to the shared memory
// of a block (n <= 29,056 in f64 at one env per block). Row i's sum over j != i of A_ij x_j is a
// lane's partial sum over its columns in increasing j, then a butterfly
// reduction over the warp (__shfl_xor_sync, 16, 8, 4, 2, 1); every lane
// then clips x_i alike and lane (i mod 32) stores it. In the first sweep
// x_j = 0 for j >= i, so the row reads only the 32-column blocks below its
// diagonal block and the diagonal block. The summation order differs from
// the plain sweep's, so float64 agrees to rounding (about 1e-12 relative),
// not bit for bit. Its first version issued a row's loads when the row was
// used, one global-memory round trip per 32 columns on the chain of rows
// (146 us at n = 105, B = 1024, f32 on an H100 80GB HBM3). A in shared
// memory through TMA and several envs per warp are later work.
//
// The ragged edge (both designs): a group past the end of the batch reads
// the last env's operands, runs the sweeps with the rest of its warp (the
// shuffles need every lane) and stores nothing.

#include <cuda_runtime.h>

#include "pgs_sweep.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int kSmemMax = 227 * 1024;     // a block's limit on Hopper

template <int N>
struct Lanes {
  static constexpr int G = N <= 16 ? 16 : 32;
};

// The row-per-lane instance N for n <= 32 rows: the smallest of 8, 12, 16,
// 24, 32 that holds them (0 for other n). (An instance of N = 4 kept 32 B of
// local memory per thread in float64; n <= 8 pads to 8 instead.)
inline int instance_rows(int n) {
  if (n < 1 || n > 32) return 0;
  if (n <= 8) return 8;
  if (n <= 16) return (n + 3) / 4 * 4;
  return n <= 24 ? 24 : 32;
}

// n == N: the instance for exactly N rows (n = 12 and 24 among them), the
// row-per-lane kernel as it was before padding existed.
template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads)
pgs_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
           const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
           int batch, int iterations) {
  const int lane = threadIdx.x % G;
  const long long env = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  const int i = lane < N ? lane : 0;              // lanes past n carry row 0, unused
  LaneRow<T, N> row;
  const T* a_row = a + (e * N + i) * N;
#pragma unroll
  for (int j = 0; j < N; ++j) row.a[j] = a_row[j];
  row.b = b[e * N + i];
  row.lo = lo[e * N + i];
  row.hi = hi[e * N + i];
  row.dep = dep[i];
  T x[N];
  const T mine = pgs_sweeps<T, N, G>(x, row, iterations);
  if (active && lane < N) x_out[e * N + lane] = mine;
}

// n < N: rows n..N-1 are identity rows in registers.
template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads)
pgs_kernel_padded(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                  const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                  int batch, int n, int iterations) {
  const int lane = threadIdx.x % G;
  const long long env = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  const int i = lane < N ? lane : 0;              // lanes past N carry row 0, unused
  // a padding row (i >= n) reads row 0 and keeps none of it
  const bool real = i < n;
  const int r = real ? i : 0;
  LaneRow<T, N> row;
  const T* a_row = a + (e * n + r) * n;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T v = j < n ? a_row[j] : T(0);
    row.a[j] = real ? v : (j == i ? T(1) : T(0));
  }
  row.b = real ? b[e * n + r] : T(0);
  row.lo = real ? lo[e * n + r] : T(0);
  row.hi = real ? hi[e * n + r] : T(0);
  row.dep = real ? dep[r] : -1;
  T x[N];
  const T mine = pgs_sweeps<T, N, G>(x, row, iterations);
  if (active && lane < n) x_out[e * n + lane] = mine;
}

// n > 32: a lane's share of one row, loaded a row ahead. kHeld columns a
// lane (j = lane + 32 k, k < kHeld) are held in registers, so rows of up to
// 32 kHeld columns load whole; the columns past them stream from global
// memory when the row is used.
constexpr int kHeld = 4;

template <typename T>
struct WarpRow {
  T a[kHeld];        // A_ij, j = lane + 32 k, 0 past the row's columns
  T aii, b, lo, hi;  // the row's diagonal and right-hand side, on every lane
  int dep;
  int cols;          // the columns the row needs: all but in the first sweep
};

// Row i in sweep `it` of one env: the first sweep has x_j = 0 for j >= i,
// so it needs the columns up to the end of i's block of 32.
template <typename T>
__device__ __forceinline__ void load_warp_row(WarpRow<T>& r, const T* a_env, const T* b_env, const T* lo_env,
                                              const T* hi_env, const int* dep, int i, int it, int n, int lane) {
  const T* a_row = a_env + (long long)i * n;
  r.cols = it == 0 ? min(n, (i / kWarp + 1) * kWarp) : n;
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int j = lane + kWarp * k;
    r.a[k] = j < r.cols ? a_row[j] : T(0);
  }
  r.aii = a_row[i];
  r.b = b_env[i];
  r.lo = lo_env[i];
  r.hi = hi_env[i];
  r.dep = dep[i];
}

// n > 32: one warp per env, envs_per_block warps a block, x in shared
// memory (n values a warp). Each row's loads are issued while the row
// before it is reduced and clipped, so the chain of dependent rows waits on
// a shuffle reduction and a divide a row, not on a memory round trip.
template <typename T>
__global__ void pgs_kernel_per_warp(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                                    const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                                    int batch, int n, int iterations) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* x = reinterpret_cast<T*>(smem_raw) + (long long)warp * n;
  for (int j = lane; j < n; j += kWarp) x[j] = T(0);
  __syncwarp();
  const T* a_env = a + e * n * n;
  const T* b_env = b + e * n;
  const T* lo_env = lo + e * n;
  const T* hi_env = hi + e * n;
  WarpRow<T> cur;
  load_warp_row(cur, a_env, b_env, lo_env, hi_env, dep, 0, 0, n, lane);
  for (int it = 0; it < iterations; ++it) {
    for (int i = 0; i < n; ++i) {
      // the next row's loads (row 0 of the next sweep after the last row)
      WarpRow<T> next;
      const bool wrap = i + 1 == n;
      load_warp_row(next, a_env, b_env, lo_env, hi_env, dep, wrap ? 0 : i + 1, wrap ? it + 1 : it, n, lane);
      // this lane's columns in increasing j, then a butterfly over the warp
      T partial = T(0);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int j = lane + kWarp * k;
        if (j < cur.cols && j != i) partial += cur.a[k] * x[j];
      }
      const T* a_row = a_env + (long long)i * n;
      for (int j = lane + kWarp * kHeld; j < cur.cols; j += kWarp) {
        if (j != i) partial += a_row[j] * x[j];
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        partial += __shfl_xor_sync(0xffffffffu, partial, offset);
      }
      T xi = (cur.b - partial) / cur.aii;
      const int d = cur.dep;
      const T s = d >= 0 ? (x[d] > T(0) ? x[d] : T(0)) : T(1);
      // clip(xi, lo*s, hi*s) = min(max(xi, lo*s), hi*s), as jnp.clip
      const T l = cur.lo * s;
      const T h = cur.hi * s;
      xi = xi < l ? l : xi;
      xi = xi > h ? h : xi;
      __syncwarp();  // every lane has read x[d] before it changes
      if (lane == i % kWarp) x[i] = xi;
      __syncwarp();
      cur = next;
    }
  }
  if (active) {
    for (int j = lane; j < n; j += kWarp) x_out[e * n + j] = x[j];
  }
}

// Envs per block and dynamic shared memory of the warp kernel at n rows:
// 4 warps a block while their x fit the default 48 KB, else 1.
template <typename T>
void warp_shape(int n, int* envs, long long* smem) {
  const long long per_env = (long long)n * sizeof(T);
  *envs = 4 * per_env <= kSmemDefault ? 4 : 1;
  *smem = *envs * per_env;
}

template <typename T>
cudaError_t prepare_warp_kernel(int n, int* envs, long long* smem) {
  warp_shape<T>(n, envs, smem);
  if (*smem > kSmemMax) return cudaErrorInvalidValue;
  if (*smem > kSmemDefault) {
    return cudaFuncSetAttribute(pgs_kernel_per_warp<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

template <typename T, int N>
const void* row_kernel(int n) {
  if (n == N) return reinterpret_cast<const void*>(&pgs_kernel<T, N, Lanes<N>::G>);
  return reinterpret_cast<const void*>(&pgs_kernel_padded<T, N, Lanes<N>::G>);
}

template <typename T>
const void* kernel_for(int n) {
  switch (instance_rows(n)) {
    case 8: return row_kernel<T, 8>(n);
    case 12: return row_kernel<T, 12>(n);
    case 16: return row_kernel<T, 16>(n);
    case 24: return row_kernel<T, 24>(n);
    case 32: return row_kernel<T, 32>(n);
    default: return n > 32 ? reinterpret_cast<const void*>(&pgs_kernel_per_warp<T>) : nullptr;
  }
}

template <typename T, int N>
void launch_rows(const T* a, const T* b, const T* lo, const T* hi, const int* dep, T* x, int batch, int n,
                 int iterations, cudaStream_t s) {
  constexpr int G = Lanes<N>::G;
  constexpr int envs = kThreads / G;
  const int blocks = (batch + envs - 1) / envs;
  if (n == N) {
    pgs_kernel<T, N, G><<<blocks, kThreads, 0, s>>>(a, b, lo, hi, dep, x, batch, iterations);
  } else {
    pgs_kernel_padded<T, N, G><<<blocks, kThreads, 0, s>>>(a, b, lo, hi, dep, x, batch, n, iterations);
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* lo, const void* hi,
           const void* dep, void* x, int batch, int n, int iterations,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  const T* lo_t = static_cast<const T*>(lo);
  const T* hi_t = static_cast<const T*>(hi);
  const int* dep_t = static_cast<const int*>(dep);
  T* x_t = static_cast<T*>(x);
  switch (instance_rows(n)) {
    case 8: launch_rows<T, 8>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations, s); break;
    case 12: launch_rows<T, 12>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations, s); break;
    case 16: launch_rows<T, 16>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations, s); break;
    case 24: launch_rows<T, 24>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations, s); break;
    case 32: launch_rows<T, 32>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations, s); break;
    default: {
      if (n <= 32) return static_cast<int>(cudaErrorInvalidValue);
      int envs = 0;
      long long smem = 0;
      const cudaError_t err = prepare_warp_kernel<T>(n, &envs, &smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = static_cast<int>((batch + envs - 1) / envs);
      pgs_kernel_per_warp<T><<<blocks, envs * kWarp, smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1's backward: the vector-Jacobian product of the sweeps above, the
// counterpart of jax.grad through tds_tpu/contact/mlcp.py::solve_pgs (the
// Pallas kernel has no backward of its own: the JAX package differentiates
// the unrolled sweep).
//
// Row i of sweep t does x_i = min(max(p_i, l_i), h_i) with
// p_i = (b_i - sum_{j != i} A_ij x_j) / A_ii, l_i = lo_i s_i, h_i = hi_i s_i
// and s_i = max(x_dep_i, 0) (1 without a dependency), where x_j is this
// sweep's value for j < i and the previous sweep's for j > i. The backward
// walks the rows in reverse, sweep T-1 down to 0, row n-1 down to 0, with
// x-bar the adjoint of the current x: row i takes g = x-bar_i, zeroes it
// (the row overwrote x_i and never read it), splits g through min(max())
// into p-bar, l-bar, h-bar with jnp.maximum's and jnp.minimum's tie rule
// (a tie gives each side half, so clip(0, 0, 0) passes 1/4, 1/4 and 1/2
// back), and with c = -p-bar / A_ii adds b-bar_i += p-bar / A_ii,
// A-bar_ij += c x_j (j != i), A-bar_ii += c p_i, x-bar_j += c A_ij,
// lo-bar_i += l-bar s_i, hi-bar_i += h-bar s_i and, through the max,
// x-bar_dep += (l-bar lo_i + h-bar hi_i) (1 if x_dep > 0, 1/2 if 0, else 0).
//
// Saved state: x after every sweep, xs (iterations, B, n), which the
// wrapper (contact/pgs.py) fills from the forward's output and, for
// iterations > 1, from forward launches of 1 .. iterations-1 sweeps, which
// compute the same sweeps bit for bit. Each row's p_i is recomputed from
// xs; its sum runs in another order than the forward's (a reduction over
// the lanes), so p_i may differ from the forward's by rounding, which moves
// A-bar_ii by as much and picks another branch of the clip only where p_i
// lies within rounding of a bound without sitting on it.
//
// What bounds it on an H100: like the forward, memory and the chain of
// dependent rows. Each env reads A (its lower triangle with one sweep), b,
// lo, hi, xs and x-bar and writes A-bar whole (zeros above the diagonal
// with one sweep: autograd takes a dense (B, n, n) gradient), b-bar, lo-bar
// and hi-bar; each row costs a reduction over the lanes (the forward's
// lane-per-row sweep needs none) and a divide.
//
// n <= 32: a group of G lanes per env, lane j owns index j: column j of A
// (col[i] = A_ij, loaded a row at a time, so a group's loads are
// contiguous), x-bar_j, and column j of A-bar in registers, written at the
// end; rows are instances of N = 8, 12, 16, 24, 32 with the padded rows
// and lanes inert (identity columns, no dependency, rows i >= n skipped).
// n > 32: a warp per env, lane l owns the columns j = l (mod 32); this
// sweep's x, the previous sweep's and x-bar sit in shared memory (3n values
// a warp), each row's p_i is a butterfly over the warp, and row i of A-bar
// goes straight to global memory (stored by the last sweep, the first in
// reverse, added to by the sweeps before it).

// x = min(max(p, l), h) with jnp.maximum's and jnp.minimum's tie rule:
// the adjoints of p, l and h for the adjoint g of x.
template <typename T>
__device__ __forceinline__ void clip_adjoint(T p, T l, T h, T g, T& p_bar, T& l_bar, T& h_bar) {
  const T m = p > l ? p : l;
  T m_bar;
  if (m < h) {
    m_bar = g;
    h_bar = T(0);
  } else if (m > h) {
    m_bar = T(0);
    h_bar = g;
  } else {
    m_bar = g * T(0.5);
    h_bar = g * T(0.5);
  }
  if (p > l) {
    p_bar = m_bar;
    l_bar = T(0);
  } else if (p < l) {
    p_bar = T(0);
    l_bar = m_bar;
  } else {
    p_bar = m_bar * T(0.5);
    l_bar = m_bar * T(0.5);
  }
}

// d max(x, 0) / dx with jnp.maximum's tie rule
template <typename T>
__device__ __forceinline__ T relu_slope(T x) {
  return x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
}

template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads)
pgs_backward_rows(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                  const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                  const T* __restrict__ x_bar, T* __restrict__ a_bar, T* __restrict__ b_bar,
                  T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch, int n, int iterations) {
  const int lane = threadIdx.x % G;
  const long long env = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  const bool real = lane < n;                    // lanes n.. own padded (or no) indices
  const int j = real ? lane : 0;
  T col[N], col_bar[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T v = (real && i < n) ? a[(e * n + i) * n + j] : T(0);
    col[i] = real ? v : (i == lane ? T(1) : T(0));
    col_bar[i] = T(0);
  }
  const T bj = real ? b[e * n + j] : T(0);
  const T loj = real ? lo[e * n + j] : T(0);
  const T hij = real ? hi[e * n + j] : T(0);
  const int depj = real ? dep[j] : -1;
  T xbar = real ? x_bar[e * n + j] : T(0);
  T bbar = T(0), lobar = T(0), hibar = T(0);
  for (int t = iterations - 1; t >= 0; --t) {
    const T xt = real ? xs[((long long)t * batch + e) * n + j] : T(0);
    const T xp = (real && t > 0) ? xs[((long long)(t - 1) * batch + e) * n + j] : T(0);
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      if (i >= n) continue;  // a padded row: x stays 0 and no adjoint reaches it
      // x_j as row i of this sweep read it
      const T sel = lane < i ? xt : xp;
      T partial = lane != i ? col[i] * sel : T(0);
#pragma unroll
      for (int offset = G / 2; offset > 0; offset /= 2) partial += __shfl_xor_sync(0xffffffffu, partial, offset, G);
      const T aii = __shfl_sync(0xffffffffu, col[i], i, G);
      const T bi = __shfl_sync(0xffffffffu, bj, i, G);
      const T loi = __shfl_sync(0xffffffffu, loj, i, G);
      const T hii = __shfl_sync(0xffffffffu, hij, i, G);
      const int di = __shfl_sync(0xffffffffu, depj, i, G);
      const T g = __shfl_sync(0xffffffffu, xbar, i, G);
      const T xd = __shfl_sync(0xffffffffu, sel, di >= 0 ? di : 0, G);
      const T p = (bi - partial) / aii;
      const T s = di >= 0 ? (xd > T(0) ? xd : T(0)) : T(1);
      T p_bar, l_bar, h_bar;
      clip_adjoint(p, loi * s, hii * s, g, p_bar, l_bar, h_bar);
      const T c = -p_bar / aii;
      if (lane == i) {
        xbar = T(0);
        bbar += p_bar / aii;
        lobar += l_bar * s;
        hibar += h_bar * s;
        col_bar[i] += c * p;
      } else {
        col_bar[i] += c * sel;
        xbar += c * col[i];
      }
      if (lane == di) xbar += (l_bar * loi + h_bar * hii) * relu_slope(xd);
    }
  }
  if (active && real) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) a_bar[(e * n + i) * n + j] = col_bar[i];
    }
    b_bar[e * n + j] = bbar;
    lo_bar[e * n + j] = lobar;
    hi_bar[e * n + j] = hibar;
  }
}

template <typename T>
__global__ void pgs_backward_per_warp(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                                      const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                                      const T* __restrict__ x_bar, T* __restrict__ a_bar, T* __restrict__ b_bar,
                                      T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch, int n,
                                      int iterations) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* xt = reinterpret_cast<T*>(smem_raw) + (long long)warp * 3 * n;  // this sweep's x
  T* xp = xt + n;                                                    // the previous sweep's
  T* xbar = xp + n;
  const T* a_env = a + e * n * n;
  T* abar_env = a_bar + e * n * n;
  for (int j = lane; j < n; j += kWarp) xbar[j] = x_bar[e * n + j];
  if (iterations == 0 && active) {
    for (long long k = lane; k < (long long)n * n; k += kWarp) abar_env[k] = T(0);
    for (int j = lane; j < n; j += kWarp) b_bar[e * n + j] = lo_bar[e * n + j] = hi_bar[e * n + j] = T(0);
  }
  for (int t = iterations - 1; t >= 0; --t) {
    const bool store = t == iterations - 1;  // the first sweep visited stores, the others add
    __syncwarp();
    for (int j = lane; j < n; j += kWarp) {
      xt[j] = xs[((long long)t * batch + e) * n + j];
      xp[j] = t > 0 ? xs[((long long)(t - 1) * batch + e) * n + j] : T(0);
    }
    __syncwarp();
    for (int i = n - 1; i >= 0; --i) {
      const T* a_row = a_env + (long long)i * n;
      // in the first sweep x_j = 0 for j > i: those columns add nothing
      const int cols = t == 0 ? i : n;
      T partial = T(0);
      for (int j = lane; j < cols; j += kWarp) {
        if (j != i) partial += a_row[j] * (j < i ? xt[j] : xp[j]);
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) partial += __shfl_xor_sync(0xffffffffu, partial, offset);
      const T aii = a_row[i];
      const int d = dep[i];
      const T xd = d >= 0 ? (d < i ? xt[d] : xp[d]) : T(0);
      const T s = d >= 0 ? (xd > T(0) ? xd : T(0)) : T(1);
      const T loi = lo[e * n + i];
      const T hii = hi[e * n + i];
      const T p = (b[e * n + i] - partial) / aii;
      const T g = xbar[i];
      T p_bar, l_bar, h_bar;
      clip_adjoint(p, loi * s, hii * s, g, p_bar, l_bar, h_bar);
      const T c = -p_bar / aii;
      __syncwarp();  // every lane has read x-bar_i before it changes
      T* abar_row = abar_env + (long long)i * n;
      for (int j = lane; j < n; j += kWarp) {
        T v;
        if (j == i) {
          v = c * p;
          xbar[j] = T(0);
        } else if (j < i || t > 0) {
          v = c * (j < i ? xt[j] : xp[j]);
          xbar[j] += c * a_row[j];
        } else {
          v = T(0);  // x_j = 0 in the first sweep: nothing flows to A_ij or to that x_j
        }
        if (active) abar_row[j] = store ? v : abar_row[j] + v;
      }
      if (d >= 0 && lane == d % kWarp) xbar[d] += (l_bar * loi + h_bar * hii) * relu_slope(xd);
      if (active && lane == 0) {
        const long long k = e * n + i;
        b_bar[k] = store ? p_bar / aii : b_bar[k] + p_bar / aii;
        lo_bar[k] = store ? l_bar * s : lo_bar[k] + l_bar * s;
        hi_bar[k] = store ? h_bar * s : hi_bar[k] + h_bar * s;
      }
      __syncwarp();
    }
  }
}

// Envs per block and dynamic shared memory of the backward's warp kernel
// at n rows: 4 warps a block while their 3n values fit the default 48 KB,
// else 1.
template <typename T>
void backward_warp_shape(int n, int* envs, long long* smem) {
  const long long per_env = 3LL * n * sizeof(T);
  *envs = 4 * per_env <= kSmemDefault ? 4 : 1;
  *smem = *envs * per_env;
}

template <typename T>
cudaError_t prepare_backward_warp_kernel(int n, int* envs, long long* smem) {
  backward_warp_shape<T>(n, envs, smem);
  if (*smem > kSmemMax) return cudaErrorInvalidValue;
  if (*smem > kSmemDefault) {
    return cudaFuncSetAttribute(pgs_backward_per_warp<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

template <typename T>
const void* backward_kernel_for(int n) {
  switch (instance_rows(n)) {
    case 8: return reinterpret_cast<const void*>(&pgs_backward_rows<T, 8, Lanes<8>::G>);
    case 12: return reinterpret_cast<const void*>(&pgs_backward_rows<T, 12, Lanes<12>::G>);
    case 16: return reinterpret_cast<const void*>(&pgs_backward_rows<T, 16, Lanes<16>::G>);
    case 24: return reinterpret_cast<const void*>(&pgs_backward_rows<T, 24, Lanes<24>::G>);
    case 32: return reinterpret_cast<const void*>(&pgs_backward_rows<T, 32, Lanes<32>::G>);
    default: return n > 32 ? reinterpret_cast<const void*>(&pgs_backward_per_warp<T>) : nullptr;
  }
}

template <typename T>
struct BackwardArgs {
  const T *a, *b, *lo, *hi;
  const int* dep;
  const T *xs, *x_bar;
  T *a_bar, *b_bar, *lo_bar, *hi_bar;
};

template <typename T, int N>
void launch_backward_rows(const BackwardArgs<T>& g, int batch, int n, int iterations, cudaStream_t s) {
  constexpr int G = Lanes<N>::G;
  constexpr int envs = kThreads / G;
  const int blocks = (batch + envs - 1) / envs;
  pgs_backward_rows<T, N, G><<<blocks, kThreads, 0, s>>>(g.a, g.b, g.lo, g.hi, g.dep, g.xs, g.x_bar, g.a_bar,
                                                          g.b_bar, g.lo_bar, g.hi_bar, batch, n, iterations);
}

template <typename T>
int launch_backward(const BackwardArgs<T>& g, int batch, int n, int iterations, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance_rows(n)) {
    case 8: launch_backward_rows<T, 8>(g, batch, n, iterations, s); break;
    case 12: launch_backward_rows<T, 12>(g, batch, n, iterations, s); break;
    case 16: launch_backward_rows<T, 16>(g, batch, n, iterations, s); break;
    case 24: launch_backward_rows<T, 24>(g, batch, n, iterations, s); break;
    case 32: launch_backward_rows<T, 32>(g, batch, n, iterations, s); break;
    default: {
      if (n <= 32) return static_cast<int>(cudaErrorInvalidValue);
      int envs = 0;
      long long smem = 0;
      const cudaError_t err = prepare_backward_warp_kernel<T>(n, &envs, &smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = static_cast<int>((batch + envs - 1) / envs);
      pgs_backward_per_warp<T><<<blocks, envs * kWarp, smem, s>>>(g.a, g.b, g.lo, g.hi, g.dep, g.xs, g.x_bar, g.a_bar,
                                                                  g.b_bar, g.lo_bar, g.hi_bar, batch, n, iterations);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* a, const void* b, const void* lo, const void* hi, const void* dep, const void* xs,
             const void* x_bar, void* a_bar, void* b_bar, void* lo_bar, void* hi_bar, int batch, int n,
             int iterations, void* stream) {
  const BackwardArgs<T> g{static_cast<const T*>(a),     static_cast<const T*>(b),     static_cast<const T*>(lo),
                          static_cast<const T*>(hi),    static_cast<const int*>(dep), static_cast<const T*>(xs),
                          static_cast<const T*>(x_bar), static_cast<T*>(a_bar),       static_cast<T*>(b_bar),
                          static_cast<T*>(lo_bar),      static_cast<T*>(hi_bar)};
  return launch_backward<T>(g, batch, n, iterations, stream);
}

// The launch-shape query shared by the forward and the backward (see
// tds_pgs_launch_shape below).
int launch_shape(const void* fn, int lanes, int envs, long long smem, int* out) {
  const int threads = envs * lanes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = lanes;
  out[1] = envs;
  out[2] = threads;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

// a (B, n, n), b/lo/hi/x (B, n), all contiguous, on the current device;
// dep (n,) int32. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int tds_pgs_solve_f32(const void* a, const void* b, const void* lo,
                                 const void* hi, const void* dep, void* x,
                                 int batch, int n, int iterations,
                                 void* stream) {
  return launch<float>(a, b, lo, hi, dep, x, batch, n, iterations, stream);
}

extern "C" int tds_pgs_solve_f64(const void* a, const void* b, const void* lo,
                                 const void* hi, const void* dep, void* x,
                                 int batch, int n, int iterations,
                                 void* stream) {
  return launch<double>(a, b, lo, hi, dep, x, batch, n, iterations, stream);
}

// The launch shape of the kernel for n rows in float32 (f64 = 0) or
// float64 (f64 = 1), on the current device: out[0] lanes per env, out[1]
// envs per block, out[2] threads per block, out[3] shared memory per block
// (bytes, static and dynamic), out[4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] registers per
// thread and out[6] local memory per thread (bytes; stack frame and
// spills), both from cudaFuncGetAttributes. Returns a cudaError_t.
extern "C" int tds_pgs_launch_shape(int f64, int n, int* out) {
  const void* fn = f64 ? kernel_for<double>(n) : kernel_for<float>(n);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = instance_rows(n);
  int lanes = rows <= 16 ? 16 : 32;
  int envs = kThreads / lanes;
  long long smem = 0;
  if (rows == 0) {
    const cudaError_t err = f64 ? prepare_warp_kernel<double>(n, &envs, &smem) : prepare_warp_kernel<float>(n, &envs, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lanes = kWarp;
  }
  return launch_shape(fn, lanes, envs, smem, out);
}

// K1's backward: a, b, lo, hi (the forward's operands), dep, xs
// (iterations, B, n): x after each sweep, the last the forward's output,
// and x_bar (B, n), all contiguous on the current device; writes a_bar
// (B, n, n) whole and b_bar, lo_bar, hi_bar (B, n). Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int tds_pgs_backward_f32(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                    const void* xs, const void* x_bar, void* a_bar, void* b_bar, void* lo_bar,
                                    void* hi_bar, int batch, int n, int iterations, void* stream) {
  return backward<float>(a, b, lo, hi, dep, xs, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations, stream);
}

extern "C" int tds_pgs_backward_f64(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                    const void* xs, const void* x_bar, void* a_bar, void* b_bar, void* lo_bar,
                                    void* hi_bar, int batch, int n, int iterations, void* stream) {
  return backward<double>(a, b, lo, hi, dep, xs, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations, stream);
}

// The backward's launch shape, in tds_pgs_launch_shape's fields.
extern "C" int tds_pgs_backward_launch_shape(int f64, int n, int* out) {
  const void* fn = f64 ? backward_kernel_for<double>(n) : backward_kernel_for<float>(n);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = instance_rows(n);
  int lanes = rows <= 16 ? 16 : 32;
  int envs = kThreads / lanes;
  long long smem = 0;
  if (rows == 0) {
    const cudaError_t err = f64 ? prepare_backward_warp_kernel<double>(n, &envs, &smem)
                                : prepare_backward_warp_kernel<float>(n, &envs, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lanes = kWarp;
  }
  return launch_shape(fn, lanes, envs, smem, out);
}
