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
// Three forms, by n:
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
// n > 32, "blocked": one warp per env, the rows in blocks of 32, lane l
// owning row 32 K + l of block K. Only a little of a sweep is truly
// sequential. For block K each lane first sums its row over every column
// outside the block's triangle (this sweep's final x_j for j < 32 K and,
// after the first sweep, the previous sweep's x_j for j > its row): a
// mat-vec, parallel over the lanes. Then, in order, lane m clips
// x_{32K+m} = clip((b - sum) / A_rr), broadcasts it with one __shfl_sync,
// and every later lane adds A_{r, 32K+m} x_{32K+m} to its sum with one
// FMA: the chain of dependent rows is a multiply, two compares, a shuffle
// and an FMA a row (1 / A_rr is taken before the chain, so that no divide
// sits on it). The bounds' s = max(x_dep, 0) reads x_dep as it stands when
// the row is clipped: this sweep's value when dep lies before the row (the
// broadcast one when dep is in the block), else the previous sweep's.
//
// A's lower triangle (all one sweep needs) lives in shared memory, packed
// (row r at r (r + 1) / 2), with x, b, lo, hi and dep: 24,360 B an env at
// n = 105 in f32, 5,664 B at n = 48, so that 4 envs a block make one wave
// at the paths' batches (n = 105, B = 1024: 8 envs an SM; n = 48, B =
// 4096: 32). The triangle's rows land with cp.async, 4 or 8 bytes a lane:
// TMA (cp.async.bulk) wants 16-byte-aligned sources and strides, and an
// env's A starts at e n^2 values (e x 44,100 B at n = 105 in f32), a row
// at n values (420 B), so neither is aligned in general. Each block's rows
// are one cp.async group, issued two blocks ahead: block K's chain runs
// while blocks K + 1 and K + 2 are in flight (issuing every block's group
// at the start was slower: 21.4 against 17.7 us with 0 sweeps at n = 105,
// B = 1024, 19.7 against 14.5 us at n = 48, B = 4096, f32 on an H100 80GB
// HBM3). The packed layout is free of
// bank conflicts both ways: 32 consecutive rows read at one column sit at
// offsets r (r + 1) / 2 + j, and the triangular numbers of 32 consecutive
// rows are distinct mod 32 (mod 16 within a half-warp for 8-byte values);
// a row read across consecutive columns is contiguous. After the first
// sweep (iterations > 1) a row's columns above the diagonal come from
// global memory (L2), a lane walking its own row: every path runs one
// sweep. A row's sum runs in double in both types: in float32 a sum of up
// to n products in order, in float32, strayed from the plain sweep's by
// more than the float32 tolerance at n = 97 and 3 sweeps, where the
// butterfly of the streaming form did not. The summation order differs
// from the plain sweep's, and x_r is (b - sum) times 1 / A_rr, so float64
// agrees to rounding (about 1e-12 relative), not bit for bit.
//
// n > 32 whose staged env does not fit a block's 227 KB (n > 335 in f32,
// > 236 in f64), "streaming": one warp per env streams A row by row from
// global memory, x in shared memory: lane l reads A_ij for j = l (mod 32),
// coalesced, each row's loads issued a row ahead; row i's sum is a
// butterfly over the warp (__shfl_xor_sync) and a divide, the chain a row.
// That was the only design for n > 32 before the blocked one (69.3 us at
// n = 105, B = 1024, f32 on an H100 80GB HBM3, 9.5x its bound).
//
// The ragged edge (every form): a group past the end of the batch reads
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

// The forms, as tds_pgs_form reports them.
enum Form { kRowPerLane = 0, kBlocked = 1, kStreaming = 2, kLinearised = 3 };

// cp.async of one 4- or 8-byte value from global to shared memory (the
// sources are aligned to their type only), and the group fences.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `pending` of this lane's groups are in flight; the
// caller's __syncwarp() then shows every lane's copies to the warp.
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__host__ __device__ __forceinline__ int triangle(int r) { return r * (r + 1) / 2; }

// Rows [r0, r1) of an env's A, columns 0..r, into the packed triangle,
// G lanes walking each row.
template <typename T>
__device__ __forceinline__ void stage_rows(T* tri, const T* a_env, int n, int r0, int r1, int lane, int G) {
  for (int r = r0; r < r1; ++r) {
    const T* src = a_env + (long long)r * n;
    T* dst = tri + triangle(r);
    for (int c = lane; c <= r; c += G) copy_async(dst + c, src + c);
  }
}

// Bytes of shared memory of one env of the blocked forward: the triangle,
// x, b, lo, hi and dep, rounded up to 16.
template <typename T>
__host__ __device__ __forceinline__ long long blocked_env_bytes(int n) {
  const long long bytes = ((long long)triangle(n) + 4LL * n) * sizeof(T) + 4LL * n;
  return (bytes + 15) / 16 * 16;
}

// Resident blocks of 128 threads the blocked kernels are built for: 8 in
// f32 (32 warps an SM, at most 64 registers a thread: the half-cheetah's
// 4096 envs in one wave), 4 in f64.
template <typename T>
struct Resident {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, Resident<T>::kBlocks)
pgs_kernel_blocked(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                   const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                   int batch, int n, int iterations) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* tri = reinterpret_cast<T*>(smem_raw + warp * blocked_env_bytes<T>(n));
  T* x = tri + triangle(n);
  T* bs = x + n;
  T* los = bs + n;
  T* his = los + n;
  int* deps = reinterpret_cast<int*>(his + n);
  const T* a_env = a + e * n * n;
  const int blocks = (n + kWarp - 1) / kWarp;
  // one cp.async group a block of rows, issued two blocks ahead; group 0
  // also holds b, lo, hi and dep
  for (int j = lane; j < n; j += kWarp) {
    copy_async(bs + j, b + e * n + j);
    copy_async(los + j, lo + e * n + j);
    copy_async(his + j, hi + e * n + j);
    copy_async(deps + j, dep + j);
    x[j] = T(0);
  }
  stage_rows(tri, a_env, n, 0, min(n, kWarp), lane, kWarp);
  copy_commit();
  stage_rows(tri, a_env, n, kWarp, min(n, 2 * kWarp), lane, kWarp);
  copy_commit();
  // a launch of 0 sweeps stages A all the same: the floor of its loads
  const int sweeps = iterations > 0 ? iterations : 1;
  for (int it = 0; it < sweeps; ++it) {
    for (int k = 0; k < blocks; ++k) {
      const int k0 = k * kWarp;
      if (it == 0) {
        copy_wait<1>();  // block k's rows have landed; block k + 1's may not have
        __syncwarp();
        stage_rows(tri, a_env, n, min(n, k0 + 2 * kWarp), min(n, k0 + 3 * kWarp), lane, kWarp);
        copy_commit();
      }
      if (iterations == 0) continue;
      const int r = k0 + lane;
      const bool row = r < n;
      const int rr = row ? r : n - 1;  // lanes past n shadow the last row
      const T* trow = tri + triangle(rr);
      // this sweep's x before the block, in increasing j; the row's sum
      // runs in double in both types
      double sum = 0.0;
#pragma unroll 4
      for (int j = 0; j < k0; ++j) sum += double(trow[j]) * double(x[j]);
      if (it > 0) {
        // the previous sweep's x after the row: A's upper part from L2
        const T* a_row = a_env + (long long)rr * n;
        for (int j = rr + 1; j < n; ++j) sum += double(a_row[j]) * double(x[j]);
      }
      const double bi = bs[rr];
      const T loi = los[rr], hii = his[rr];
      const double inv = 1.0 / double(trow[rr]);
      const int d = deps[rr];
      T xd = d >= 0 ? x[d] : T(0);  // x_dep now: replaced below when dep is an earlier row of the block
      T mine = T(0);
      const int rows = min(kWarp, n - k0);
#pragma unroll 4
      for (int m = 0; m < rows; ++m) {
        T xi = T((bi - sum) * inv);
        const T s = d >= 0 ? (xd > T(0) ? xd : T(0)) : T(1);
        // clip(xi, lo*s, hi*s) = min(max(xi, lo*s), hi*s), as jnp.clip
        const T l = loi * s;
        const T h = hii * s;
        xi = xi < l ? l : xi;
        xi = xi > h ? h : xi;
        const T xm = __shfl_sync(0xffffffffu, xi, m);
        mine = lane == m ? xm : mine;
        xd = d == k0 + m ? xm : xd;
        sum += double(lane > m ? trow[k0 + m] : T(0)) * double(xm);
      }
      __syncwarp();  // every lane has read the x it needs of this block
      if (row) x[r] = mine;
      __syncwarp();
    }
  }
  if (active) {
    for (int j = lane; j < n; j += kWarp) x_out[e * n + j] = x[j];
  }
}

// Envs per block (4, 2 or 1 while they fit a block's 227 KB) and dynamic
// shared memory of a launch with `per_env` bytes an env.
inline void staged_shape(long long per_env, int most, int* envs, long long* smem) {
  *envs = most;
  while (*envs > 1 && *envs * per_env > kSmemMax) *envs /= 2;
  *smem = *envs * per_env;
}

template <typename T>
bool blocked_fits(int n) {
  return n > 32 && blocked_env_bytes<T>(n) <= kSmemMax;
}

// Envs per block and dynamic shared memory of a streaming kernel with
// `per_env` bytes an env: 4 warps a block while they fit the default 48 KB,
// else 1.
inline void streaming_shape(long long per_env, int* envs, long long* smem) {
  *envs = 4 * per_env <= kSmemDefault ? 4 : 1;
  *smem = *envs * per_env;
}

// Opts a kernel in to more than the default 48 KB of dynamic shared memory.
inline cudaError_t allow_smem(const void* fn, long long smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// A kernel's launch for n rows: the kernel, its form, lanes per env, envs
// per block and dynamic shared memory per block (fn null: no kernel).
struct Plan {
  const void* fn = nullptr;
  int form = -1;
  int lanes = 0;
  int envs = 0;
  long long smem = 0;
};

template <typename T, int N>
const void* row_kernel(int n) {
  if (n == N) return reinterpret_cast<const void*>(&pgs_kernel<T, N, Lanes<N>::G>);
  return reinterpret_cast<const void*>(&pgs_kernel_padded<T, N, Lanes<N>::G>);
}

template <typename T>
Plan forward_plan(int n) {
  Plan p;
  const int rows = instance_rows(n);
  if (rows != 0) {
    switch (rows) {
      case 8: p.fn = row_kernel<T, 8>(n); break;
      case 12: p.fn = row_kernel<T, 12>(n); break;
      case 16: p.fn = row_kernel<T, 16>(n); break;
      case 24: p.fn = row_kernel<T, 24>(n); break;
      default: p.fn = row_kernel<T, 32>(n); break;
    }
    p.form = kRowPerLane;
    p.lanes = rows <= 16 ? 16 : 32;
    p.envs = kThreads / p.lanes;
  } else if (blocked_fits<T>(n)) {
    p.fn = reinterpret_cast<const void*>(&pgs_kernel_blocked<T>);
    p.form = kBlocked;
    p.lanes = kWarp;
    staged_shape(blocked_env_bytes<T>(n), kThreads / kWarp, &p.envs, &p.smem);
  } else if (n > 32) {
    p.fn = reinterpret_cast<const void*>(&pgs_kernel_per_warp<T>);
    p.form = kStreaming;
    p.lanes = kWarp;
    streaming_shape((long long)n * sizeof(T), &p.envs, &p.smem);  // x
  }
  return p;
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
      const Plan p = forward_plan<T>(n);
      if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = allow_smem(p.fn, p.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = static_cast<int>((batch + p.envs - 1) / p.envs);
      if (p.form == kBlocked) {
        pgs_kernel_blocked<T><<<blocks, p.envs * kWarp, p.smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations);
      } else {
        pgs_kernel_per_warp<T><<<blocks, p.envs * kWarp, p.smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, n, iterations);
      }
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
// xs; its sum runs in another order than the forward's, so p_i may differ
// from the forward's by rounding, which moves A-bar_ii by as much and picks
// another branch of the clip only where p_i lies within rounding of a
// bound without sitting on it.
//
// What bounds it on an H100: memory, and the chain of dependent rows. Each
// env reads A (its lower triangle with one sweep), b, lo, hi, xs and x-bar
// and writes A-bar whole (zeros above the diagonal with one sweep:
// autograd takes a dense (B, n, n) gradient), b-bar, lo-bar and hi-bar.
//
// "linearised" (every n whose staging fits a block): the saved sweeps fix
// every p_i, s_i and so the clip's factors, so the walk is linear in g and
// only one multiply-add a row stays on the chain. For sweep t, in reverse:
// (a) in parallel, each row's p_i from x after sweeps t and t - 1 (a
// mat-vec), s_i, and the factors of the clip's adjoint for g = 1 (p-bar =
// m_i g, l-bar = ml_i g, h-bar = mh_i g, each in {0, 1/4, 1/2, 1}), with
// f_i = -m_i / A_ii and e_i = (ml_i lo_i + mh_i hi_i) max'(x_dep); (b) the
// chain, in reverse, in blocks of G rows (lane l owning row G K + l):
// g_i = x-bar_i + sum over i' > i of c_i' A_i'i + d_i' for the rows i'
// whose dep is i, with c_i = f_i g_i and d_i = e_i g_i. Each lane first
// sums the rows of the later blocks (a mat-vec over its column, parallel),
// then lane m broadcasts g with one __shfl_sync and every earlier lane of
// the block adds w g with one FMA, w = f_m A_ml (+ e_m where dep_m is the
// lane's row), taken off the chain; (c) in parallel, A-bar's row i is
// c_i times the x row i read, A-bar_ii = c_i p_i, b-bar_i = -c_i,
// lo-bar_i = ml_i g_i s_i, hi-bar_i = mh_i g_i s_i, A-bar written a row
// at a time by consecutive lanes; and x-bar for sweep t - 1 is the
// sum over i < j of c_i A_ij plus d_i for the rows i whose dep is j >= i.
// A dep before its row feeds this sweep's chain, one at or after its row
// the previous sweep's x-bar. A's lower triangle, x after both sweeps,
// x-bar, b, lo, hi, p, f, e, c, d and dep sit in shared memory (27,300 B
// an env at n = 105 in f32, 888 B at n = 12), staged as the blocked
// forward stages them, the last block's rows first; the columns above the
// diagonal (sweeps after the first) come from L2. G = 16 lanes for
// n <= 16 (two envs a warp), else 32.
//
// "streaming" (n > 328 in f32, > 229 in f64): a warp per env, lane l owns
// the columns j = l (mod 32); this sweep's x, the previous sweep's and
// x-bar sit in shared memory (3n values a warp), each row's p_i is a
// butterfly over the warp, and row i of A-bar goes straight to global
// memory (stored by the last sweep, the first in reverse, added to by the
// sweeps before it). Before the linearised form it ran every n > 32
// (237.4-239.3 us at n = 105, B = 1024, f32 on an H100 80GB HBM3), and n <=
// 32 ran lane j owning column j of A and of A-bar in registers, a
// butterfly and seven shuffles a row.

// d max(x, 0) / dx with jnp.maximum's tie rule
template <typename T>
__device__ __forceinline__ T relu_slope(T x) {
  return x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
}

// x = min(max(p, l), h)'s adjoints of p, l and h for an adjoint 1 of x,
// with jnp.maximum's and jnp.minimum's tie rule (a tie gives each side
// half, so clip(0, 0, 0) passes 1/4, 1/4 and 1/2 back): each in {0, 1/4,
// 1/2, 1}. The adjoints for g are these times g.
template <typename T>
__device__ __forceinline__ void clip_factors(T p, T l, T h, T& mp, T& ml, T& mh) {
  const T m = p > l ? p : l;
  const T mm = m < h ? T(1) : (m > h ? T(0) : T(0.5));
  mh = m < h ? T(0) : (m > h ? T(1) : T(0.5));
  const T split = p > l ? T(1) : (p < l ? T(0) : T(0.5));
  mp = mm * split;
  ml = mm * (T(1) - split);
}

// Bytes of shared memory of one env of the linearised backward: the
// triangle, 11 vectors of n and dep, rounded up to 16.
template <typename T>
__host__ __device__ __forceinline__ long long linearised_env_bytes(int n) {
  const long long bytes = ((long long)triangle(n) + 11LL * n) * sizeof(T) + 4LL * n;
  return (bytes + 15) / 16 * 16;
}

template <typename T>
bool linearised_fits(int n) {
  return n >= 1 && linearised_env_bytes<T>(n) <= kSmemMax;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
pgs_backward_linearised(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                        const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                        const T* __restrict__ x_bar, T* __restrict__ a_bar, T* __restrict__ b_bar,
                        T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch, int n, int iterations) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long env = (long long)blockIdx.x * (blockDim.x / G) + group;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* abar_env = a_bar + e * n * n;
  if (iterations == 0) {
    if (active) {
      for (int q = lane; q < n * n; q += G) abar_env[q] = T(0);
      for (int j = lane; j < n; j += G) b_bar[e * n + j] = lo_bar[e * n + j] = hi_bar[e * n + j] = T(0);
    }
    return;
  }
  T* tri = reinterpret_cast<T*>(smem_raw + group * linearised_env_bytes<T>(n));
  T* xt = tri + triangle(n);  // x after sweep t: what rows read before them
  T* xp = xt + n;             // x after sweep t - 1: what rows read after them
  T* xbar = xp + n;           // the adjoint of x after sweep t
  T* bs = xbar + n;
  T* los = bs + n;
  T* his = los + n;
  T* ps = his + n;
  T* fs = ps + n;
  T* es = fs + n;
  T* cs = es + n;
  T* ds = cs + n;
  int* deps = reinterpret_cast<int*>(ds + n);
  const T* a_env = a + e * n * n;
  const int blocks = (n + G - 1) / G;
  const long long sweep = (long long)batch * n;  // xs's stride from one sweep to the next
  // one cp.async group a block of rows, the last block's first, issued
  // two blocks ahead; group 0 also holds the vectors
  for (int j = lane; j < n; j += G) {
    copy_async(bs + j, b + e * n + j);
    copy_async(los + j, lo + e * n + j);
    copy_async(his + j, hi + e * n + j);
    copy_async(deps + j, dep + j);
    copy_async(xbar + j, x_bar + e * n + j);
    copy_async(xt + j, xs + (iterations - 1) * sweep + e * n + j);
    if (iterations > 1) {
      copy_async(xp + j, xs + (iterations - 2) * sweep + e * n + j);
    } else {
      xp[j] = T(0);
    }
  }
  stage_rows(tri, a_env, n, (blocks - 1) * G, n, lane, G);
  copy_commit();
  stage_rows(tri, a_env, n, max(0, (blocks - 2) * G), max(0, (blocks - 1) * G), lane, G);
  copy_commit();
  for (int t = iterations - 1; t >= 0; --t) {
    const bool first = t == iterations - 1;  // the first sweep visited stores, the others add
    if (!first) {
      __syncwarp();
      for (int j = lane; j < n; j += G) {
        xt[j] = xs[t * sweep + e * n + j];
        xp[j] = t > 0 ? xs[(t - 1) * sweep + e * n + j] : T(0);
      }
      __syncwarp();
    }
    for (int k = blocks - 1; k >= 0; --k) {
      const int k0 = k * G;
      const int k1 = min(n, k0 + G);
      if (first) {
        copy_wait<1>();  // block k's rows have landed; block k - 1's may not have
        __syncwarp();
        stage_rows(tri, a_env, n, max(0, k0 - 2 * G), max(0, k0 - G), lane, G);
        copy_commit();
      }
      const int r = k0 + lane;
      const bool row = r < n;
      const int rr = row ? r : n - 1;  // lanes past n shadow the last row
      const T* trow = tri + triangle(rr);
      // (a) p, s and the clip's factors of row rr, from the x it read
      T sum = T(0);
#pragma unroll 4
      for (int j = 0; j < k0; ++j) sum += trow[j] * xt[j];
      for (int j = k0; j < k0 + G; ++j) sum += j < rr ? trow[j] * xt[j] : T(0);
      if (t > 0) {
        const T* a_row = a_env + (long long)rr * n;
        for (int j = rr + 1; j < n; ++j) sum += a_row[j] * xp[j];
      }
      const T aii = trow[rr];
      const T p = (bs[rr] - sum) / aii;
      const int d = deps[rr];
      const T xd = d >= 0 ? (d < rr ? xt[d] : xp[d]) : T(0);
      const T s = d >= 0 ? (xd > T(0) ? xd : T(0)) : T(1);
      T mp, ml, mh;
      clip_factors(p, los[rr] * s, his[rr] * s, mp, ml, mh);
      const T f = -mp / aii;
      const T ef = d >= 0 ? (ml * los[rr] + mh * his[rr]) * relu_slope(xd) : T(0);
      if (row) {
        ps[r] = p;
        fs[r] = f;
        es[r] = ef;
      }
      __syncwarp();
      // (b) g of the block's rows: the later blocks' rows, then the chain
      T acc = xbar[rr];
      for (int i = k1; i < n; ++i) {
        acc += cs[i] * tri[triangle(i) + rr];
        acc += deps[i] == rr ? ds[i] : T(0);
      }
#pragma unroll 4
      for (int m = k1 - k0 - 1; m >= 0; --m) {
        const int i = k0 + m;
        const T w = lane < m ? fs[i] * tri[triangle(i) + rr] + (deps[i] == rr ? es[i] : T(0)) : T(0);
        acc += w * __shfl_sync(0xffffffffu, acc, m, G);
      }
      const T g = acc;
      const T c = f * g;
      if (row) {
        cs[r] = c;
        ds[r] = ef * g;
        if (active) {
          const long long q = e * n + r;
          b_bar[q] = first ? -c : b_bar[q] - c;
          lo_bar[q] = first ? ml * g * s : lo_bar[q] + ml * g * s;
          hi_bar[q] = first ? mh * g * s : hi_bar[q] + mh * g * s;
        }
      }
      __syncwarp();
      // (c) A-bar's rows of the block: c_i times the x row i read
      if (active) {
        for (int i = k0; i < k1; ++i) {
          const T ci = cs[i];
          T* abar_row = abar_env + (long long)i * n;
          for (int j = lane; j < n; j += G) {
            const T v = ci * (j == i ? ps[i] : (j < i ? xt[j] : xp[j]));
            abar_row[j] = first ? v : abar_row[j] + v;
          }
        }
      }
    }
    if (t > 0) {
      // x-bar of sweep t - 1: A's upper part from L2, a row at a time
      for (int j0 = 0; j0 < n; j0 += G) {
        const int j = min(j0 + lane, n - 1);
        T v = T(0);
        for (int i = 0; i < n; ++i) {
          v += i < j ? cs[i] * a_env[(long long)i * n + j] : T(0);
          v += deps[i] == j && j >= i ? ds[i] : T(0);
        }
        if (j0 + lane < n) xbar[j] = v;
      }
    }
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
      T mp, ml, mh;
      clip_factors(p, loi * s, hii * s, mp, ml, mh);
      const T p_bar = mp * g, l_bar = ml * g, h_bar = mh * g;
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

template <typename T>
Plan backward_plan(int n) {
  Plan p;
  if (linearised_fits<T>(n)) {
    p.fn = n <= 16 ? reinterpret_cast<const void*>(&pgs_backward_linearised<T, 16>)
                   : reinterpret_cast<const void*>(&pgs_backward_linearised<T, 32>);
    p.form = kLinearised;
    p.lanes = n <= 16 ? 16 : 32;
    // n <= 16 needs under 2 KB an env: its blocks keep 8 envs, whole warps
    staged_shape(linearised_env_bytes<T>(n), kThreads / p.lanes, &p.envs, &p.smem);
  } else if (n >= 1) {
    p.fn = reinterpret_cast<const void*>(&pgs_backward_per_warp<T>);
    p.form = kStreaming;
    p.lanes = kWarp;
    streaming_shape(3LL * n * sizeof(T), &p.envs, &p.smem);  // x after both sweeps, x-bar
  }
  return p;
}

template <typename T>
int backward(const void* a, const void* b, const void* lo, const void* hi, const void* dep, const void* xs,
             const void* x_bar, void* a_bar, void* b_bar, void* lo_bar, void* hi_bar, int batch, int n,
             int iterations, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = backward_plan<T>(n);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(p.fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((batch + p.envs - 1) / p.envs);
  const int threads = p.envs * p.lanes;
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  const T* lo_t = static_cast<const T*>(lo);
  const T* hi_t = static_cast<const T*>(hi);
  const int* dep_t = static_cast<const int*>(dep);
  const T* xs_t = static_cast<const T*>(xs);
  const T* xbar_t = static_cast<const T*>(x_bar);
  T* abar_t = static_cast<T*>(a_bar);
  T* bbar_t = static_cast<T*>(b_bar);
  T* lobar_t = static_cast<T*>(lo_bar);
  T* hibar_t = static_cast<T*>(hi_bar);
  if (p.form == kStreaming) {
    pgs_backward_per_warp<T><<<blocks, threads, p.smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, xs_t, xbar_t, abar_t, bbar_t,
                                                             lobar_t, hibar_t, batch, n, iterations);
  } else if (p.lanes == 16) {
    pgs_backward_linearised<T, 16><<<blocks, threads, p.smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, xs_t, xbar_t, abar_t,
                                                                   bbar_t, lobar_t, hibar_t, batch, n, iterations);
  } else {
    pgs_backward_linearised<T, 32><<<blocks, threads, p.smem, s>>>(a_t, b_t, lo_t, hi_t, dep_t, xs_t, xbar_t, abar_t,
                                                                   bbar_t, lobar_t, hibar_t, batch, n, iterations);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch-shape query shared by the forward and the backward (see
// tds_pgs_launch_shape below).
int launch_shape(const Plan& p, int* out) {
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(p.fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = p.envs * p.lanes;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, p.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, threads, static_cast<size_t>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.lanes;
  out[1] = p.envs;
  out[2] = threads;
  out[3] = static_cast<int>(attr.sharedSizeBytes + p.smem);
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
  return launch_shape(f64 ? forward_plan<double>(n) : forward_plan<float>(n), out);
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
  return launch_shape(f64 ? backward_plan<double>(n) : backward_plan<float>(n), out);
}

// The form that runs for n rows in float32 (f64 = 0) or float64 (f64 = 1),
// of the forward (backward = 0) or the backward (backward = 1): 0 row per
// lane, 1 blocked, 2 streaming, 3 linearised; -1 for no kernel.
extern "C" int tds_pgs_form(int f64, int n, int backward) {
  if (backward) return f64 ? backward_plan<double>(n).form : backward_plan<float>(n).form;
  return f64 ? forward_plan<double>(n).form : forward_plan<float>(n).form;
}
