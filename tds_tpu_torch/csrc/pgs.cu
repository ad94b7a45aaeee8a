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
