// Batched projected Gauss-Seidel (PGS) solve of the contact MLCP, one group
// of lanes per environment, row i on lane i. Built by
// tds_tpu_torch/contact/pgs.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpgs.so pgs.cu
// and called through the plain C functions at the bottom (ctypes).
//
// Replaces the TPU kernel tds_tpu/contact/pallas_pgs.py::_pgs_kernel
// (launched by solve_pgs_pallas). Same arithmetic: `iterations` sweeps
// over the n rows of A x = b starting from x = 0, in pgs_sweep.cuh, which
// the fused step kernel (megastep.cu) shares.
//
// What bounds it on an H100: memory, and below that the launch. Each env
// reads A (n*n values) and b, lo, hi (3n) and writes x (n), against about
// 2*n*n*iterations flops. At B = 4096, n = 12, f32 that is ~3.1 MB, a
// bound of ~0.9 us at 3.35 TB/s; in the step A was just written and sits
// in L2, so the launch itself (~5 us on this card) is the real floor.
//
// Design. The first version ran one thread per env on A's (B, n, n)
// layout: neighbouring threads read addresses n*n apart, no load
// coalesced, and B = 4096 made 32 blocks of 128 threads for 132 SMs (13 us
// on an H100 80GB HBM3). Here each env gets a group of G lanes (16 for
// n = 12, 32 for n = 24): lane i loads row i of A and b_i, lo_i, hi_i, so a
// group's loads cover the env's n*n contiguous values and B = 4096, n = 12
// makes 512 blocks of 128 threads. Each row's x_i is computed on lane i
// and broadcast with __shfl_sync; every lane keeps the whole x in
// registers. A keeps its (B, n, n) layout, so the wrapper adds no
// transpose. The ragged edge: a group past the end of the batch reads the
// last env's operands, runs the sweeps with the rest of its warp (the
// shuffles need every lane) and stores nothing.

#include <cuda_runtime.h>

#include "pgs_sweep.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct Lanes {
  static constexpr int G = N <= 16 ? 16 : 32;
};

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

template <typename T, int N>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&pgs_kernel<T, N, Lanes<N>::G>);
}

template <typename T>
const void* kernel_for(int n) {
  switch (n) {
    case 12: return kernel_of<T, 12>();
    case 24: return kernel_of<T, 24>();
    default: return nullptr;
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
  switch (n) {
    case 12: {
      constexpr int envs = kThreads / Lanes<12>::G;
      pgs_kernel<T, 12, Lanes<12>::G><<<(batch + envs - 1) / envs, kThreads, 0, s>>>(
          a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, iterations);
      break;
    }
    case 24: {
      constexpr int envs = kThreads / Lanes<24>::G;
      pgs_kernel<T, 24, Lanes<24>::G><<<(batch + envs - 1) / envs, kThreads, 0, s>>>(
          a_t, b_t, lo_t, hi_t, dep_t, x_t, batch, iterations);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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

// The launch shape of the instance for n rows in float32 (f64 = 0) or
// float64 (f64 = 1), on the current device: out[0] lanes per env, out[1]
// envs per block, out[2] threads per block, out[3] shared memory per block
// (bytes), out[4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] registers per
// thread and out[6] local memory per thread (bytes; stack frame and
// spills), both from cudaFuncGetAttributes. Returns a cudaError_t.
extern "C" int tds_pgs_launch_shape(int f64, int n, int* out) {
  const void* fn = f64 ? kernel_for<double>(n) : kernel_for<float>(n);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = n <= 16 ? 16 : 32;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = lanes;
  out[1] = kThreads / lanes;
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
