// Batched projected Gauss-Seidel (PGS) solve of the contact MLCP, one
// thread per environment. Built by tds_tpu_torch/contact/pgs.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpgs.so pgs.cu
// and called through the plain C functions at the bottom (ctypes).
//
// Replaces the TPU kernel tds_tpu/contact/pallas_pgs.py::_pgs_kernel
// (launched by solve_pgs_pallas). Same arithmetic: `iterations` sweeps
// over the n rows of A x = b starting from x = 0, in pgs_sweep.cuh, which
// the fused step kernel (megastep.cu) shares.
//
// What bounds it on an H100: memory. Each env reads A (n*n values) and
// b, lo, hi (3n) and writes x (n), against about 2*n*n*iterations flops.
// At B = 4096, n = 12, f32 that is ~3.1 MB, a bound of ~0.9 us at
// 3.35 TB/s; at n = 24 ~11 MB, ~3.3 us. The arithmetic is negligible, and
// at these sizes the launch itself costs more than the work. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W power limit) at
// B = 4096, n = 12, f32: 13 us of device time, 14x the bound, from the
// uncoalesced reads of A below and 32 blocks on 132 SMs.
//
// Design (first version: simple and right). One thread per env; n is a
// template parameter (12 and 24 are instantiated) so the row loops unroll
// fully and x[] lives in registers. dep[] is a small int32 device array;
// x[dep_i] is picked with an unrolled select (pgs_sweep.cuh). A is read
// in its (B, n, n) row-major layout, so neighbouring threads read
// addresses n*n apart and the loads do not coalesce; the TPU kernel's
// batch-minor (n*n, B) layout would coalesce them, which is later work.
// The ragged edge of the batch is a bounds check; nothing is padded.

#include <cuda_runtime.h>

#include "pgs_sweep.cuh"

namespace {

// One env's operands in global memory, in the (B, n, n) / (B, n) layout;
// the pointers come from the kernel's const __restrict__ parameters.
template <typename T, int N>
struct GlobalProblem {
  const T* a_e;
  const T* b_e;
  const T* lo_e;
  const T* hi_e;
  const int* dep_;
  __device__ T a(int i, int j) const { return a_e[i * N + j]; }
  __device__ T b(int i) const { return b_e[i]; }
  __device__ T lo(int i) const { return lo_e[i]; }
  __device__ T hi(int i) const { return hi_e[i]; }
  __device__ int dep(int i) const { return dep_[i]; }
};

template <typename T, int N>
__global__ void pgs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const T* __restrict__ lo, const T* __restrict__ hi,
                           const int* __restrict__ dep, T* __restrict__ x_out,
                           int batch, int iterations) {
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;
  const GlobalProblem<T, N> problem{a + env * N * N, b + env * N,
                                    lo + env * N, hi + env * N, dep};
  T x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = T(0);
  pgs_sweeps<T, N>(x, problem, iterations);
#pragma unroll
  for (int i = 0; i < N; ++i) x_out[env * N + i] = x[i];
}

template <typename T>
int launch(const void* a, const void* b, const void* lo, const void* hi,
           const void* dep, void* x, int batch, int n, int iterations,
           void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (batch + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  const T* lo_t = static_cast<const T*>(lo);
  const T* hi_t = static_cast<const T*>(hi);
  const int* dep_t = static_cast<const int*>(dep);
  T* x_t = static_cast<T*>(x);
  switch (n) {
    case 12:
      pgs_kernel<T, 12><<<blocks, kThreads, 0, s>>>(a_t, b_t, lo_t, hi_t, dep_t,
                                                     x_t, batch, iterations);
      break;
    case 24:
      pgs_kernel<T, 24><<<blocks, kThreads, 0, s>>>(a_t, b_t, lo_t, hi_t, dep_t,
                                                     x_t, batch, iterations);
      break;
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
