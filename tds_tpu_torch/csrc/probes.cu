// The two probe kernels of the JAX package's tools/mosaic_probe.py, which
// checked whether the TPU compiler handles minor-dimension reshapes and
// transposes (it did not, and that blocked the fused step there). Built by
// tds_tpu_torch/tools/kernel_probe.py (through utils/cuda_build.py) and
// called through the plain C functions at the bottom (ctypes).
//
// Replace tools/mosaic_probe.py minor_dim_reshape (K3, :26) and
// minor_dim_transpose (K4, :36). Both are float32 and bound by memory:
// each element is read once and written once, with one add per output in
// reshape_sum. One thread per output element, 256 threads per block.

#include <cuda_runtime.h>

namespace {

// out[i] = x[2 i] + x[2 i + 1]: x.reshape(..., n / 2, 2).sum(-1) on a
// contiguous x, whose pairs are adjacent in memory
__global__ void reshape_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   long long n_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_out) out[i] = x[2 * i] + x[2 * i + 1];
}

// out[b, c, r] = x[b, r, c] for x (batch, rows, cols): the two minor
// dimensions swapped; neighbouring threads write neighbouring outputs
__global__ void transpose_minor_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       long long batch, int rows, int cols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * rows * cols) return;
  const int r = i % rows;
  const long long bc = i / rows;
  const int c = bc % cols;
  const long long b = bc / cols;
  out[i] = x[(b * rows + r) * cols + c];
}

constexpr int kThreads = 256;

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

// x and out contiguous float32 on the current device. Launch on `stream`
// without synchronising and return cudaGetLastError().
extern "C" int tds_reshape_sum(const void* x, void* out, long long n_out, void* stream) {
  reshape_sum_kernel<<<blocks_for(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tds_transpose_minor(const void* x, void* out, long long batch, int rows, int cols,
                                   void* stream) {
  transpose_minor_kernel<<<blocks_for(batch * rows * cols), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), batch, rows, cols);
  return static_cast<int>(cudaGetLastError());
}
