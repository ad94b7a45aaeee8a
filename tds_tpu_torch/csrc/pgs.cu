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
// sweep (iterations > 1, or from a warm start) a row's columns above the
// diagonal come from global memory (L2), a lane walking its own row: every
// path runs one sweep. (The forward mode's warp-cooperative pass over the
// rows, row_sums, coalesced and 32 rows at a time, measured slower here:
// 53.5 against 47.5 us from a warm start at n = 105, B = 1024, f32 on an
// H100 80GB HBM3.) A row's sum runs in double in both types: in float32 a
// sum of up to n products in order, in float32, strayed from the plain sweep's by
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
//
// Saved sweeps (every form past one sweep, from x = 0 or x0): when the
// wrapper expects a backward it passes xs (iterations - 1, B, n), and the
// launch stores x after each sweep but the last there, so that the
// backward reads the forward's own sweeps: lane i its x_i in the row-per-
// lane form, the warp its env's x from shared memory, coalesced, in the
// blocked and streaming forms. That adds (iterations - 1) B n values
// written to the bytes. The stores are instances of their own (a Save
// template flag), launched only with xs: the instances a forward without
// grad launches never read the pointer (it comes last in every forward
// kernel's parameters) and compile to exactly what they did before it
// existed. (A pointer tested once a sweep in the same instances took 2-28
// more registers in most of the Split ones, and in the float32 padded
// N = 24 one (n = 17-23) from x = 0 a resident block an SM: 6 at 77
// registers against 7 at 72; the blocked ones 152 more instructions;
// cuobjdump, built for an H100 80GB HBM3.)

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

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

// The minimum resident blocks the row-per-lane kernels are built for: 0
// (no minimum) for the zero start's one-sweep instances (Split false),
// which compile as they did; for the instances that split the sweeps
// (Split: more sweeps, a warm start) 1 in float64, with which ptxas keeps
// every value in registers (without it, to fit more blocks, it spilled
// 8-24 B a thread in N = 12 and 16), and in float32, whose sums run in
// double, a register cap for each N that holds them (with no minimum
// ptxas took 48 registers and spilled 8-16 B at N = 8, 16 and 24; the
// warm N = 24 instance spilled 8 B at a cap of 102 registers and the warm
// N = 32 one at 170; on an H100 80GB HBM3). The forward mode (pgs_jvp_rows) keeps a minimum of 1
// for float64 and for N = 32 (whose float32 instance spilled 16 B without
// it) and none for the other float32 N: with it the float32 N = 24
// instance took 219 registers, 8 warps an SM and 34.5 us from x0 at B =
// 4096, against 116, 16 and 27.7 us. The saving instances (Save) keep
// their twins' caps but two: in float32 at N <= 16 from x0, where ptxas
// spilled 4-8 B at the twin's cap of 80 registers and at 96, 4; in float64
// at N = 24 from x0, where the saved sweeps took 156 registers against the
// twin's 128 and a resident block an SM (112.4 against 95.1 us at n = 24,
// B = 4096, 10 sweeps, on an H100 80GB HBM3), 4: the twin's count.
template <typename T, bool Split, int N, bool Warm = false, bool Save = false>
struct RowBlocks {
  static constexpr int kTwin = !Split ? 0
                               : sizeof(T) == 8 ? 1
                               : N >= 32 ? (Warm ? 1 : 3)
                               : N >= 24 ? (Warm ? 3 : 5)
                                         : 6;
  static constexpr int kMin = !(Save && Warm) ? kTwin
                              : sizeof(T) == 4 && N < 24 ? 4
                              : sizeof(T) == 8 && N >= 24 && N < 32 ? 4
                                                                    : kTwin;
};

template <typename T, int N>
struct JvpBlocks {
  static constexpr int kMin = sizeof(T) == 8 || N == 32 ? 1 : 0;
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
// row-per-lane kernel as it was before padding existed; Split as in
// pgs_sweeps (K1 launches the instance without it for at most one sweep).
// With Save (and Split), xs (iterations - 1, B, n): x after each sweep but
// the last (every forward kernel takes xs last, so that the instances
// without Save keep their code).
template <typename T, int N, int G, bool Split = false, bool Save = false>
__global__ void __launch_bounds__(kThreads, RowBlocks<T, Split, N, false, Save>::kMin)
pgs_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
           const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
           int batch, int iterations, T* __restrict__ xs) {
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
  T* saved = Save && active && lane < N ? xs + e * N + lane : nullptr;
  const T mine = pgs_sweeps<T, N, G, false, Split, Save>(x, row, iterations, T(0), T(0), 0, saved, batch * N);
  if (active && lane < N) x_out[e * N + lane] = mine;
}

// n < N: rows n..N-1 are identity rows in registers. With Warm (any
// n <= N) the sweeps start from x0 (B, n), the padding rows from 0.
template <typename T, int N, int G, bool Warm = false, bool Split = Warm, bool Save = false>
__global__ void __launch_bounds__(kThreads, RowBlocks<T, Split, N, Warm, Save>::kMin)
pgs_kernel_padded(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                  const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                  int batch, int n, int iterations, const T* __restrict__ x0, T* __restrict__ xs) {
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
  T start = T(0), start_dep = T(0);  // x0 of the lane's row and of its dependency
  SweepAcc<T, Split> upper = 0;      // the row's columns after it against x0
  if (Warm) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T v = j < n ? x0[e * n + j] : T(0);
      x[j] = v;
      if (j > lane) upper += SweepAcc<T, Split>(row.a[j]) * SweepAcc<T, Split>(v);
    }
    start = real ? x0[e * n + r] : T(0);
    start_dep = row.dep >= 0 ? x0[e * n + row.dep] : T(0);
  }
  T* saved = Save && active && lane < n ? xs + e * n + lane : nullptr;
  const T mine = pgs_sweeps<T, N, G, Warm, Split, Save>(x, row, iterations, start, start_dep, upper, saved, batch * n);
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

// Row i in sweep `it` of one env: the first sweep from x = 0 has x_j = 0
// for j >= i, so it needs the columns up to the end of i's block of 32 (a
// warm start passes it = 1: every column).
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

// The type a streaming form's row sums run in: T for one sweep from x = 0
// (the zero start's instances as they were), double when a sweep sums every
// column (Split: from a warm start or past the first sweep): in float32 a
// 340-column sum strayed from the plain sweep's in float64 by 6.6e-6 from a
// warm start, and at n = 336 after 10 sweeps from x = 0 by 1.1e-6 more
// than the float32 tolerance allows (on an H100 80GB HBM3), as the blocked
// forms' sums did at n = 97 before they ran in double.
template <typename T, bool Split>
using StreamAcc = typename std::conditional<Split, double, T>::type;

// n > 32: one warp per env, envs_per_block warps a block, x in shared
// memory (n values a warp). Each row's loads are issued while the row
// before it is reduced and clipped, so the chain of dependent rows waits on
// a shuffle reduction and a divide a row, not on a memory round trip. With
// Save, xs as pgs_kernel's: the warp stores x from shared memory after
// each sweep but the last, coalesced.
template <typename T, bool Warm = false, bool Split = Warm, bool Save = false>
__global__ void pgs_kernel_per_warp(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                                    const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                                    int batch, int n, int iterations, const T* __restrict__ x0, T* __restrict__ xs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* x = reinterpret_cast<T*>(smem_raw) + (long long)warp * n;
  for (int j = lane; j < n; j += kWarp) x[j] = Warm ? x0[e * n + j] : T(0);
  __syncwarp();
  const T* a_env = a + e * n * n;
  const T* b_env = b + e * n;
  const T* lo_env = lo + e * n;
  const T* hi_env = hi + e * n;
  WarpRow<T> cur;
  load_warp_row(cur, a_env, b_env, lo_env, hi_env, dep, 0, Warm ? 1 : 0, n, lane);
  for (int it = 0; it < iterations; ++it) {
    for (int i = 0; i < n; ++i) {
      // the next row's loads (row 0 of the next sweep after the last row)
      WarpRow<T> next;
      const bool wrap = i + 1 == n;
      load_warp_row(next, a_env, b_env, lo_env, hi_env, dep, wrap ? 0 : i + 1, Warm ? 1 : (wrap ? it + 1 : it), n, lane);
      // this lane's columns in increasing j, then a butterfly over the warp
      using Acc = StreamAcc<T, Split>;
      Acc partial = Acc(0);
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int j = lane + kWarp * k;
        if (j < cur.cols && j != i) partial += Acc(cur.a[k]) * Acc(x[j]);
      }
      const T* a_row = a_env + (long long)i * n;
      for (int j = lane + kWarp * kHeld; j < cur.cols; j += kWarp) {
        if (j != i) partial += Acc(a_row[j]) * Acc(x[j]);
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        partial += __shfl_xor_sync(0xffffffffu, partial, offset);
      }
      T xi = T((Acc(cur.b) - partial) / Acc(cur.aii));
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
    if (Save && it + 1 < iterations && active) {
      T* saved = xs + (long long)it * batch * n + e * n;
      for (int j = lane; j < n; j += kWarp) saved[j] = x[j];
    }
  }
  if (active) {
    for (int j = lane; j < n; j += kWarp) x_out[e * n + j] = x[j];
  }
}

// The forms, as tds_pgs_instance_form reports them.
enum Form { kRowPerLane = 0, kBlocked = 1, kStreaming = 2, kLinearised = 3, kSweeps = 4, kSweepsWhole = 5 };

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

// One exchange step of transposed_sum: of the 2 Half values left, each
// lane keeps the half its lane bit `Offset` names and adds its partner's
// copy of it; then the next step.
template <int R, int Half, int Offset, typename V>
__device__ __forceinline__ void halve(V (&v)[R], int lane) {
  if constexpr (Half >= 1) {
    const bool high = lane & Offset;
#pragma unroll
    for (int m = 0; m < Half; ++m) {
      const V keep = high ? v[m + Half] : v[m];
      v[m] = keep + __shfl_xor_sync(0xffffffffu, high ? v[m] : v[m + Half], Offset);
    }
    halve<R, Half / 2, Offset / 2>(v, lane);
  }
}

// The totals over the warp's 32 lanes of R values a lane (R = 8 or 16):
// lane l gets the total of v[l / (32 / R)]. The exchanges (halve) take
// R - 1 shuffles, butterfly steps log2(32 / R) more, where a butterfly each
// takes 5 R. v is consumed.
template <int R, typename V>
__device__ __forceinline__ V transposed_sum(V (&v)[R], int lane) {
  static_assert(R == 8 || R == 16, "8 or 16 values a lane");
  halve<R, R / 2, 16>(v, lane);
#pragma unroll
  for (int offset = 16 / R; offset >= 1; offset /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], offset);
  return v[0];
}

// Row sums of the rows r = k0 + lane of a block of 32: out[q] = sum over
// the columns j in [c0, c1) of A_rj z(q, r, j), with A's rows read from
// global memory by the whole warp, R rows at a time, lane l taking the
// columns j = c0 + l (mod 32) of each in increasing j (a warp's load is
// one row's 32 consecutive values, and the R of a column chunk are issued
// together), and transposed_sum handing row k0 + R g + m's totals to lane
// R g + m. The sums run in double. z(q, r, j) is the value column j meets
// in row r's sum q (0 where the sum skips it). The warp calls it together
// (the shuffles name every lane); lanes past n get 0.
template <int V, int R, typename T, typename Z>
__device__ __forceinline__ void row_sums(const T* a_env, int n, int k0, int c0, int c1, Z z, double (&out)[V],
                                         int lane) {
#pragma unroll
  for (int q = 0; q < V; ++q) out[q] = 0.0;
  const int rows = min(32, n - k0);
  for (int g = 0; R * g < rows; ++g) {
    double p[V][R];
#pragma unroll
    for (int q = 0; q < V; ++q) {
#pragma unroll
      for (int m = 0; m < R; ++m) p[q][m] = 0.0;
    }
#pragma unroll 1
    for (int j0 = c0; j0 < c1; j0 += 32) {
      // the R loads first, unconditionally (clamped into the matrix; the
      // terms past its edge are dropped), so that all are in flight at once
      const int j = j0 + lane;
      const int jc = min(j, c1 - 1);
      T arj[R];
#pragma unroll
      for (int m = 0; m < R; ++m) arj[m] = a_env[(long long)min(k0 + R * g + m, n - 1) * n + jc];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = k0 + R * g + m;
        if (r < n && j < c1) {
#pragma unroll
          for (int q = 0; q < V; ++q) p[q][m] += double(arj[m]) * double(z(q, r, j));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const double total = transposed_sum(p[q], lane);
      const double mine = __shfl_sync(0xffffffffu, total, (lane % R) * (32 / R));
      out[q] = lane / R == g ? mine : out[q];
    }
  }
}

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

// With Save, xs as pgs_kernel's: the warp stores x from shared memory after
// each sweep but the last, coalesced.
template <typename T, bool Warm = false, bool Save = false>
__global__ void __launch_bounds__(kThreads, Resident<T>::kBlocks)
pgs_kernel_blocked(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                   const T* __restrict__ hi, const int* __restrict__ dep, T* __restrict__ x_out,
                   int batch, int n, int iterations, const T* __restrict__ x0, T* __restrict__ xs) {
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
    x[j] = Warm ? x0[e * n + j] : T(0);
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
      if (Warm || it > 0) {
        // the previous sweep's x (or x0) after the row: A's upper part from L2
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
    if (Save && it + 1 < iterations && active) {
      T* saved = xs + (long long)it * batch * n + e * n;
      for (int j = lane; j < n; j += kWarp) saved[j] = x[j];
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

// The resident envs per SM of `fn` with `per_env` bytes an env, `lanes`
// lanes each, at `most`, most / 2, ... envs a block (whole warps, each
// block's shared memory within 227 KB): the shape that keeps the most
// envs resident, the larger block at a tie (envs 0: none fits).
struct Occupancy {
  int envs = 0;
  long long smem = 0;
  int per_sm = -1;
};

inline Occupancy most_resident(const void* fn, long long per_env, int most, int lanes) {
  Occupancy best;
  for (int envs = most; envs * lanes >= kWarp; envs /= 2) {
    const long long smem = envs * per_env;
    int blocks = 0;
    if (smem > kSmemMax || allow_smem(fn, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, envs * lanes, static_cast<size_t>(smem)) !=
            cudaSuccess) {
      continue;
    }
    if (blocks * envs > best.per_sm) best = {envs, smem, blocks * envs};
  }
  return best;
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

template <typename T, int N, bool Warm, bool Split, bool Save>
const void* row_kernel(int n) {
  if (n == N && !Warm) return reinterpret_cast<const void*>(&pgs_kernel<T, N, Lanes<N>::G, Split, Save>);
  return reinterpret_cast<const void*>(&pgs_kernel_padded<T, N, Lanes<N>::G, Warm, Split, Save>);
}

// With Warm the plan of the warm-start instances: the same forms and
// shapes, the row-per-lane form through pgs_kernel_padded for every n.
// Split: the instances for more than one sweep (always with Warm). Save:
// the saving instances (with Split, or the blocked form).
template <typename T, bool Warm = false, bool Split = Warm, bool Save = false>
Plan forward_plan(int n) {
  Plan p;
  const int rows = instance_rows(n);
  if (rows != 0) {
    switch (rows) {
      case 8: p.fn = row_kernel<T, 8, Warm, Split, Save>(n); break;
      case 12: p.fn = row_kernel<T, 12, Warm, Split, Save>(n); break;
      case 16: p.fn = row_kernel<T, 16, Warm, Split, Save>(n); break;
      case 24: p.fn = row_kernel<T, 24, Warm, Split, Save>(n); break;
      default: p.fn = row_kernel<T, 32, Warm, Split, Save>(n); break;
    }
    p.form = kRowPerLane;
    p.lanes = rows <= 16 ? 16 : 32;
    p.envs = kThreads / p.lanes;
  } else if (blocked_fits<T>(n)) {
    p.fn = reinterpret_cast<const void*>(&pgs_kernel_blocked<T, Warm, Save>);
    p.form = kBlocked;
    p.lanes = kWarp;
    staged_shape(blocked_env_bytes<T>(n), kThreads / kWarp, &p.envs, &p.smem);
  } else if (n > 32) {
    p.fn = reinterpret_cast<const void*>(&pgs_kernel_per_warp<T, Warm, Split, Save>);
    p.form = kStreaming;
    p.lanes = kWarp;
    streaming_shape((long long)n * sizeof(T), &p.envs, &p.smem);  // x
  }
  return p;
}

// Every forward kernel takes the same arguments (a, b, lo, hi, dep, x, batch,
// n, iterations, x0, xs) but pgs_kernel, which takes neither n nor x0.
template <typename T>
using ForwardKernel = void (*)(const T*, const T*, const T*, const T*, const int*, T*, int, int, int, const T*, T*);

// One launch of K1's forward by its plan: x0 null from x = 0, xs null
// without Save.
template <typename T, bool Warm, bool Split, bool Save>
int launch_plan(const T* a, const T* b, const T* lo, const T* hi, const int* dep, const T* x0, T* x, T* xs, int batch,
                int n, int iterations, cudaStream_t s) {
  const Plan p = forward_plan<T, Warm, Split, Save>(n);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(p.fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((batch + p.envs - 1) / p.envs);
  const int threads = p.envs * p.lanes;
  if (p.form == kRowPerLane && n == instance_rows(n) && !Warm) {
    // pgs_kernel: exactly N rows from x = 0
    const auto kernel = reinterpret_cast<void (*)(const T*, const T*, const T*, const T*, const int*, T*, int, int, T*)>(
        const_cast<void*>(p.fn));
    kernel<<<blocks, threads, 0, s>>>(a, b, lo, hi, dep, x, batch, iterations, xs);
  } else {
    const auto kernel = reinterpret_cast<ForwardKernel<T>>(const_cast<void*>(p.fn));
    kernel<<<blocks, threads, p.smem, s>>>(a, b, lo, hi, dep, x, batch, n, iterations, x0, xs);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 from x = 0 (x0 null) or from the warm start x0 (B, n): from x = 0 the
// instances without Split for at most one sweep (the paths' launches, as
// they were), with Split for more; from x0 the Warm instances (the zero
// start's are untouched). xs (iterations - 1, B, n) or null: with it the
// saving instances, which store x after each sweep but the last there.
template <typename T>
int launch(const void* a, const void* b, const void* lo, const void* hi, const void* dep, const void* x0, void* x,
           void* xs, int batch, int n, int iterations, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a_t = static_cast<const T*>(a);
  const T* b_t = static_cast<const T*>(b);
  const T* lo_t = static_cast<const T*>(lo);
  const T* hi_t = static_cast<const T*>(hi);
  const int* dep_t = static_cast<const int*>(dep);
  const T* x0_t = static_cast<const T*>(x0);
  T* x_t = static_cast<T*>(x);
  T* xs_t = static_cast<T*>(xs);
#define TDS_FORWARD_ARGS a_t, b_t, lo_t, hi_t, dep_t, x0_t, x_t, xs_t, batch, n, iterations, s
  const bool save = xs != nullptr && iterations > 1;
  // the row-per-lane saving instances step from one sweep to the next by an int, B n
  if (save && (long long)batch * n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (x0 != nullptr) {
    return save ? launch_plan<T, true, true, true>(TDS_FORWARD_ARGS) : launch_plan<T, true, true, false>(TDS_FORWARD_ARGS);
  }
  if (iterations > 1) {
    return save ? launch_plan<T, false, true, true>(TDS_FORWARD_ARGS) : launch_plan<T, false, true, false>(TDS_FORWARD_ARGS);
  }
  return launch_plan<T, false, false, false>(TDS_FORWARD_ARGS);
#undef TDS_FORWARD_ARGS
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
// Saved state: x after every sweep, the forward's own: xs (iterations - 1,
// B, n), x after each sweep but the last, which the forward stores as it
// sweeps when the wrapper (contact/pgs.py) asks (a backward can follow),
// and x (B, n), its output: both from the same forward instance, so that
// every clip is undone as that forward decided it. x
// before sweep 0 is 0, or a warm
// start x0 (B, n): the Warm instances read it where the zero start's read
// 0 (and the first sweep's columns above the diagonal, which a zero start
// skips), and write x0-bar, the adjoint of x left when sweep 0 is undone:
// the x-bar "of sweep -1". Each row's p_i is recomputed from
// the saved x; its sum runs in another order than the forward's, so p_i may differ
// from the forward's by rounding, which moves A-bar_ii by as much and picks
// another branch of the clip only where p_i lies within rounding of a
// bound without sitting on it.
//
// What bounds it on an H100: memory, and the chain of dependent rows. Each
// env reads A (its lower triangle with one sweep), b, lo, hi, xs and x-bar
// and writes A-bar whole (zeros above the diagonal with one sweep:
// autograd takes a dense (B, n, n) gradient), b-bar, lo-bar and hi-bar.
//
// "linearised" (one sweep from x = 0, every n whose staging fits a block):
// the saved sweeps fix every p_i, s_i and so the clip's factors, so the
// walk is linear in g and only one multiply-add a row stays on the chain.
// For sweep t, in reverse:
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
// forward stages them, the last block's rows first. G = 16 lanes for
// n <= 16 (two envs a warp), else 32.
//
// "linearised sweeps" (two sweeps or more, from x = 0 or x0:
// pgs_backward_sweeps): the same (a) and (b), with what the later sweeps
// and x0 add kept on chip. The one-sweep design read x after sweeps t and t - 1 from global
// memory again at each sweep, walked each row's columns above the diagonal
// a lane a row from L2 (the lanes' addresses n apart), read and wrote
// A-bar, b-bar, lo-bar and hi-bar in global memory at every sweep, and
// formed x-bar of sweep t - 1 with every lane walking all n rows of A
// from L2 (152.5 us from x0 at n = 105, B = 1024, f32, a 28.0 us bound;
// 39.2-40.9 us at n = 3 with 4 sweeps, the forward 14.2-14.5; on an H100
// 80GB HBM3). Here:
// - x before every sweep (x0 or 0, then each saved sweep) is staged once,
//   with the vectors, in the first cp.async group; c of every sweep is
//   kept in shared memory, and A-bar_ii's sum c_i p_i, lo-bar and hi-bar
//   are summed across sweeps there (in the order of the sweeps, the last
//   first). After the last sweep visited, A-bar_ij = sum_t c_i(t) x_j(t)
//   (this sweep's x for j < i, the previous sweep's for j > i) and
//   b-bar_i = -sum_t c_i(t) are written once, coalesced, and nothing is
//   read back.
// - A's part above the diagonal: "A whole" stages it in shared memory too
//   (columns packed: A_ij, i < j, at triangle(j - 1) + i, copied from A's
//   rows as the triangle is, a block's rows a group), so that (a)'s sums
//   over the columns after each row and x-bar's pass read shared memory
//   with consecutive lanes on consecutive addresses. Where it would cost
//   resident envs (n = 48 and 105 in f32: the paths' batches fill a wave
//   with the triangle alone), "upper streamed": one coalesced pass over
//   A's rows in L2 after each sweep (upper_pass: 8 rows at a time, lanes
//   across the columns, the loads issued first) forms both x-bar of sweep
//   t - 1 and the next sweep's sums over the columns after each row,
//   u_i = sum_{j > i} A_ij x_j(t - 2), which (a) then reads from shared
//   memory; one such pass at entry forms the last sweep's. The plan takes
//   "A whole" where it keeps at least the resident envs of "upper
//   streamed" (cudaOccupancyMaxActiveBlocksPerMultiprocessor of each, and
//   4, 2 or 1 envs a block, whichever keeps the most resident; G = 16
//   runs "A whole" only).
// Its sums run in T, as the one-sweep design's (in double, 197.3 us from x0
// at n = 105, B = 1024, f32, against 152.1 in T). One sweep from x0 keeps
// the first design, which it does not beat there: 155.1 against 151.7 us
// at n = 105, 15.0 against 12.8 at n = 12, 90.1 against 74.3 at n = 48
// (B = 4096, f32); past one sweep it does: 3 sweeps from 0 at n = 48
// 145.8 against 300.4 us, at n = 105 434.8 against 640.6, the Panda
// push's n = 24 at 10 sweeps 156.3 against 212.3 (all on an H100 80GB
// HBM3 at 700 W).
//
// "streaming" (past the staged forms' limits: n > 328 in f32, > 229 in
// f64 for one sweep from 0, fewer rows with more sweeps): a warp per env,
// lane l owns
// the columns j = l (mod 32); this sweep's x, the previous sweep's and
// x-bar sit in shared memory (3n values a warp), each row's p_i is a
// butterfly over the warp, and row i of A-bar goes straight to global
// memory (stored by the last sweep, the first in reverse, added to by the
// sweeps before it). Before the linearised form it ran every n > 32
// (237.4-239.3 us at n = 105, B = 1024, f32 on an H100 80GB HBM3), and n <=
// 32 ran lane j owning column j of A and of A-bar in registers, a
// butterfly and seven shuffles a row.

// relu_slope and clip_factors (pgs_sweep.cuh) give the clip's and the
// bound scale's factors, shared with the forward mode below.

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

// x after sweep t (0-based) of `iterations`: the forward's output x for the
// last, else its saved sweep t in xs, `sweep` = B n values apart.
template <typename T>
__device__ __forceinline__ const T* sweep_x(const T* xs, const T* x, int t, int iterations, long long sweep) {
  return t + 1 == iterations ? x : xs + t * sweep;
}

// Launched for one sweep (or none), from x = 0 or from x0;
// pgs_backward_sweeps runs two or more. Its code is the first design's, for
// every count (its branches for t > 0 are no longer launched), so that the
// one-sweep instances compile to what they were.
template <typename T, int G, bool Warm = false>
__global__ void __launch_bounds__(kThreads)
pgs_backward_linearised(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                        const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                        const T* __restrict__ x, const T* __restrict__ x_bar, T* __restrict__ a_bar, T* __restrict__ b_bar,
                        T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch, int n, int iterations,
                        const T* __restrict__ x0, T* __restrict__ x0_bar) {
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
      if (Warm) {
        for (int j = lane; j < n; j += G) x0_bar[e * n + j] = x_bar[e * n + j];
      }
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
    copy_async(xt + j, x + e * n + j);
    if (iterations > 1) {
      copy_async(xp + j, xs + (iterations - 2) * sweep + e * n + j);
    } else {
      xp[j] = Warm ? x0[e * n + j] : T(0);
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
        xp[j] = t > 0 ? xs[(t - 1) * sweep + e * n + j] : (Warm ? x0[e * n + j] : T(0));
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
      if (Warm || t > 0) {
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
    if (Warm || t > 0) {
      // x-bar of sweep t - 1 (of x0 at t = 0): A's upper part from L2, a
      // row at a time
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
  if (Warm && active) {
    __syncwarp();
    for (int j = lane; j < n; j += G) x0_bar[e * n + j] = xbar[j];
  }
}

// The packed layout of A's part above the diagonal in the "A whole"
// staging: column j's rows 0..j-1 at triangle(j - 1), so that consecutive
// rows of a column and (the triangular numbers of 32 consecutive columns
// being distinct mod 32, mod 16 within a half-warp for 8-byte values) one
// row across consecutive columns both meet distinct banks.
__host__ __device__ __forceinline__ int upper_at(int i, int j) { return triangle(j - 1) + i; }

// Rows [r0, r1) of an env's A, the columns after the diagonal, into the
// packed upper part, G lanes walking each row (loads coalesced).
template <typename T>
__device__ __forceinline__ void stage_upper_rows(T* up, const T* a_env, int n, int r0, int r1, int lane, int G) {
  for (int r = r0; r < r1; ++r) {
    const T* src = a_env + (long long)r * n;
    for (int c = r + 1 + lane; c < n; c += G) copy_async(up + upper_at(r, c), src + c);
  }
}

// Bytes of shared memory of one env of pgs_backward_sweeps for `iterations`
// sweeps (with `whole`, A's upper part staged too): the triangle, x before
// each sweep and after the last, c of each sweep, 11 vectors of n (x-bar,
// b, lo, hi, f, e, d, u, lo-bar, hi-bar and A-bar's diagonal) and dep,
// rounded up to 16.
template <typename T>
__host__ __device__ __forceinline__ long long sweeps_env_bytes(int n, int iterations, bool whole) {
  const long long values = (long long)triangle(n) + (whole ? (long long)triangle(n - 1) : 0LL) +
                           (2LL * iterations + 1) * n + 11LL * n;
  return (values * sizeof(T) + 4LL * n + 15) / 16 * 16;
}

// One coalesced pass over an env's A above the diagonal in global memory
// (L2), the warp together: R = 8 rows at a time, lanes across the columns,
// the loads of up to 4 chunks of 32 columns issued first (a chunk a round
// trip was 152 us from x0 at n = 105, B = 1024, f32: the parent's time,
// on an H100 80GB HBM3). With c, x-bar_j +=
// sum over i < j of c_i A_ij (each lane adds to its own columns); with z,
// u_i = sum over j > i of A_ij z_j, handed to the rows' lanes by
// transposed_sum. The sums run in T, as the one-sweep backward's.
template <typename T>
__device__ __forceinline__ void upper_pass(const T* a_env, int n, const T* c, T* xbar, const T* z, T* u, int lane) {
  constexpr int R = 8;       // rows a group
  constexpr int kChunks = 4;  // chunks of 32 columns whose loads are in flight together
  for (int i0 = 0; i0 < n; i0 += R) {
    T p[R];
#pragma unroll
    for (int m = 0; m < R; ++m) p[m] = T(0);
#pragma unroll 1
    for (int b0 = (i0 + 1) / kWarp * kWarp; b0 < n; b0 += kChunks * kWarp) {
      T arj[kChunks][R];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int jc = min(b0 + q * kWarp + lane, n - 1);
#pragma unroll
        for (int m = 0; m < R; ++m) arj[q][m] = a_env[(long long)min(i0 + m, n - 1) * n + jc];
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int j = b0 + q * kWarp + lane;
        const int jc = min(j, n - 1);
        T v = T(0);
        const T zj = z != nullptr ? z[jc] : T(0);
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (i0 + m < j && j < n) {
            if (c != nullptr) v += c[i0 + m] * arj[q][m];
            p[m] += arj[q][m] * zj;
          }
        }
        if (c != nullptr && j < n) xbar[j] += v;
      }
    }
    if (z != nullptr) {
      const T total = transposed_sum(p, lane);  // row i0 + lane / 4's
      const int i = i0 + lane / (kWarp / R);
      if (lane % (kWarp / R) == 0 && i < n) u[i] = total;
    }
  }
}

// Two sweeps or more, from x = 0 or (Warm; x0 and x0_bar then not null)
// from x0; Whole: A's upper part staged ("A whole"), else read by
// upper_pass ("upper streamed").
template <typename T, int G, bool Warm, bool Whole>
__global__ void __launch_bounds__(kThreads, 1)
pgs_backward_sweeps(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                    const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                    const T* __restrict__ x, const T* __restrict__ x_bar, T* __restrict__ a_bar, T* __restrict__ b_bar,
                    T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch, int n, int iterations,
                    const T* __restrict__ x0, T* __restrict__ x0_bar) {
  static_assert(Whole || G == kWarp, "upper_pass takes a whole warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long env = (long long)blockIdx.x * (blockDim.x / G) + group;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* abar_env = a_bar + e * n * n;
  const int its = iterations;  // 2 or more (pgs_backward_linearised runs 0 and 1)
  T* tri = reinterpret_cast<T*>(smem_raw + group * sweeps_env_bytes<T>(n, its, Whole));
  T* up = tri + triangle(n);                   // with Whole, A above the diagonal
  T* xv = up + (Whole ? triangle(n - 1) : 0);  // x before sweep s at xv + s n (x0 or 0 at s = 0)
  T* cv = xv + (its + 1) * n;                  // c of sweep t at cv + t n
  T* xbar = cv + its * n;                      // the adjoint of x after the sweep
  T* bs = xbar + n;
  T* los = bs + n;
  T* his = los + n;
  T* fs = his + n;
  T* es = fs + n;
  T* ds = es + n;
  T* us = ds + n;   // without Whole, each row's columns after it against the previous sweep's x
  T* lob = us + n;  // lo-bar, hi-bar and A-bar's diagonal, summed over the sweeps
  T* hib = lob + n;
  T* dg = hib + n;
  int* deps = reinterpret_cast<int*>(dg + n);
  const T* a_env = a + e * n * n;
  const int blocks = (n + G - 1) / G;
  const long long sweep = (long long)batch * n;  // xs's stride from one sweep to the next
  // group 0: the vectors, x before each sweep and after the last, and the
  // last block's rows; then a group a block of rows, issued two blocks
  // ahead (the first sweep visited waits for them)
  for (int j = lane; j < n; j += G) {
    const long long q = e * n + j;
    copy_async(bs + j, b + q);
    copy_async(los + j, lo + q);
    copy_async(his + j, hi + q);
    copy_async(deps + j, dep + j);
    copy_async(xbar + j, x_bar + q);
    if (Warm) {
      copy_async(xv + j, x0 + q);
    } else {
      xv[j] = T(0);
    }
    for (int t = 0; t < its; ++t) copy_async(xv + (t + 1) * n + j, sweep_x(xs, x, t, its, sweep) + q);
  }
  auto stage_block = [&](int k) {
    if (k < 0) return;
    const int r0 = k * G, r1 = min(n, r0 + G);
    stage_rows(tri, a_env, n, r0, r1, lane, G);
    if (Whole) stage_upper_rows(up, a_env, n, r0, r1, lane, G);
  };
  stage_block(blocks - 1);
  copy_commit();
  stage_block(blocks - 2);
  copy_commit();
  if (!Whole) {
    // the last sweep's sums after each row, while the triangle lands
    copy_wait<1>();
    __syncwarp();
    upper_pass<T>(a_env, n, nullptr, nullptr, xv + (its - 1) * n, us, lane);
  }
  for (int t = its - 1; t >= 0; --t) {
    const bool first = t == its - 1;  // the first sweep visited stores the sums over the sweeps, the others add
    const bool upper = Warm || t > 0;  // the sweep reads x before it (x = 0 before the first from 0)
    T* cs = cv + t * n;
    const T* xt = xv + (t + 1) * n;  // x after the sweep: what rows read before them
    const T* xp = xv + t * n;        // x before it: what rows read after them
    for (int k = blocks - 1; k >= 0; --k) {
      const int k0 = k * G;
      const int k1 = min(n, k0 + G);
      if (first) {
        copy_wait<1>();  // block k's rows have landed; block k - 1's may not have
        __syncwarp();
        stage_block(k - 2);
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
      if (upper) {
        if (Whole) {
          for (int j = k0 + 1; j < n; ++j) sum += j > rr ? up[upper_at(rr, j)] * xp[j] : T(0);
        } else {
          sum += us[rr];
        }
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
        lob[r] = first ? ml * g * s : lob[r] + ml * g * s;
        hib[r] = first ? mh * g * s : hib[r] + mh * g * s;
        dg[r] = first ? c * p : dg[r] + c * p;
      }
      __syncwarp();
    }
    if (upper) {
      // x-bar of x before the sweep (x0's at t = 0): the rows whose dep is
      // at or after them (each added by the lane that owns its column),
      // then the sum over i < j of c_i A_ij
      for (int j = lane; j < n; j += G) xbar[j] = T(0);
      for (int i = 0; i < n; ++i) {
        const int d = deps[i];
        if (d >= i && lane == d % G) xbar[d] += ds[i];
      }
      if (Whole) {
        for (int j0 = 0; j0 < n; j0 += G) {
          const int j = min(j0 + lane, n - 1);
          T v = T(0);
          for (int i = 0; i < min(n, j0 + G - 1); ++i) v += i < j ? cs[i] * up[upper_at(i, j)] : T(0);
          if (j0 + lane < n) xbar[j] += v;
        }
      } else {
        // and the next sweep's sums after each row (x before it: x = 0 before the first from 0)
        const bool next = t > 1 || (Warm && t == 1);
        upper_pass<T>(a_env, n, cs, xbar, next ? xv + (t - 1) * n : nullptr, us, lane);
      }
      __syncwarp();
    }
  }
  if (active) {
    // b-bar, lo-bar, hi-bar, x0-bar and A-bar, each written once
    for (int j = lane; j < n; j += G) {
      const long long q = e * n + j;
      T v = -cv[(its - 1) * n + j];
      for (int t = its - 2; t >= 0; --t) v -= cv[t * n + j];
      b_bar[q] = v;
      lo_bar[q] = lob[j];
      hi_bar[q] = hib[j];
      if (Warm) x0_bar[q] = xbar[j];
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      T* abar_row = abar_env + (long long)i * n;
      for (int j = lane; j < n; j += G) {
        T v = dg[i];
        if (j != i) {
          const int after = j < i ? 1 : 0;  // this sweep's x before the row, the previous sweep's after it
          v = cv[(its - 1) * n + i] * xv[(its - 1 + after) * n + j];
          for (int t = its - 2; t >= 0; --t) v += cv[t * n + i] * xv[(t + after) * n + j];
        }
        abar_row[j] = v;
      }
    }
  }
}
template <typename T, bool Warm = false>
__global__ void pgs_backward_per_warp(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                                      const T* __restrict__ hi, const int* __restrict__ dep, const T* __restrict__ xs,
                                      const T* __restrict__ x, const T* __restrict__ x_bar, T* __restrict__ a_bar,
                                      T* __restrict__ b_bar, T* __restrict__ lo_bar, T* __restrict__ hi_bar, int batch,
                                      int n, int iterations, const T* __restrict__ x0, T* __restrict__ x0_bar) {
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
    const long long sweep = (long long)batch * n;
    for (int j = lane; j < n; j += kWarp) {
      xt[j] = sweep_x(xs, x, t, iterations, sweep)[e * n + j];
      xp[j] = t > 0 ? xs[(t - 1) * sweep + e * n + j] : (Warm ? x0[e * n + j] : T(0));
    }
    __syncwarp();
    for (int i = n - 1; i >= 0; --i) {
      const T* a_row = a_env + (long long)i * n;
      // in the first sweep from x = 0, x_j = 0 for j > i: those columns add nothing
      const int cols = !Warm && t == 0 ? i : n;
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
        } else if (j < i || Warm || t > 0) {
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
  if (Warm && active) {
    __syncwarp();
    for (int j = lane; j < n; j += kWarp) x0_bar[e * n + j] = xbar[j];
  }
}

template <typename T, int G, bool Warm, bool Whole>
const void* sweeps_kernel() {
  return reinterpret_cast<const void*>(&pgs_backward_sweeps<T, G, Warm, Whole>);
}

// The backward's launch for n rows and `iterations` sweeps: one sweep (or
// none) "linearised"; more "linearised sweeps", "A whole" where it keeps
// at least the resident envs of "upper streamed"; "streaming" past the
// staged forms' limits.
template <typename T, bool Warm>
Plan backward_plan_uncached(int n, int iterations) {
  Plan p;
  const int lanes = n <= 16 ? 16 : kWarp;
  if (iterations <= 1) {
    if (linearised_fits<T>(n)) {
      p.fn = n <= 16 ? reinterpret_cast<const void*>(&pgs_backward_linearised<T, 16, Warm>)
                     : reinterpret_cast<const void*>(&pgs_backward_linearised<T, 32, Warm>);
      p.form = kLinearised;
      p.lanes = lanes;
      // n <= 16 needs under 2 KB an env: its blocks keep 8 envs, whole warps
      staged_shape(linearised_env_bytes<T>(n), kThreads / p.lanes, &p.envs, &p.smem);
      return p;
    }
  } else if (n >= 1) {
    const int most = kThreads / lanes;
    Occupancy streamed;
    const void* whole_fn = lanes == 16 ? sweeps_kernel<T, 16, Warm, true>() : sweeps_kernel<T, 32, Warm, true>();
    const Occupancy whole = most_resident(whole_fn, sweeps_env_bytes<T>(n, iterations, true), most, lanes);
    if (lanes == kWarp) {
      streamed = most_resident(sweeps_kernel<T, 32, Warm, false>(), sweeps_env_bytes<T>(n, iterations, false), most,
                               lanes);
    }
    if (whole.envs > 0 && whole.per_sm >= streamed.per_sm) {
      p = {whole_fn, kSweepsWhole, lanes, whole.envs, whole.smem};
      return p;
    }
    if (streamed.envs > 0) {
      p = {sweeps_kernel<T, 32, Warm, false>(), kSweeps, lanes, streamed.envs, streamed.smem};
      return p;
    }
  }
  if (n >= 1) {
    p.fn = reinterpret_cast<const void*>(&pgs_backward_per_warp<T, Warm>);
    p.form = kStreaming;
    p.lanes = kWarp;
    streaming_shape(3LL * n * sizeof(T), &p.envs, &p.smem);  // x after both sweeps, x-bar
  }
  return p;
}

// backward_plan_uncached, kept for each (n, iterations) past one sweep: its
// occupancy queries (and the shared memory opt-ins they need) run once.
template <typename T, bool Warm = false>
Plan backward_plan(int n, int iterations = 1) {
  if (iterations <= 1) return backward_plan_uncached<T, Warm>(n, iterations);
  static std::mutex mutex;
  static std::map<std::pair<int, int>, Plan> plans;
  const std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_pair(n, iterations);
  auto it = plans.find(key);
  if (it == plans.end()) it = plans.emplace(key, backward_plan_uncached<T, Warm>(n, iterations)).first;
  return it->second;
}

// x0 and x0_bar (B, n) with Warm (a warm start and its adjoint), else null.
template <typename T, bool Warm = false>
int backward(const void* a, const void* b, const void* lo, const void* hi, const void* dep, const void* xs,
             const void* x, const void* x_bar, void* a_bar, void* b_bar, void* lo_bar, void* hi_bar, int batch,
             int n, int iterations, void* stream, const void* x0 = nullptr, void* x0_bar = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = backward_plan<T, Warm>(n, iterations);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(p.fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((batch + p.envs - 1) / p.envs);
  const int threads = p.envs * p.lanes;
  // every backward kernel takes the same arguments
  const auto kernel = reinterpret_cast<decltype(&pgs_backward_per_warp<T, Warm>)>(const_cast<void*>(p.fn));
  kernel<<<blocks, threads, p.smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<const int*>(dep), static_cast<const T*>(xs), static_cast<const T*>(x), static_cast<const T*>(x_bar),
      static_cast<T*>(a_bar), static_cast<T*>(b_bar), static_cast<T*>(lo_bar), static_cast<T*>(hi_bar), batch, n,
      iterations, static_cast<const T*>(x0), static_cast<T*>(x0_bar));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1's forward mode: the Jacobian-vector product of the sweeps above, the
// counterpart of jax.jvp through tds_tpu/contact/mlcp.py::solve_pgs (the
// Pallas kernel has no JVP of its own: the JAX package differentiates the
// unrolled sweep, jax.jacfwd through contact included). Given tangents
// (A', b', lo', hi') of the operands it computes x and its tangent x'
// together, sweep by sweep, so that no sweep is saved (unlike the
// backward, which reads x after each sweep as the forward saved it).
// Per row, u = (b_i - delta_i) / A_ii and
//   u' = (b'_i - delta'_i - u A'_ii) / A_ii,  delta'_i = sum_{j != i} A'_ij x_j + A_ij x'_j,
// s = max(x_dep, 0), s' = x'_dep max'(x_dep); l = lo_i s, l' = lo'_i s +
// lo_i s', h likewise; x_i = min(max(u, l), h) and x'_i = mp u' + ml l' +
// mh h' with clip_factors' factors: jax.jvp's rule at ties, half to each
// side of a tie of lax.max or lax.min.
//
// What bounds it on an H100: memory, as the forward. Each env reads A's
// and A''s lower triangles (all of both after the first sweep) and b, lo,
// hi and their tangents, and writes x and x'; per row and column about 6
// flops against the forward's 2.
//
// "Linearised", the dual of the backward's design: once a sweep's x is
// known, every u, s and clip factor is fixed, so x' is linear in the
// tangents. Per sweep t, (1) the primal chain over A alone, as the
// forward's, each lane keeping u and x_dep of its row; (2) off the chain,
// c_i = sum_{j < i} A'_ij x_j + sum_{j > i} A'_ij x_j(t - 1) + u_i A'_ii, a
// mat-vec of A' against vectors now known, so A' is read once a sweep
// from global memory and never held through a chain; (3) the tangent
// chain over A, x'_i = mp (b'_i - c_i - sum_{j != i} A_ij x'_j) / A_ii +
// ml l'_i + mh h'_i with l' = lo'_i s + lo_i s', s' = x'_dep max'(x_dep):
// one shuffle and one FMA a row, as the primal's. (The first design carried
// A' through the chain beside A: two sums a row on the chain, A' in
// registers for n <= 32 (8 B of stack at n = 12, 280 B in the float64
// N = 32 warm instance) and both triangles staged for n > 32, 4 warps an
// SM at n = 105: 97.6 us there at B = 1024, f32 on an H100 80GB HBM3.)
//
// Its three forms are the forward's:
// - n <= 32, "row per lane" (pgs_jvp_sweeps in pgs_sweep.cuh): lane i
//   holds row i of A in registers and the whole x; A''s row stays in
//   global memory. Every n runs the padded instance of the next N of 8,
//   12, 16, 24, 32 (identity rows with zero tangents keep x = x' = 0 past
//   n).
// - n > 32, "blocked": one warp per env, A's lower triangle and the
//   vectors staged in shared memory with cp.async as the forward stages
//   them (jvp_env_bytes: 26,048 B an env at n = 105 in f32), the rows in
//   blocks of 32. Per block: each lane sums its row over the columns
//   outside the block's triangle against x and x' (the columns after the
//   row through row_sums, when the sweep reads them), the primal chain,
//   c through row_sums over A''s rows (coalesced, 16 rows at a time), then
//   the tangent chain. The sums run in double in both types, as the
//   blocked forward's. (Fetching the next block's rows into L2 ahead of
//   row_sums made it slower: 57.4 against 54.0 us at n = 48, B = 4096, f32,
//   128.6 against 119.0 from x0 at n = 105, B = 1024, on an H100 80GB HBM3.)
// - past a block's 227 KB (n > 331 in f32, > 232 in f64), "streaming": one
//   warp per env streams A's and A''s rows from global memory, x and x' in
//   shared memory, each row's sums a butterfly over the warp. Its A'
//   products already sit off the chain (the butterfly sums them with A's,
//   in the same shuffles), so the split would save it nothing.
// Each form has Warm instances, which start x from x0 and x' from its
// tangent x0' (B, n) and take every column from the first sweep on.

template <typename T, int N, int G, bool Warm = false>
__global__ void __launch_bounds__(kThreads, JvpBlocks<T, N>::kMin)
pgs_jvp_rows(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo, const T* __restrict__ hi,
             const T* __restrict__ a_dot, const T* __restrict__ b_dot, const T* __restrict__ lo_dot,
             const T* __restrict__ hi_dot, const int* __restrict__ dep, T* __restrict__ x_out,
             T* __restrict__ x_dot_out, int batch, int n, int iterations, const T* __restrict__ x0,
             const T* __restrict__ x0_dot) {
  const int lane = threadIdx.x % G;
  const long long env = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  const int i = lane < N ? lane : 0;              // lanes past N carry row 0, unused
  // a padding row (i >= n) reads row 0 and keeps none of it
  const bool real = i < n;
  const int r = real ? i : 0;
  LaneRow<T, N> row;
  const long long q = (e * n + r) * n;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T v = j < n ? a[q + j] : T(0);
    row.a[j] = real ? v : (j == i ? T(1) : T(0));
  }
  const long long k = e * n + r;
  row.b = real ? b[k] : T(0);
  row.lo = real ? lo[k] : T(0);
  row.hi = real ? hi[k] : T(0);
  row.dep = real ? dep[r] : -1;
  const LaneTangent<T> tangent{a_dot + q, real ? n : 0, real ? b_dot[k] : T(0), real ? lo_dot[k] : T(0),
                               real ? hi_dot[k] : T(0)};
  T x[N];
  T mine, mined;
  T start_dep = T(0), start_dep_dot = T(0);  // x0 and x0' of the row's dependency
  UpperSums upper = {0.0, 0.0, 0.0};          // the row's columns after it: A x0, A' x0, A x0'
  if (Warm) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T v = j < n ? x0[e * n + j] : T(0);
      x[j] = v;
      if (j > lane && j < tangent.cols) {
        upper.x += double(row.a[j]) * double(v);
        upper.a_dot_x += double(tangent.a[j]) * double(v);
        upper.x_dot += double(row.a[j]) * double(x0_dot[e * n + j]);
      }
    }
    mine = real ? x0[k] : T(0);
    mined = real ? x0_dot[k] : T(0);
    if (row.dep >= 0) {
      start_dep = x0[e * n + row.dep];
      start_dep_dot = x0_dot[e * n + row.dep];
    }
  }
  pgs_jvp_sweeps<T, N, G, Warm>(x, row, tangent, iterations, mine, mined, start_dep, start_dep_dot, upper);
  if (active && lane < n) {
    x_out[e * n + lane] = mine;
    x_dot_out[e * n + lane] = mined;
  }
}

// Bytes of shared memory of one env of the blocked JVP: A's triangle, x,
// x', b, b', lo, lo', hi, hi' and dep, rounded up to 16.
template <typename T>
__host__ __device__ __forceinline__ long long jvp_env_bytes(int n) {
  const long long bytes = ((long long)triangle(n) + 8LL * n) * sizeof(T) + 4LL * n;
  return (bytes + 15) / 16 * 16;
}

template <typename T>
bool jvp_blocked_fits(int n) {
  return n > 32 && jvp_env_bytes<T>(n) <= kSmemMax;
}

template <typename T, bool Warm = false>
__global__ void __launch_bounds__(kThreads)
pgs_jvp_blocked(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo, const T* __restrict__ hi,
                const T* __restrict__ a_dot, const T* __restrict__ b_dot, const T* __restrict__ lo_dot,
                const T* __restrict__ hi_dot, const int* __restrict__ dep, T* __restrict__ x_out,
                T* __restrict__ x_dot_out, int batch, int n, int iterations, const T* __restrict__ x0,
                const T* __restrict__ x0_dot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* tri = reinterpret_cast<T*>(smem_raw + warp * jvp_env_bytes<T>(n));
  T* x = tri + triangle(n);
  T* xd = x + n;
  T* bs = xd + n;
  T* bds = bs + n;
  T* los = bds + n;
  T* lods = los + n;
  T* his = lods + n;
  T* hids = his + n;
  int* deps = reinterpret_cast<int*>(hids + n);
  const T* a_env = a + e * n * n;
  const T* ad_env = a_dot + e * n * n;
  const int blocks = (n + kWarp - 1) / kWarp;
  for (int j = lane; j < n; j += kWarp) {
    const long long k = e * n + j;
    copy_async(bs + j, b + k);
    copy_async(bds + j, b_dot + k);
    copy_async(los + j, lo + k);
    copy_async(lods + j, lo_dot + k);
    copy_async(his + j, hi + k);
    copy_async(hids + j, hi_dot + k);
    copy_async(deps + j, dep + j);
    x[j] = Warm ? x0[k] : T(0);
    xd[j] = Warm ? x0_dot[k] : T(0);
  }
  stage_rows(tri, a_env, n, 0, min(n, kWarp), lane, kWarp);
  copy_commit();
  stage_rows(tri, a_env, n, kWarp, min(n, 2 * kWarp), lane, kWarp);
  copy_commit();
  const int sweeps = iterations > 0 ? iterations : 1;
  for (int it = 0; it < sweeps; ++it) {
    const bool upper = Warm || it > 0;  // the sweep reads the columns after each row
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
      // A's columns outside the block's triangle against x and x': this
      // sweep's before the block, the previous sweep's after the row
      double sum = 0.0, sumd = 0.0;
#pragma unroll 4
      for (int j = 0; j < k0; ++j) {
        sum += double(trow[j]) * double(x[j]);
        sumd += double(trow[j]) * double(xd[j]);
      }
      if (upper) {
        double up[2];
        row_sums<2, 8>(a_env, n, k0, k0, n,
                        [&](int q, int r2, int j) { return j > r2 ? (q == 0 ? x[j] : xd[j]) : T(0); }, up, lane);
        sum += up[0];
        sumd += up[1];
      }
      const double bi = bs[rr];
      const T loi = los[rr], hii = his[rr];
      const double inv = 1.0 / double(trow[rr]);
      const int d = deps[rr];
      // (1) the primal chain, as the blocked forward's
      T xdep = d >= 0 ? x[d] : T(0);  // x_dep now: replaced below when dep is an earlier row of the block
      T mine = T(0), u = T(0), dep_at = T(0);
      const int rows = min(kWarp, n - k0);
#pragma unroll 4
      for (int m = 0; m < rows; ++m) {
        const T um = T((bi - sum) * inv);
        const T s = d >= 0 ? (xdep > T(0) ? xdep : T(0)) : T(1);
        const T l = loi * s;
        const T h = hii * s;
        T xi = um < l ? l : um;
        xi = xi > h ? h : xi;
        const T xm = __shfl_sync(0xffffffffu, xi, m);
        u = lane == m ? um : u;
        dep_at = lane == m ? xdep : dep_at;
        mine = lane == m ? xm : mine;
        xdep = d == k0 + m ? xm : xdep;
        sum += double(lane > m ? trow[k0 + m] : T(0)) * double(xm);
      }
      // (2) c of the block's rows from A''s rows: column j meets this
      // sweep's x before the row (the block's own from the lanes), u at the
      // row, the previous sweep's after it (none in the first sweep from 0)
      const T before = x[k0 + lane < n ? k0 + lane : n - 1];  // the block's x of the previous sweep, lane by lane
      double c[1];
      row_sums<1, 16>(ad_env, n, k0, 0, upper ? n : min(n, k0 + kWarp),
                      [&](int, int r2, int j) {
                        if (j < k0 || j >= k0 + kWarp) return x[j];
                        return j < r2 ? mine : (j == r2 ? u : before);
                      },
                      c, lane);
      const T s = d >= 0 ? (dep_at > T(0) ? dep_at : T(0)) : T(1);
      T mp, ml, mh;
      clip_factors(u, loi * s, hii * s, mp, ml, mh);
      const double k1 = double(mp) * inv;
      const double bc = double(bds[rr]) - c[0];
      const double k0c = double((ml * lods[rr] + mh * hids[rr]) * s);
      const double k2 = d >= 0 ? double((ml * loi + mh * hii) * relu_slope(dep_at)) : 0.0;
      // (3) the tangent chain
      T xddep = d >= 0 ? xd[d] : T(0);
      T mined = T(0);
#pragma unroll 4
      for (int m = 0; m < rows; ++m) {
        const T xdi = T(k1 * (bc - sumd) + (k0c + k2 * double(xddep)));
        const T xdm = __shfl_sync(0xffffffffu, xdi, m);
        mined = lane == m ? xdm : mined;
        xddep = d == k0 + m ? xdm : xddep;
        sumd += double(lane > m ? trow[k0 + m] : T(0)) * double(xdm);
      }
      __syncwarp();  // every lane has read the x and x' it needs of this block
      if (row) {
        x[r] = mine;
        xd[r] = mined;
      }
      __syncwarp();
    }
  }
  if (active) {
    for (int j = lane; j < n; j += kWarp) {
      x_out[e * n + j] = x[j];
      x_dot_out[e * n + j] = xd[j];
    }
  }
}

template <typename T, bool Warm = false>
__global__ void pgs_jvp_per_warp(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ lo,
                                 const T* __restrict__ hi, const T* __restrict__ a_dot, const T* __restrict__ b_dot,
                                 const T* __restrict__ lo_dot, const T* __restrict__ hi_dot, const int* __restrict__ dep,
                                 T* __restrict__ x_out, T* __restrict__ x_dot_out, int batch, int n, int iterations,
                                 const T* __restrict__ x0, const T* __restrict__ x0_dot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long env = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  T* x = reinterpret_cast<T*>(smem_raw) + (long long)warp * 2 * n;
  T* xd = x + n;
  for (int j = lane; j < n; j += kWarp) {
    x[j] = Warm ? x0[e * n + j] : T(0);
    xd[j] = Warm ? x0_dot[e * n + j] : T(0);
  }
  __syncwarp();
  const T* a_env = a + e * n * n;
  const T* ad_env = a_dot + e * n * n;
  for (int it = 0; it < iterations; ++it) {
    for (int i = 0; i < n; ++i) {
      const T* a_row = a_env + (long long)i * n;
      const T* ad_row = ad_env + (long long)i * n;
      // in the first sweep from x = 0, x_j = x'_j = 0 for j > i
      const int cols = !Warm && it == 0 ? i : n;
      using Acc = double;
      Acc partial = Acc(0), partiald = Acc(0);
      for (int j = lane; j < cols; j += kWarp) {
        if (j != i) {
          partial += Acc(a_row[j]) * Acc(x[j]);
          partiald += Acc(ad_row[j]) * Acc(x[j]) + Acc(a_row[j]) * Acc(xd[j]);
        }
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset /= 2) {
        partial += __shfl_xor_sync(0xffffffffu, partial, offset);
        partiald += __shfl_xor_sync(0xffffffffu, partiald, offset);
      }
      const long long k = e * n + i;
      const Acc aii = a_row[i], aiid = ad_row[i];
      const Acc ua = (Acc(b[k]) - partial) / aii;
      const T u = T(ua);
      const T ud = T((Acc(b_dot[k]) - partiald - ua * aiid) / aii);
      const int d = dep[i];
      const T s = d >= 0 ? (x[d] > T(0) ? x[d] : T(0)) : T(1);
      const T sd = d >= 0 ? xd[d] * relu_slope(x[d]) : T(0);
      const T l = lo[k] * s, h = hi[k] * s;
      const T ld = lo_dot[k] * s + lo[k] * sd, hd = hi_dot[k] * s + hi[k] * sd;
      T xi = u < l ? l : u;
      xi = xi > h ? h : xi;
      T mp, ml, mh;
      clip_factors(u, l, h, mp, ml, mh);
      const T xdi = mp * ud + ml * ld + mh * hd;
      __syncwarp();  // every lane has read x[d] before it changes
      if (lane == i % kWarp) {
        x[i] = xi;
        xd[i] = xdi;
      }
      __syncwarp();
    }
  }
  if (active) {
    for (int j = lane; j < n; j += kWarp) {
      x_out[e * n + j] = x[j];
      x_dot_out[e * n + j] = xd[j];
    }
  }
}

template <typename T, int N, bool Warm>
const void* jvp_row_kernel() {
  return reinterpret_cast<const void*>(&pgs_jvp_rows<T, N, Lanes<N>::G, Warm>);
}

template <typename T, bool Warm = false>
Plan jvp_plan(int n) {
  Plan p;
  const int rows = instance_rows(n);
  if (rows != 0) {
    switch (rows) {
      case 8: p.fn = jvp_row_kernel<T, 8, Warm>(); break;
      case 12: p.fn = jvp_row_kernel<T, 12, Warm>(); break;
      case 16: p.fn = jvp_row_kernel<T, 16, Warm>(); break;
      case 24: p.fn = jvp_row_kernel<T, 24, Warm>(); break;
      default: p.fn = jvp_row_kernel<T, 32, Warm>(); break;
    }
    p.form = kRowPerLane;
    p.lanes = rows <= 16 ? 16 : 32;
    p.envs = kThreads / p.lanes;
  } else if (jvp_blocked_fits<T>(n)) {
    p.fn = reinterpret_cast<const void*>(&pgs_jvp_blocked<T, Warm>);
    p.form = kBlocked;
    p.lanes = kWarp;
    staged_shape(jvp_env_bytes<T>(n), kThreads / kWarp, &p.envs, &p.smem);
  } else if (n > 32) {
    p.fn = reinterpret_cast<const void*>(&pgs_jvp_per_warp<T, Warm>);
    p.form = kStreaming;
    p.lanes = kWarp;
    streaming_shape(2LL * n * sizeof(T), &p.envs, &p.smem);  // x and x'
  }
  return p;
}

// x0 and x0_dot (B, n) with Warm (a warm start and its tangent), else null.
template <typename T, bool Warm = false>
int jvp(const void* a, const void* b, const void* lo, const void* hi, const void* a_dot, const void* b_dot,
        const void* lo_dot, const void* hi_dot, const void* dep, void* x, void* x_dot, int batch, int n, int iterations,
        void* stream, const void* x0 = nullptr, const void* x0_dot = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = jvp_plan<T, Warm>(n);
  if (p.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(p.fn, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((batch + p.envs - 1) / p.envs);
  const int threads = p.envs * p.lanes;
  const T* args[8] = {static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(lo),
                      static_cast<const T*>(hi), static_cast<const T*>(a_dot), static_cast<const T*>(b_dot),
                      static_cast<const T*>(lo_dot), static_cast<const T*>(hi_dot)};
  const int* dep_t = static_cast<const int*>(dep);
  T* x_t = static_cast<T*>(x);
  T* xd_t = static_cast<T*>(x_dot);
  const T* x0_t = static_cast<const T*>(x0);
  const T* x0d_t = static_cast<const T*>(x0_dot);
#define TDS_JVP_ARGS args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7], dep_t, x_t, xd_t, batch, n, \
    iterations, x0_t, x0d_t
  if (p.form == kBlocked) {
    pgs_jvp_blocked<T, Warm><<<blocks, threads, p.smem, s>>>(TDS_JVP_ARGS);
  } else if (p.form == kStreaming) {
    pgs_jvp_per_warp<T, Warm><<<blocks, threads, p.smem, s>>>(TDS_JVP_ARGS);
  } else {
    switch (instance_rows(n)) {
      case 8: pgs_jvp_rows<T, 8, Lanes<8>::G, Warm><<<blocks, threads, 0, s>>>(TDS_JVP_ARGS); break;
      case 12: pgs_jvp_rows<T, 12, Lanes<12>::G, Warm><<<blocks, threads, 0, s>>>(TDS_JVP_ARGS); break;
      case 16: pgs_jvp_rows<T, 16, Lanes<16>::G, Warm><<<blocks, threads, 0, s>>>(TDS_JVP_ARGS); break;
      case 24: pgs_jvp_rows<T, 24, Lanes<24>::G, Warm><<<blocks, threads, 0, s>>>(TDS_JVP_ARGS); break;
      default: pgs_jvp_rows<T, 32, Lanes<32>::G, Warm><<<blocks, threads, 0, s>>>(TDS_JVP_ARGS); break;
    }
  }
#undef TDS_JVP_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The plan of the instance a launch takes (see
// tds_pgs_instance_launch_shape below).
template <typename T>
Plan instance_plan(int n, int which, bool warm, int iterations) {
  if (which == 2) return warm ? jvp_plan<T, true>(n) : jvp_plan<T>(n);
  if (which == 1) return warm ? backward_plan<T, true>(n, iterations) : backward_plan<T>(n, iterations);
  const bool save = which == 3 && iterations > 1;
  if (warm) return save ? forward_plan<T, true, true, true>(n) : forward_plan<T, true>(n);
  if (iterations <= 1) return forward_plan<T>(n);
  return save ? forward_plan<T, false, true, true>(n) : forward_plan<T, false, true>(n);
}

// The launch-shape query behind tds_pgs_instance_launch_shape below.
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
  return launch<float>(a, b, lo, hi, dep, nullptr, x, nullptr, batch, n, iterations, stream);
}

extern "C" int tds_pgs_solve_f64(const void* a, const void* b, const void* lo,
                                 const void* hi, const void* dep, void* x,
                                 int batch, int n, int iterations,
                                 void* stream) {
  return launch<double>(a, b, lo, hi, dep, nullptr, x, nullptr, batch, n, iterations, stream);
}

// K1 from a warm start: tds_pgs_solve_*'s operands and x0 (B, n), the x
// the first sweep starts from.
extern "C" int tds_pgs_solve_warm_f32(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                      const void* x0, void* x, int batch, int n, int iterations, void* stream) {
  return launch<float>(a, b, lo, hi, dep, x0, x, nullptr, batch, n, iterations, stream);
}

extern "C" int tds_pgs_solve_warm_f64(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                      const void* x0, void* x, int batch, int n, int iterations, void* stream) {
  return launch<double>(a, b, lo, hi, dep, x0, x, nullptr, batch, n, iterations, stream);
}

// K1 saving its sweeps for the backward: tds_pgs_solve_*'s operands, x0
// (B, n) or null (the zero start), x (B, n) and xs (iterations - 1, B, n),
// x after each sweep but the last, written by the same launch (the saving
// instances of the forward's forms: the same sweeps as without xs).
extern "C" int tds_pgs_solve_saving_f32(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                        const void* x0, void* x, void* xs, int batch, int n, int iterations,
                                        void* stream) {
  return launch<float>(a, b, lo, hi, dep, x0, x, xs, batch, n, iterations, stream);
}

extern "C" int tds_pgs_solve_saving_f64(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                        const void* x0, void* x, void* xs, int batch, int n, int iterations,
                                        void* stream) {
  return launch<double>(a, b, lo, hi, dep, x0, x, xs, batch, n, iterations, stream);
}

// K1's backward: a, b, lo, hi (the forward's operands), dep, xs
// (iterations - 1, B, n; null for at most one sweep) and x (B, n): x after
// each sweep, as tds_pgs_solve_saving_* writes them, and x_bar (B, n), all
// contiguous on the current device; writes a_bar (B, n, n) whole and
// b_bar, lo_bar, hi_bar (B, n). Launches on `stream` without synchronising
// and returns cudaGetLastError().
extern "C" int tds_pgs_backward_f32(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                    const void* xs, const void* x, const void* x_bar, void* a_bar, void* b_bar,
                                    void* lo_bar, void* hi_bar, int batch, int n, int iterations, void* stream) {
  return backward<float>(a, b, lo, hi, dep, xs, x, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations, stream);
}

extern "C" int tds_pgs_backward_f64(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                    const void* xs, const void* x, const void* x_bar, void* a_bar, void* b_bar,
                                    void* lo_bar, void* hi_bar, int batch, int n, int iterations, void* stream) {
  return backward<double>(a, b, lo, hi, dep, xs, x, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations, stream);
}

// K1's backward from a warm start: tds_pgs_backward_*'s arguments, the
// sweeps of a forward that started from x0 (B, n), and x0_bar (B, n),
// written whole: the adjoint of x0.
extern "C" int tds_pgs_backward_warm_f32(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                         const void* xs, const void* x, const void* x_bar, const void* x0, void* a_bar,
                                         void* b_bar, void* lo_bar, void* hi_bar, void* x0_bar, int batch, int n,
                                         int iterations, void* stream) {
  return backward<float, true>(a, b, lo, hi, dep, xs, x, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations,
                               stream, x0, x0_bar);
}

extern "C" int tds_pgs_backward_warm_f64(const void* a, const void* b, const void* lo, const void* hi, const void* dep,
                                         const void* xs, const void* x, const void* x_bar, const void* x0, void* a_bar,
                                         void* b_bar, void* lo_bar, void* hi_bar, void* x0_bar, int batch, int n,
                                         int iterations, void* stream) {
  return backward<double, true>(a, b, lo, hi, dep, xs, x, x_bar, a_bar, b_bar, lo_bar, hi_bar, batch, n, iterations,
                                stream, x0, x0_bar);
}

// K1's forward mode: a, b, lo, hi (B, n, n) / (B, n), their tangents
// a_dot, b_dot, lo_dot, hi_dot of the same shapes, and dep, all contiguous
// on the current device; writes x and its tangent x_dot (B, n). Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int tds_pgs_jvp_f32(const void* a, const void* b, const void* lo, const void* hi, const void* a_dot,
                               const void* b_dot, const void* lo_dot, const void* hi_dot, const void* dep, void* x,
                               void* x_dot, int batch, int n, int iterations, void* stream) {
  return jvp<float>(a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, x, x_dot, batch, n, iterations, stream);
}

extern "C" int tds_pgs_jvp_f64(const void* a, const void* b, const void* lo, const void* hi, const void* a_dot,
                               const void* b_dot, const void* lo_dot, const void* hi_dot, const void* dep, void* x,
                               void* x_dot, int batch, int n, int iterations, void* stream) {
  return jvp<double>(a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, x, x_dot, batch, n, iterations, stream);
}

// K1's forward mode from a warm start: the operands with x0 (B, n) after
// hi, their tangents with x0_dot after hi_dot (x0 and x0_dot: the start of
// x and of its tangent), then tds_pgs_jvp_*'s other arguments.
extern "C" int tds_pgs_jvp_warm_f32(const void* a, const void* b, const void* lo, const void* hi, const void* x0,
                                    const void* a_dot, const void* b_dot, const void* lo_dot, const void* hi_dot,
                                    const void* x0_dot, const void* dep, void* x, void* x_dot, int batch, int n,
                                    int iterations, void* stream) {
  return jvp<float, true>(a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, x, x_dot, batch, n, iterations, stream, x0,
                          x0_dot);
}

extern "C" int tds_pgs_jvp_warm_f64(const void* a, const void* b, const void* lo, const void* hi, const void* x0,
                                    const void* a_dot, const void* b_dot, const void* lo_dot, const void* hi_dot,
                                    const void* x0_dot, const void* dep, void* x, void* x_dot, int batch, int n,
                                    int iterations, void* stream) {
  return jvp<double, true>(a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, x, x_dot, batch, n, iterations, stream, x0,
                           x0_dot);
}

// The launch shape of the instance that runs for n rows in float32
// (f64 = 0) or float64 (f64 = 1), of the forward (which = 0), the backward
// (1), the forward mode (2) or the saving forward (3: the forward that
// stores its sweeps for the backward, past one sweep), from a warm start
// (warm = 1) or from x = 0, at `iterations` sweeps (the forward from x = 0
// has instances for at most one sweep and for more), on the current device: out[0] lanes per env,
// out[1] envs per block, out[2] threads per block, out[3] shared memory per
// block (bytes, static and dynamic), out[4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] registers per
// thread and out[6] local memory per thread (bytes; stack frame and
// spills), both from cudaFuncGetAttributes. Returns a cudaError_t.
extern "C" int tds_pgs_instance_launch_shape(int f64, int n, int which, int warm, int iterations, int* out) {
  return launch_shape(f64 ? instance_plan<double>(n, which, warm, iterations)
                          : instance_plan<float>(n, which, warm, iterations), out);
}

// The form of the instance tds_pgs_instance_launch_shape describes: 0 row
// per lane, 1 blocked, 2 streaming, 3 linearised, 4 linearised sweeps with
// A's upper part streamed from L2, 5 with A whole in shared memory (the
// backward past one sweep); -1 for no kernel.
extern "C" int tds_pgs_instance_form(int f64, int n, int which, int warm, int iterations) {
  return f64 ? instance_plan<double>(n, which, warm, iterations).form
             : instance_plan<float>(n, which, warm, iterations).form;
}
