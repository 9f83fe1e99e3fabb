// The order-free histogram arithmetic shared by K1 (hist.cu, both modes) and
// K3 (hist_nat.cu).
//
// Fixed point.  The grower picks one power-of-two shift per tree for g and
// one for h (engine/hist.py::fixed_point_shift): s = 62 - k - e for
// N <= 2^k rows and max|x| < 2^e, so N * max|x| * 2^s <= 2^62.  Every row
// adds q = rint(x * 2^s) (an exact power-of-two scaling, then one
// rounding, __float2ll_rn; |q| <= 2^(62-k)) to an int64 cell, and 1 to an
// int32 count.
//
// Why the sums are order-free: integer adds are exact and associative, so
// a cell's sum is the same in any order.  Any thread may add any row with
// a shared-memory atomic, the blocks' sums meet in a global int64
// accumulator with atomics, and two launches, K1 and K3, and the plain
// PyTorch version all give the same integers.  No cell can overflow:
// |sum| <= N * max|q| <= 2^62.  Each cell is converted once, int64 -> fp32
// rounded to nearest, then scaled by 2^-s (exact).
//
// Quantisation error: at most 2^-(s+1) per row, so count * 2^-(s+1) per
// cell; it is nonzero only for values below 2^-s (at 10M rows, 2^-37 of
// the largest weight or less).  A non-finite g or h is refused where the
// shift is chosen (hist.py), before any kernel runs.
//
// A block keeps its private cells in shared memory, 20 B each: int64 g and
// int64 h (two's complement), each as a low and a high 32-bit word, and an
// int32 count, in five separate word planes (Cells), so a warp's adds
// spread over all 32 banks.  A (row, feature) pair costs three 32-bit
// shared atomics (the low words of g and h, the count) and one more for
// each of g and h whose high word changes.  What bounds the kernels is
// these atomics and the latency of staging rows (hist.cu, hist_nat.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define STAGE_ROWS 512
#define HIST_THREADS 1024

typedef unsigned long long u64;

// 2^e as a float, exact for -126 <= e <= 127 (the shift stays inside).
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((127 + e) << 23);
}

// rint(x * 2^s), the fixed-point value of one weight; `scale` is 2^s.
__device__ __forceinline__ long long quantize(float x, float scale) {
  return __float2ll_rn(x * scale);
}

// A block's cells: five planes of n words each.
struct Cells {
  unsigned *g_lo, *g_hi, *h_lo, *h_hi;
  int* c;
};

__device__ __forceinline__ Cells carve_cells(void* smem, int n) {
  unsigned* w = static_cast<unsigned*>(smem);
  return {w, w + n, w + 2 * n, w + 3 * n, reinterpret_cast<int*>(w + 4 * n)};
}

// The high-word add of one order-free add of a 64-bit value v to the cell
// (lo, hi), given the low word's value `old` before v's low word was added:
// on the H100 a 64-bit atomicAdd on shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64), a 32-bit one to a native
// ATOMS.ADD, so a cell is two words.  `old` tells whether this add wrapped
// the low word; the carry and v's high word go to the high word.  Every
// wrap is counted by the add that caused it, so the pair holds the exact
// sum mod 2^64 in any order.  The high add is skipped when they sum to 0
// (mod 2^32), as for most values below 2^32 in magnitude.
__device__ __forceinline__ void add_hi(unsigned* hi_w, long long v,
                                       unsigned old) {
  const unsigned lo = (unsigned)v;
  const unsigned hi =
      (unsigned)((u64)v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(hi_w, hi);
}

// One row's weights into cell `i`: the two low-word adds and the count go
// out back to back, then the high words.
__device__ __forceinline__ void add_row(const Cells& s, int i, long long qg,
                                        long long qh) {
  const unsigned og = atomicAdd(s.g_lo + i, (unsigned)qg);
  const unsigned oh = atomicAdd(s.h_lo + i, (unsigned)qh);
  atomicAdd(s.c + i, 1);
  add_hi(s.g_hi + i, qg, og);
  add_hi(s.h_hi + i, qh, oh);
}

// Zero a block's n cells.
__device__ __forceinline__ void zero_cells(const Cells& s, int n) {
  for (int i = threadIdx.x; i < 5 * n; i += blockDim.x) s.g_lo[i] = 0u;
}

// Add a block's nonzero cells to the global (P, 3, F, B) int64 accumulator
// and zero them.  dst(cell) is the cell's g entry; h and the count lie
// `plane` entries further on.
template <class Dst>
__device__ __forceinline__ void flush_cells(const Cells& s, int n,
                                            size_t plane, Dst dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = s.c[i];
    if (c == 0) continue;  // a cell no row reached is all zero (padding too)
    u64* d = dst(i);
    const u64 g = ((u64)s.g_hi[i] << 32) | s.g_lo[i];
    const u64 h = ((u64)s.h_hi[i] << 32) | s.h_lo[i];
    if (g) atomicAdd(d, g);
    if (h) atomicAdd(d + plane, h);
    atomicAdd(d + 2 * plane, (u64)c);
    s.g_lo[i] = s.g_hi[i] = s.h_lo[i] = s.h_hi[i] = 0u;
    s.c[i] = 0;
  }
}

// (P, 3, F, B) int64 sums -> f32: each cell rounded once to fp32, then g and
// h scaled by 2^-s.
__global__ void hist_out_kernel(const long long* __restrict__ acc,
                                const int* __restrict__ shift,
                                float* __restrict__ out, long long total,
                                long long fb) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int plane = (int)((e / fb) % 3);
  const float v = __ll2float_rn(acc[e]);
  out[e] = plane < 2 ? v * pow2f(-shift[plane]) : v;
}

static inline int launch_out(const void* acc, const void* shift, void* out,
                             long long total, long long fb, cudaStream_t st) {
  hist_out_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const long long*>(acc), static_cast<const int*>(shift),
      static_cast<float*>(out), total, fb);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory one block may take, and the SM count.
static inline cudaError_t device_limits(int* smem_optin, int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// n split into balanced chunks of at most cap: the chunk size.
static inline int balanced(int n, int cap) {
  const int k = (n + cap - 1) / cap;
  return (n + k - 1) / k;
}
