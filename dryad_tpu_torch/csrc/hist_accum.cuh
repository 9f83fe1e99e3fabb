// The order-free histogram arithmetic shared by K1 (hist.cu, both modes) and
// K3 (hist_nat.cu), and the asynchronous copies both stage rows with.
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
// int32 count, side by side (Cells: five words a cell, an odd stride, so
// a warp's adds to consecutive cells spread over all 32 banks; 1-2% faster
// than five separate planes of words, tools/hist_split.py).  A (row,
// feature) pair costs three 32-bit
// shared atomics (the low words of g and h, the count) and one more for
// each of g and h whose high word changes.  The H100 runs one
// conflict-free warp-wide 32-bit shared add a clock (tools/hist_split.py's
// probe), returned value used or not; what keeps the kernels below that
// rate is each warp's chain of loads and adds, so a lane issues the low
// adds of several pairs before any of their high adds (add_pairs).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define STAGE_ROWS 512
#define HIST_THREADS 1024
#define FULL_MASK 0xffffffffu

// A measurement switch (tools/hist_split.py), 0 in every build the port
// runs: 1 compiles every add out (staging only), 2 stages a block's first
// stage only and adds it again in place of each later one (adds only).
#ifndef HIST_SPLIT
#define HIST_SPLIT 0
#endif

typedef unsigned long long u64;

// 2^e as a float, exact for -126 <= e <= 127 (the shift stays inside).
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((127 + e) << 23);
}

// rint(x * 2^s), the fixed-point value of one weight; `scale` is 2^s.
__device__ __forceinline__ long long quantize(float x, float scale) {
  return __float2ll_rn(x * scale);
}

// A block's n cells: word k of cell i (G_LO, G_HI, H_LO, H_HI, CNT), a
// cell's five words side by side (word 5 i + k: 5 is odd, so lanes adding
// to 32 consecutive cells meet in 32 banks).
enum { G_LO, G_HI, H_LO, H_HI, CNT };
struct Cells {
  unsigned* w;
  int n;
  __device__ __forceinline__ unsigned* at(int i, int k) const {
    return w + 5 * i + k;
  }
};

__device__ __forceinline__ Cells carve_cells(void* smem, int n) {
  return {static_cast<unsigned*>(smem), n};
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

// N pairs' weights into cells idx[j] (where on[j]): every low-word add and
// count goes out before the first high word, so a lane has 3N adds in
// flight and waits on one round trip for all N.
template <int N>
__device__ __forceinline__ void add_pairs(const Cells& s, const int* idx,
                                          const long long* qg,
                                          const long long* qh,
                                          const bool* on) {
  if (HIST_SPLIT == 1) return;
  unsigned og[N], oh[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (on[j]) {
      og[j] = atomicAdd(s.at(idx[j], G_LO), (unsigned)qg[j]);
      oh[j] = atomicAdd(s.at(idx[j], H_LO), (unsigned)qh[j]);
      atomicAdd(s.at(idx[j], CNT), 1u);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (on[j]) {
      add_hi(s.at(idx[j], G_HI), qg[j], og[j]);
      add_hi(s.at(idx[j], H_HI), qh[j], oh[j]);
    }
  }
}

// Zero a block's n cells.
__device__ __forceinline__ void zero_cells(const Cells& s, int n) {
  for (int i = threadIdx.x; i < 5 * n; i += blockDim.x) s.w[i] = 0u;
}

// Add a block's nonzero cells to the global (P, 3, F, B) int64 accumulator
// and zero them.  dst(cell) is the cell's g entry; h and the count lie
// `plane` entries further on.
template <class Dst>
__device__ __forceinline__ void flush_cells(const Cells& s, int n,
                                            size_t plane, Dst dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned c = *s.at(i, CNT);
    if (c == 0) continue;  // a cell no row reached is all zero (padding too)
    u64* d = dst(i);
    const u64 g = ((u64)*s.at(i, G_HI) << 32) | *s.at(i, G_LO);
    const u64 h = ((u64)*s.at(i, H_HI) << 32) | *s.at(i, H_LO);
    if (g) atomicAdd(d, g);
    if (h) atomicAdd(d + plane, h);
    atomicAdd(d + 2 * plane, (u64)c);
    for (int k = G_LO; k <= CNT; ++k) *s.at(i, k) = 0u;
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

// Set a kernel's dynamic shared memory to the plan's and check that one
// block of `threads` fits on an SM: the plan (engine/hist.py,
// engine/hist_nat.py) was made for this card's limits.  Both are asked once
// per kernel, card and larger size: the attribute is a ceiling, so a
// smaller launch needs nothing new.
#define HIST_MAX_DEVICES 64
template <class K>
static inline int prepare_launch(K kernel, size_t smem, int threads) {
  static std::atomic<int> ready[HIST_MAX_DEVICES];
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < HIST_MAX_DEVICES &&
      (size_t)ready[dev].load(std::memory_order_relaxed) >= smem)
    return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < HIST_MAX_DEVICES) {
    int seen = ready[dev].load(std::memory_order_relaxed);
    while (seen < (int)smem &&
           !ready[dev].compare_exchange_weak(seen, (int)smem))
      ;
  }
  return 0;
}

// ---- asynchronous copies (sm_90) -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the asynchronous proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies this phase.
__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A cp.async copy of BYTES (4, 8 or 16; both addresses aligned to it).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (0-2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;" ::: "memory");
}
