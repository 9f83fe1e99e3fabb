// A probe of the card's shared-memory atomic rate, for the histogram
// kernels' bound (tools/hist_split.py builds and runs it; no training or
// serving path loads it).
//
// One block of 1024 threads on each SM adds 1 to 32-bit shared words, each
// lane in its own bank (word lane + 32 * warp), `iters` times, in one of
// six ways:
//   0  the returned values used (summed), every add independent;
//   1  the returned value unused;
//   2  each add's value taken from the last add's returned value (a chain:
//      the round trip of one add);
//   3  the returned values used, words drawn at random over 2048 (bank
//      conflicts and shared addresses, as a histogram's bins give them);
//   4  the returned values used, each lane in its own bank but at a
//      random one of 64 words there (K1's cells: a lane a feature, the
//      bin at random);
//   5  as 4, in K1's pattern: per add the low words of g and h (returned),
//      the count, then the two high words, each waiting on its low
//      word's return, on five planes of 2048 words (five adds).
// cycles[b] is block b's clock64() span over the adds.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_THREADS 1024
#define PROBE_WORDS 2048
#define PROBE_PLANES 5

__global__ void __launch_bounds__(PROBE_THREADS, 1)
probe_kernel(int mode, int iters, unsigned long long* cycles,
             unsigned* sink) {
  __shared__ unsigned cell[PROBE_PLANES * PROBE_WORDS];
  for (int i = threadIdx.x; i < PROBE_PLANES * PROBE_WORDS; i += blockDim.x)
    cell[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* w = cell + lane + 32 * warp;
  unsigned acc = 0u, v = 1u, x = threadIdx.x * 2654435761u + 1u;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < iters; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += atomicAdd(w, 1u);
    }
  } else if (mode == 1) {
    for (int i = 0; i < iters; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicAdd(w, 1u);
    }
  } else if (mode == 2) {
    for (int i = 0; i < iters; ++i) v = atomicAdd(w, v) | 1u;
    acc = v;
  } else if (mode == 3) {
    for (int i = 0; i < iters; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x = x * 1664525u + 1013904223u;
        acc += atomicAdd(cell + (x >> 21), 1u);
      }
    }
  } else if (mode == 4) {
    for (int i = 0; i < iters; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x = x * 1664525u + 1013904223u;
        acc += atomicAdd(cell + (x >> 26) * 32 + lane, 1u);
      }
    }
  } else {
    for (int i = 0; i < iters; i += 5) {
      x = x * 1664525u + 1013904223u;
      unsigned* c = cell + (x >> 26) * 32 + lane;
      const unsigned og = atomicAdd(c, x);
      const unsigned oh = atomicAdd(c + PROBE_WORDS, x >> 3);
      atomicAdd(c + 4 * PROBE_WORDS, 1u);
      atomicAdd(c + 2 * PROBE_WORDS, 7u + (og + x < og));
      atomicAdd(c + 3 * PROBE_WORDS, 7u + (oh + (x >> 3) < oh));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = (unsigned long long)(t1 - t0);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc + cell[threadIdx.x];
}

extern "C" int dryad_probe_atomics(int mode, int iters, int blocks,
                                   void* cycles, void* sink, void* stream) {
  probe_kernel<<<blocks, PROBE_THREADS, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      mode, iters, static_cast<unsigned long long*>(cycles),
      static_cast<unsigned*>(sink));
  return (int)cudaGetLastError();
}
