// K3: histograms of up to 16 slots in one pass over the rows in natural
// order, with no tile plan and no gather.
//
// Replaces the TPU kernel dryad_tpu/engine/pallas_hist.py::_nat_kernel
// (launched by build_hist_nat).  Same function, not the TPU mechanics (no
// one-hot product, no bf16 limbs, no 128-row weight tile): each row carries
// its slot id `sel`; a row with sel outside [0, P) adds nothing.  The output
// is (P, 3, F, B) f32: per slot the sums of g, h and 1 per (feature, bin);
// every slot is written, and a slot without rows is zero.
//
// Input: the bins as a feature-major (F, n_pad) copy (u8, or u16 stored as
// int16), so a warp's reads of one feature over consecutive rows are
// contiguous; g, h (f32) and sel (i32) per row.
//
// What bounds it on the H100: the shared-memory updates, as in K1.  The
// bytes are small: 10M rows x (28 B bins + 8 B g/h + 4 B sel) is 0.12 ms at
// 3.35 TB/s.
//
// Design:
// * One block owns one fixed row range, a chunk of features and a group of
//   slots (grid x, y, z), and keeps a private histogram of all its
//   (feature, slot, bin) cells in shared memory: fp64 g/h and an fp32 count,
//   20 B per cell.  At 16 slots x 256 bins that is 80 KB per feature, so a
//   block takes one feature and two blocks fit an SM.
// * Determinism without float atomics (hist_accum.cuh): (feature, slot)
//   pair q belongs to warp q % 8, so every cell has one writer.  For each
//   feature it owns a pair of, a warp first compacts the staged rows of its
//   own slots into a list (ballot + prefix count, ascending row order), then
//   adds them 32 at a time keyed on (slot, bin).  A warp so spends its
//   match work only on its own rows, and dropped rows cost one ballot.
// * Accuracy: fp64 sums, rounded to fp32 once in the second pass, as K1
//   does, so K3 and K1 agree on the same rows.
// * Second pass: each output cell sums its per-range partials in range
//   order (a fixed order).  The range count is chosen so that the fp64
//   partials stay near 256 MB (engine/hist_nat.py).
// Simple and right first: no TMA, no cp.async pipelining, no tuning yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define STAGE_ROWS 512
#define THREADS 256
#define NWARPS (THREADS / 32)

__global__ void __launch_bounds__(THREADS)
nat_ranges_kernel(const uint8_t* __restrict__ xt, int isz, long long n_pad,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ sel, int n_rows, int rows_per_range,
                  double* __restrict__ partials, int F, int B, int P,
                  int f_chunk, int s_chunk) {
  extern __shared__ double smem[];
  const int range = blockIdx.x;
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, F - f0);
  const int s0 = blockIdx.z * s_chunk;
  const int ns = min(s_chunk, P - s0);
  const int r_begin = range * rows_per_range;
  const int r_end = min(n_rows, r_begin + rows_per_range);
  const int n_cells = f_chunk * s_chunk * B;

  double* hg = smem;
  double* hh = hg + n_cells;
  float* hc = reinterpret_cast<float*>(hh + n_cells);
  float* sg = hc + n_cells;
  float* sh = sg + STAGE_ROWS;
  int* ssl = reinterpret_cast<int*>(sh + STAGE_ROWS);
  uint16_t* sbin = reinterpret_cast<uint16_t*>(ssl + STAGE_ROWS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint16_t* list = sbin + (f_chunk + warp) * STAGE_ROWS;  // this warp's rows

  zero_hist(hg, n_cells);

  for (int base = r_begin; base < r_end; base += STAGE_ROWS) {
    __syncthreads();  // previous stage's readers are done
    for (int r = tid; r < STAGE_ROWS; r += THREADS) {
      const int row = base + r;
      int sl = -1;
      if (row < r_end) {
        sl = sel[row] - s0;
        if (sl < 0 || sl >= ns) sl = -1;  // dropped, or another slot group
      }
      ssl[r] = sl;
      sg[r] = sl >= 0 ? g[row] : 0.f;
      sh[r] = sl >= 0 ? h[row] : 0.f;
    }
    for (int e = tid; e < nf * STAGE_ROWS; e += THREADS) {
      const int fl = e / STAGE_ROWS;
      const int r = e - fl * STAGE_ROWS;
      const int row = base + r;
      const size_t at = (size_t)(f0 + fl) * n_pad + row;
      uint16_t b = 0;
      if (row < r_end)
        b = isz == 1 ? (uint16_t)xt[at]
                     : reinterpret_cast<const uint16_t*>(xt)[at];
      sbin[e] = b;
    }
    __syncthreads();
    for (int fl = 0; fl < nf; ++fl) {
      // pairs (fl, 0..ns-1) are q = fl*ns .. fl*ns+ns-1: does one of them
      // fall to this warp?  (uniform across the warp)
      const int q0 = fl * ns;
      const int first_mine = q0 + ((warp - q0 % NWARPS) + NWARPS) % NWARPS;
      if (first_mine >= q0 + ns) continue;
      // compact this warp's rows (ascending) into its list ...
      int n_own = 0;
      for (int ch = 0; ch < STAGE_ROWS / 32; ++ch) {
        const int r = ch * 32 + lane;
        const int sl = ssl[r];
        const bool own = sl >= 0 && ((q0 + sl) % NWARPS) == warp;
        const unsigned b = __ballot_sync(0xffffffffu, own);
        if (own) list[n_own + __popc(b & ((1u << lane) - 1u))] = (uint16_t)r;
        n_own += __popc(b);
      }
      __syncwarp();
      // ... then add them 32 at a time
      for (int c = 0; c < n_own; c += 32) {
        int cell = -1;
        if (c + lane < n_own) {
          const int r = list[c + lane];
          const int bin = sbin[fl * STAGE_ROWS + r];
          if (bin < B) cell = (fl * s_chunk + ssl[r]) * B + bin;
        }
        warp_add_chunk(
            cell,
            [&](int j, float& gj, float& hj) {
              const int rj = list[c + j];
              gj = sg[rj];
              hj = sh[rj];
            },
            hg, hh, hc);
      }
      __syncwarp();  // the list is rewritten for the next feature
    }
  }
  __syncthreads();
  // partials: (n_ranges, P, 3, F, B) fp64; this block's slots and features
  const size_t fb = (size_t)F * B;
  double* dst = partials + (size_t)range * P * 3 * fb;
  const int per_plane = ns * nf * B;
  for (int i = tid; i < 3 * per_plane; i += THREADS) {
    const int plane = i / per_plane;
    int rem = i - plane * per_plane;
    const int sl = rem / (nf * B);
    rem -= sl * nf * B;
    const int fl = rem / B;
    const int b = rem - fl * B;
    const int cell = (fl * s_chunk + sl) * B + b;
    dst[((size_t)(s0 + sl) * 3 + plane) * fb + (size_t)(f0 + fl) * B + b] =
        plane == 0 ? hg[cell] : plane == 1 ? hh[cell] : (double)hc[cell];
  }
}

// Second pass: out[e] = sum over ranges, in range order, rounded once.
__global__ void nat_reduce_kernel(const double* __restrict__ partials,
                                  int n_ranges, float* __restrict__ out,
                                  long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  double acc = 0.0;
  for (int r = 0; r < n_ranges; ++r) acc += partials[(size_t)r * total + e];
  out[e] = (float)acc;
}

extern "C" int dryad_hist_nat(const void* xt, int isz, long long n_pad,
                              const void* g, const void* h, const void* sel,
                              int n_rows, int rows_per_range, int n_ranges,
                              void* partials, int F, int B, int P,
                              int f_chunk, int n_fchunks, int s_chunk,
                              int n_schunks, void* out, void* stream) {
  const size_t smem =
      (size_t)f_chunk * s_chunk * B * (2 * sizeof(double) + sizeof(float)) +
      (size_t)STAGE_ROWS * (2 * sizeof(float) + sizeof(int)) +
      (size_t)(f_chunk + NWARPS) * STAGE_ROWS * sizeof(uint16_t);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      nat_ranges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_ranges, n_fchunks, n_schunks);
  nat_ranges_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(xt), isz, n_pad,
      static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<const int*>(sel), n_rows, rows_per_range,
      static_cast<double*>(partials), F, B, P, f_chunk, s_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)P * 3 * F * B;
  nat_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const double*>(partials), n_ranges,
      static_cast<float*>(out), total);
  return (int)cudaGetLastError();
}
