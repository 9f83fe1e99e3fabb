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
// int16), so a block's reads of one feature over consecutive rows are
// contiguous; g, h (f32) and sel (i32) per row.
//
// Arithmetic: the fixed-point integer sums of hist_accum.cuh in the tree's
// shift.  Integer adds are exact, so K3 does not depend on the order of
// its adds: it equals K1 and its plain version bit for bit on the same
// rows and slots, and is within count * 2^-(s+1) of the exact sum per
// cell.
//
// What bounds it on the H100: the shared-memory atomic updates (three to
// five 32-bit adds per kept (row, feature) pair, as in K1, but with the
// lanes' cells spread at random over the banks, as a block holds too few
// features for K1's conflict-free layout) and the latency of staging
// rows.  The bytes are
// small: 10M rows x (28 B bins + 8 B g/h + 4 B sel) is 0.12 ms at
// 3.35 TB/s.
//
// Design:
// * A block holds every slot of as many features as fit 227 KB at 20 B
//   per cell (16 slots x 256 bins is 80 KB a feature, so 2 at Higgs'
//   widths; where one feature's slots do not fit, as at 16 x 1024 bins,
//   the slots are split into groups).  It stages as many rows at a time
//   as the rest of shared memory holds, up to 4096 (2560 at Higgs'
//   widths): sel, g and h (quantised once) and the bins of its features,
//   each thread issuing several loads before it uses any.  Any thread adds
//   any kept (row, feature) pair with shared-memory atomics; a dropped row
//   costs one compare.
// * Grid (feature chunk x slot group, row ranges): one wave of resident
//   blocks, feature chunk fastest, so the blocks that stage the same rows
//   run side by side and share those rows in L2.  Each block adds its
//   nonzero cells to a global (P, 3, F, B) int64 accumulator once, with
//   atomics; a last pass converts it to f32 (hist_accum.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define MAX_STAGE_ROWS 4096
#define LOAD_BATCH 4  // rows or bins a staging thread loads at once

// Words of a K3 feature's (or slot's) cells: B, made odd, so lanes adding
// one bin of different features or slots meet in different banks.
static inline __host__ __device__ int cell_stride(int B) { return B | 1; }

// fn(r, fl) for every (row, feature) pair of n_rows staged rows, over all
// the block's threads, feature fastest: the lanes of a warp mostly take one
// row's features, whose cells lie in different feature planes, so lanes
// rarely meet on one cell even where a bin holds most rows.
template <class Fn>
__device__ __forceinline__ void for_pairs(int nf, int n_rows, Fn fn) {
  int r = threadIdx.x / nf;
  int fl = threadIdx.x - r * nf;
  const int dr = blockDim.x / nf;
  const int dfl = blockDim.x - dr * nf;
  while (r < n_rows) {
    fn(r, fl);
    fl += dfl;
    r += dr;
    if (fl >= nf) {
      fl -= nf;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(HIST_THREADS, 1)
nat_kernel(const uint8_t* __restrict__ xt, int isz, long long n_pad,
           const float* __restrict__ g, const float* __restrict__ h,
           const int* __restrict__ sel, int n_rows, int rows_per_range,
           u64* __restrict__ acc, int F, int B, int P, int f_chunk,
           int n_fchunks, int s_chunk, int stage_rows,
           const int* __restrict__ shift) {
  extern __shared__ __align__(16) unsigned smem[];
  const int fc = blockIdx.x % n_fchunks;
  const int f0 = fc * f_chunk;
  const int nf = min(f_chunk, F - f0);
  const int s0 = (blockIdx.x / n_fchunks) * s_chunk;
  const int ns = min(s_chunk, P - s0);
  const int r_begin = blockIdx.y * rows_per_range;
  const int r_end = min(n_rows, r_begin + rows_per_range);
  const int bs = cell_stride(B);
  const int n_cells = f_chunk * s_chunk * bs;
  long long* qg = reinterpret_cast<long long*>(smem);
  long long* qh = qg + stage_rows;
  const Cells cs = carve_cells(qh + stage_rows, n_cells);
  int* ssl = cs.c + n_cells;
  uint16_t* sbin = reinterpret_cast<uint16_t*>(ssl + stage_rows);  // [r][fl]
  const int tid = threadIdx.x;
  const float sg = pow2f(shift[0]);
  const float sh = pow2f(shift[1]);

  zero_cells(cs, n_cells);
  for (int base = r_begin; base < r_end; base += stage_rows) {
    __syncthreads();  // previous stage's readers are done
    // a thread issues LOAD_BATCH rows' loads before it uses any
    for (int r0 = tid; r0 < stage_rows; r0 += LOAD_BATCH * blockDim.x) {
      int sl[LOAD_BATCH];
      float gv[LOAD_BATCH], hv[LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int r = r0 + j * blockDim.x, row = base + r;
        const bool in = r < stage_rows && row < r_end;
        sl[j] = in ? __ldg(sel + row) - s0 : -1;
        gv[j] = in ? __ldg(g + row) : 0.f;
        hv[j] = in ? __ldg(h + row) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int r = r0 + j * blockDim.x;
        if (r < stage_rows) {
          // dropped, or another slot group
          const int s = sl[j] < 0 || sl[j] >= ns ? -1 : sl[j];
          ssl[r] = s;
          qg[r] = s >= 0 ? quantize(gv[j], sg) : 0;
          qh[r] = s >= 0 ? quantize(hv[j], sh) : 0;
        }
      }
    }
    for (int e0 = tid; e0 < nf * stage_rows; e0 += LOAD_BATCH * blockDim.x) {
      uint16_t b[LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int e = e0 + j * blockDim.x;
        const int fl = e / stage_rows;
        const int row = base + e - fl * stage_rows;
        const size_t at = (size_t)(f0 + fl) * n_pad + row;
        b[j] = 0;
        if (e < nf * stage_rows && row < r_end)
          b[j] = isz == 1 ? (uint16_t)__ldg(xt + at)
                          : __ldg(reinterpret_cast<const uint16_t*>(xt) + at);
      }
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int e = e0 + j * blockDim.x;
        if (e < nf * stage_rows) {
          const int fl = e / stage_rows;
          sbin[(e - fl * stage_rows) * f_chunk + fl] = b[j];
        }
      }
    }
    __syncthreads();
    for_pairs(nf, stage_rows, [&](int r, int fl) {
      const int sl = ssl[r];
      if (sl < 0) return;  // a dropped row costs this compare
      const int bin = sbin[r * f_chunk + fl];
      if (bin < B) add_row(cs, (fl * s_chunk + sl) * bs + bin, qg[r], qh[r]);
    });
  }
  __syncthreads();
  // cell (fl, sl, bin) -> out[s0 + sl, plane, f0 + fl, bin]
  const size_t fb = (size_t)F * B;
  const int sb = s_chunk * bs;
  flush_cells(cs, nf * sb, fb, [&](int i) {
    const int fl = i / sb;
    const int rem = i - fl * sb;
    const int sl = rem / bs;
    return acc + (size_t)(s0 + sl) * 3 * fb + (size_t)(f0 + fl) * B +
           (rem - sl * bs);
  });
}

// Shared memory of one block: per staged row its quantised g/h (int64),
// the cells (20 B each), then per staged row its slot and bins.
static size_t nat_smem(int f_chunk, int s_chunk, int B, int stage_rows) {
  return (size_t)f_chunk * s_chunk * cell_stride(B) * 5 * sizeof(unsigned) +
         (size_t)stage_rows * (2 * sizeof(long long) + sizeof(int) +
                               f_chunk * sizeof(uint16_t));
}

extern "C" int dryad_hist_nat(const void* xt, int isz, long long n_pad,
                              const void* g, const void* h, const void* sel,
                              int n_rows, void* acc, int F, int B, int P,
                              const void* shift, void* out, int* info,
                              void* stream) {
  int optin = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = device_limits(&optin, &n_sm);
  if (err != cudaSuccess) return (int)err;
  // all slots of as many features as fit beside a 512-row stage, else one
  // feature and slot groups; then the stage grows into what is left, up to
  // MAX_STAGE_ROWS rows, so each round of barriers carries more rows
  const size_t fixed = nat_smem(0, P, B, STAGE_ROWS);
  int f_chunk = 1, s_chunk = P;
  if (nat_smem(1, P, B, STAGE_ROWS) <= (size_t)optin) {
    const size_t per_feature = nat_smem(1, P, B, STAGE_ROWS) - fixed;
    f_chunk = balanced(F, (int)(((size_t)optin - fixed) / per_feature));
  } else {
    const size_t per_slot =
        nat_smem(1, 1, B, STAGE_ROWS) - nat_smem(1, 0, B, STAGE_ROWS);
    const int cap = (int)(((size_t)optin - nat_smem(1, 0, B, STAGE_ROWS)) /
                          per_slot);
    if (cap < 1) return (int)cudaErrorInvalidValue;
    s_chunk = balanced(P, cap);
  }
  int stage_rows = MAX_STAGE_ROWS;
  while (stage_rows > STAGE_ROWS &&
         nat_smem(f_chunk, s_chunk, B, stage_rows) > (size_t)optin)
    stage_rows -= STAGE_ROWS;
  const int n_fchunks = (F + f_chunk - 1) / f_chunk;
  const int n_groups = n_fchunks * ((P + s_chunk - 1) / s_chunk);
  const size_t smem = nat_smem(f_chunk, s_chunk, B, stage_rows);
  err = cudaFuncSetAttribute(nat_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nat_kernel,
                                                      HIST_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // row ranges of whole stages: as many as fill one wave with the chunks
  const int n_stages = max(1, (n_rows + STAGE_ROWS - 1) / STAGE_ROWS);
  int n_ranges = per_sm * n_sm / n_groups;
  n_ranges = max(1, min(n_ranges, n_stages));
  const int rows_per_range =
      (n_stages + n_ranges - 1) / n_ranges * STAGE_ROWS;
  n_ranges = max(1, (n_rows + rows_per_range - 1) / rows_per_range);
  info[0] = (int)smem;
  info[1] = n_groups * n_ranges;
  info[2] = f_chunk;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(n_groups, n_ranges);
  nat_kernel<<<grid, HIST_THREADS, smem, st>>>(
      static_cast<const uint8_t*>(xt), isz, n_pad,
      static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<const int*>(sel), n_rows, rows_per_range,
      static_cast<u64*>(acc), F, B, P, f_chunk, n_fchunks, s_chunk,
      stage_rows, static_cast<const int*>(shift));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out == nullptr: accumulate only; the caller converts the int64 sums
  if (out == nullptr) return 0;
  return launch_out(acc, shift, out, (long long)P * 3 * F * B,
                    (long long)F * B, st);
}
