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
// int16), so a block's bins of one feature over consecutive rows are one
// contiguous run; g, h (f32) and sel (i32) per row.  Every base address is
// 16-byte aligned (the wrapper checks it), as the bulk copies need.
//
// Arithmetic: the fixed-point integer sums of hist_accum.cuh in the tree's
// shift.  Integer adds are exact, so K3 does not depend on the order of
// its adds: it equals K1 and its plain version bit for bit on the same
// rows and slots, and is within count * 2^-(s+1) of the exact sum per
// cell.
//
// What bounds it on the H100: the shared-memory atomic updates of the kept
// (row, feature) pairs, three to five 32-bit adds each, at random banks (a
// block holds too few features for K1's conflict-free layout).  The bytes
// are small: 10M rows x (28 B bins + 8 B g/h + 4 B sel) is 0.12 ms at
// 3.35 TB/s.  Staged synchronously (two barriers a stage), a pass spends
// two thirds of its time staging, and a dropped row costs a lane of the
// adds (tools/hist_split.py): hence the ring and the compaction below.
//
// Design (the launch plan comes from engine/hist_nat.py::nat_plan):
// * A block holds every slot of as many features as fit beside the ring at
//   20 B per cell (8 slots x 257 cells: 4 features at Higgs' widths; where
//   one feature's slots do not fit, as at 16 x 1024 bins, the slots are
//   split into groups).  Blocks: (feature chunk x slot group) x row ranges
//   of whole stages, one wave, chunk fastest, so the blocks that read the
//   same rows run side by side and share them in L2.
// * Warp 0 is the producer: one thread fills a ring of three stages with
//   1D bulk copies (cp.async.bulk, completing on the stage's mbarrier) of
//   the stage's sel, g and h and of each of the block's feature runs of
//   xt.  The other 31 warps consume: a warp takes 32-row groups of the
//   stage (rotated from stage to stage, so no warp always gets the odd
//   one), keeps a row whose slot is in the block's group by ballot and
//   compacts the kept rows into a map, so the lanes of the adds carry only
//   kept (row, feature) pairs; each lane issues the low adds of two pairs
//   before their high adds (add_pairs).  A consumer warp releases a stage
//   to the producer on its empty barrier; no block-wide barrier runs
//   between the first and the last stage.
// * g and h are staged as f32 (8 B a row) and quantised at the pair.  The
//   last rows of the pass that do not fill 16 bytes (n_rows mod 4) are read
//   from global memory directly.
// * Each block adds its nonzero cells to a global (P, 3, F, B) int64
//   accumulator once, with atomics; a last pass converts it to f32
//   (hist_accum.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define NAT_CONSUMERS 31  // warps 1..31; warp 0 is the producer
#define NAT_STAGES 3
#define NAT_ROW_BITS 12  // a map entry: the row in its stage, then the slot
#define NAT_PAIRS 2  // pairs a lane adds at once

// The launch plan (engine/hist_nat.py::nat_plan).
struct NatPlan {
  int f_chunk, s_chunk, n_fchunks, n_groups, stage_rows, n_stages;
};

// Words of a feature's (or slot's) cells: B, made odd, so lanes adding one
// bin of different features or slots meet in different banks.
__device__ __forceinline__ int cell_stride(int B) { return B | 1; }

__global__ void __launch_bounds__(HIST_THREADS, 1)
nat_kernel(const uint8_t* __restrict__ xt, int isz, long long n_pad,
           const float* __restrict__ g, const float* __restrict__ h,
           const int* __restrict__ sel, int n_rows, u64* __restrict__ acc,
           int F, int B, int P, NatPlan pl, const int* __restrict__ shift) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int R = pl.stage_rows;
  // this block's (feature chunk, slot group) and its range of stages
  const int gi = blockIdx.x % pl.n_groups;
  const int rk = blockIdx.x / pl.n_groups;
  const int nr = (gridDim.x - gi + pl.n_groups - 1) / pl.n_groups;
  const int st0 = (int)((long long)rk * pl.n_stages / nr);
  const int n_local = (int)((long long)(rk + 1) * pl.n_stages / nr) - st0;
  const int f0 = (gi % pl.n_fchunks) * pl.f_chunk;
  const int nf = min(pl.f_chunk, F - f0);
  const int s0 = (gi / pl.n_fchunks) * pl.s_chunk;
  const int ns = min(pl.s_chunk, P - s0);
  const int bs = cell_stride(B);
  const int n_cells = pl.f_chunk * pl.s_chunk * bs;
  // a stage: sel, g, h (4R bytes each), then each feature's bins at a pitch
  // 32 bytes past its R bins, so lanes reading one row of several
  // features meet in different banks
  const int pitch = R * isz + 32;
  const size_t stage_bytes = (size_t)12 * R + (size_t)pl.f_chunk * pitch;
  u64* full = reinterpret_cast<u64*>(smem + NAT_STAGES * stage_bytes);
  u64* empty = full + NAT_STAGES;
  uint16_t* maps = reinterpret_cast<uint16_t*>(empty + NAT_STAGES);
  const Cells cs = carve_cells(maps + NAT_CONSUMERS * 32, n_cells);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  zero_cells(cs, n_cells);
  if (tid == 0) {
    for (int k = 0; k < NAT_STAGES; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, NAT_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {  // the producer
      for (int k = 0; k < n_local; ++k) {
        const int slot = k % NAT_STAGES;
        if (k >= NAT_STAGES)  // its last round's consumers are done
          mbar_wait(empty + slot, ((k / NAT_STAGES) - 1) & 1);
        if (HIST_SPLIT == 2 && k > 0) {
          mbar_arrive(full + slot);
          continue;
        }
        const long long row0 = (long long)(st0 + k) * R;
        const int rows = (int)min((long long)R, n_rows - row0);
        const unsigned rows4 = rows & ~3;  // whole 16-byte runs of sel/g/h
        const unsigned bin_bytes = (rows * isz + 15) & ~15;  // within n_pad
        uint8_t* st = smem + slot * stage_bytes;
        mbar_expect_tx(full + slot, 12 * rows4 + nf * bin_bytes);
        if (rows4) {
          bulk_load(st, sel + row0, 4 * rows4, full + slot);
          bulk_load(st + 4 * R, g + row0, 4 * rows4, full + slot);
          bulk_load(st + 8 * R, h + row0, 4 * rows4, full + slot);
        }
        for (int fl = 0; fl < nf; ++fl)
          bulk_load(st + 12 * R + fl * pitch,
                    xt + ((size_t)(f0 + fl) * n_pad + row0) * isz, bin_bytes,
                    full + slot);
      }
    }
  } else {
    const int cw = warp - 1;
    uint16_t* map = maps + cw * 32;
    const float sg = pow2f(shift[0]);
    const float sh = pow2f(shift[1]);
    const int G = R / 32;  // row groups a stage
    // the pair stream over a group's kept rows, feature fastest: this
    // lane's first pair (j0, fl0) and the step of 32 pairs
    const int j0 = lane / nf, fl0 = lane - j0 * nf;
    const int dj = 32 / nf, dfl = 32 - dj * nf;
    for (int k = 0; k < n_local; ++k) {
      const int slot = k % NAT_STAGES;
      mbar_wait(full + slot, (k / NAT_STAGES) & 1);
      const long long row0 = (long long)(st0 + k) * R;
      const int rows = (int)min((long long)R, n_rows - row0);
      const int rows4 = rows & ~3;
      const uint8_t* st = smem + (HIST_SPLIT == 2 ? 0 : slot) * stage_bytes;
      const int* ssel = reinterpret_cast<const int*>(st);
      const float* sgv = reinterpret_cast<const float*>(st + 4 * R);
      const float* shv = reinterpret_cast<const float*>(st + 8 * R);
      const uint8_t* sbin = st + 12 * R;
      int j = cw - (int)(((long long)k * G) % NAT_CONSUMERS);
      if (j < 0) j += NAT_CONSUMERS;
      for (; HIST_SPLIT != 1 && j * 32 < rows; j += NAT_CONSUMERS) {
        const int r = j * 32 + lane;
        int s = -1;
        if (r < rows) {
          s = (r < rows4 ? ssel[r] : __ldg(sel + row0 + r)) - s0;
          if ((unsigned)s >= (unsigned)ns) s = -1;  // dropped, or not ours
        }
        const unsigned keep = __ballot_sync(FULL_MASK, s >= 0);
        if (keep == 0) continue;
        if (s >= 0)
          map[__popc(keep & ((1u << lane) - 1))] =
              (uint16_t)(r | (s << NAT_ROW_BITS));
        __syncwarp();
        const int n_pairs = __popc(keep) * nf;
        int pj = j0, pfl = fl0;
        for (int p0 = 0; p0 < n_pairs; p0 += 32 * NAT_PAIRS) {
          int idx[NAT_PAIRS];
          long long qg[NAT_PAIRS], qh[NAT_PAIRS];
          bool on[NAT_PAIRS];
#pragma unroll
          for (int u = 0; u < NAT_PAIRS; ++u) {
            on[u] = p0 + 32 * u + lane < n_pairs;
            idx[u] = 0;
            qg[u] = qh[u] = 0;
            if (on[u]) {
              const int e = map[pj];
              const int rr = e & ((1 << NAT_ROW_BITS) - 1);
              const uint8_t* bp = sbin + pfl * pitch;
              const int bin =
                  isz == 1 ? (int)bp[rr]
                           : (int)reinterpret_cast<const uint16_t*>(bp)[rr];
              const float xg = rr < rows4 ? sgv[rr] : __ldg(g + row0 + rr);
              const float xh = rr < rows4 ? shv[rr] : __ldg(h + row0 + rr);
              on[u] = bin < B;
              idx[u] = (pfl * pl.s_chunk + (e >> NAT_ROW_BITS)) * bs + bin;
              qg[u] = quantize(xg, sg);
              qh[u] = quantize(xh, sh);
            }
            pfl += dfl;
            pj += dj;
            if (pfl >= nf) {
              pfl -= nf;
              ++pj;
            }
          }
          add_pairs<NAT_PAIRS>(cs, idx, qg, qh, on);
        }
        __syncwarp();  // the map is rewritten by the next group
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }
  __syncthreads();
  // cell (fl, sl, bin) -> out[s0 + sl, plane, f0 + fl, bin]
  const size_t fb = (size_t)F * B;
  const int sb = pl.s_chunk * bs;
  flush_cells(cs, nf * sb, fb, [&](int i) {
    const int fl = i / sb;
    const int rem = i - fl * sb;
    const int sl = rem / bs;
    return acc + (size_t)(s0 + sl) * 3 * fb + (size_t)(f0 + fl) * B +
           (rem - sl * bs);
  });
}

// The plan's numbers (engine/hist_nat.py::nat_plan): features and slots a
// block, stage rows, blocks and shared-memory bytes.
extern "C" int dryad_hist_nat(const void* xt, int isz, long long n_pad,
                              const void* g, const void* h, const void* sel,
                              int n_rows, void* acc, int F, int B, int P,
                              int f_chunk, int s_chunk, int stage_rows,
                              int grid, int smem, const void* shift,
                              void* out, int* info, void* stream) {
  int rc = prepare_launch(nat_kernel, (size_t)smem, HIST_THREADS);
  if (rc != 0) return rc;
  NatPlan pl;
  pl.f_chunk = f_chunk;
  pl.s_chunk = s_chunk;
  pl.n_fchunks = (F + f_chunk - 1) / f_chunk;
  pl.n_groups = pl.n_fchunks * ((P + s_chunk - 1) / s_chunk);
  pl.stage_rows = stage_rows;
  pl.n_stages = (n_rows + stage_rows - 1) / stage_rows;
  info[0] = smem;
  info[1] = grid;
  info[2] = f_chunk;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_rows > 0)
    nat_kernel<<<grid, HIST_THREADS, smem, st>>>(
        static_cast<const uint8_t*>(xt), isz, n_pad,
        static_cast<const float*>(g), static_cast<const float*>(h),
        static_cast<const int*>(sel), n_rows, static_cast<u64*>(acc), F, B,
        P, pl, static_cast<const int*>(shift));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out == nullptr: accumulate only; the caller converts the int64 sums
  if (out == nullptr) return 0;
  return launch_out(acc, shift, out, (long long)P * 3 * F * B,
                    (long long)F * B, st);
}
