// K1: leaf-segmented histograms of planned 512-row tiles, in two modes.
//
// Replaces the TPU kernel dryad_tpu/engine/pallas_hist.py::_hist_kernel
// (launched by _hist_tiles).  Same function, not the TPU mechanics: no
// one-hot product, no bf16 limb split, no feature-major transpose.  Per
// output leaf it sums g, h and 1 over the live rows per (feature, bin).
//
// * Layout mode (hist_items_kernel, the wired path): tiles of 128-byte
//   layout records, read in place (g at byte 0, h at 4, valid flag at 8,
//   bins from 9); a plan slot names a source tile.
// * Row mode (hist_rows_kernel, the legacy plan arm and the root of any
//   record width): a plan `buf` of row ids (n_rows marks an empty slot)
//   into a per-tree record table of words [g, h, bin bytes...] of any
//   width.  A block stages only g, h and the bytes of its own feature
//   chunk: at Epsilon's 2008-byte rows a whole tile would be 1 MB.
//
// Arithmetic: fixed-point integer sums in the tree's shift
// (hist_accum.cuh).  Integer adds are exact, so the result does not depend
// on the order of the adds: it equals K3's and the plain version's bit for
// bit and is within count * 2^-(s+1) of the exact sum per cell.
//
// What bounds it on the H100: the shared-memory atomic updates (per live
// (row, feature) pair three 32-bit ATOMS.ADD, for the low words of g and h
// and the count, and a high-word add for each of g and h whose value
// reaches past 32 bits, as most do at the tree's shift) and the latency of
// staging each tile, not the bytes: a Higgs tile is 37 used bytes per row
// (~19 KB) but 14,336 pairs.
//
// Design (both modes):
// * No cell has an owner: a warp takes one staged row at a time and its
//   lanes the row's features, adding each to its cell with shared-memory
//   atomics.  Cells lie feature-fastest with a pitch that is a multiple of
//   32 features, so a warp's 32 adds hit 32 banks whatever the bins.  g and
//   h are quantised once per row when the tile is staged.
// * A block holds as many features as fit 227 KB at 20 B per cell, in
//   whole warps of 32: all 28 of Higgs at 256 bins (164 KB of cells), so
//   each tile is staged once.  Row mode at Epsilon's 2000 features takes
//   chunks of 32 (63 chunks); each re-gathers the rows' g/h, 8 B a row,
//   far below the cost of the updates, so chunks are not joined into
//   thread-block clusters.
// * Work items: each plan tile up to the last live one, times each feature
//   chunk.  The grid is one wave of resident blocks (one per SM); each
//   takes a balanced contiguous span of the items and adds its cells to a
//   global (P, 3, F, B) int64 accumulator (global atomics, nonzero cells
//   only) whenever its leaf or chunk changes, so a block flushes about once
//   per leaf it meets.  Dead plan tiles are skipped.  A last pass converts
//   the accumulator to f32 (hist_accum.cuh), so every leaf is written and
//   an empty leaf is zero.
// * The next tile's loads go out into registers while the current tile is
//   added (two barriers a tile); the stage has an odd word stride, so lanes
//   reading one byte column of 32 rows hit 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define REC_WB 128
#define ROW_THREADS (HIST_THREADS / STAGE_ROWS)  // threads staging one row
#define STAGE_BATCH 8  // words of a row a staging thread loads at once
// a layout tile's 16-byte vectors per thread (512 rows x at most 8)
#define PRE_VECS (STAGE_ROWS * (REC_WB / 16) / HIST_THREADS)

// The block's span [u0, u1) of the n_used * n_chunks work items (chunk
// major).
struct Span {
  long long u0, u1;
};

__device__ __forceinline__ Span block_span(int n_used, int n_chunks) {
  const long long U = (long long)n_used * n_chunks;
  return {U * blockIdx.x / gridDim.x, U * (blockIdx.x + 1) / gridDim.x};
}

// Add the block's cells of (leaf, features f0..) to the accumulator.  Cell
// (fl, bin) is word bin * fp + fl of each plane.
__device__ __forceinline__ void flush_leaf(const Cells& cs, u64* acc,
                                           int leaf, int f0, int fp, int F,
                                           int B) {
  const size_t fb = (size_t)F * B;
  u64* base = acc + (size_t)leaf * 3 * fb + (size_t)f0 * B;
  flush_cells(cs, fp * B, fb, [&](int i) {
    const int bin = i / fp;
    return base + (i - bin * fp) * B + bin;
  });
}

// fn(fl) for each feature of a staged row: lane fl of the warp, then fl + 32
// and on.
template <class Fn>
__device__ __forceinline__ void for_features(int nf, Fn fn) {
  for (int fl = threadIdx.x & 31; fl < nf; fl += 32) fn(fl);
}

// A layout tile's used 16-byte vectors into registers.
__device__ __forceinline__ void load_tile(uint4* pre, const uint8_t* rec,
                                          int s, int nvec) {
  const uint4* tile =
      reinterpret_cast<const uint4*>(rec + (size_t)s * STAGE_ROWS * REC_WB);
#pragma unroll
  for (int j = 0; j < PRE_VECS; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    if (e < STAGE_ROWS * nvec) {
      const int r = e / nvec;
      pre[j] = __ldg(tile + (size_t)r * (REC_WB / 16) + (e - r * nvec));
    }
  }
}

__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_items_kernel(const uint8_t* __restrict__ rec,
                  const int* __restrict__ src,
                  const int* __restrict__ tile_leaf,
                  const int* __restrict__ n_used_p, int n_chunks,
                  u64* __restrict__ acc, int P, int F, int B, int isz,
                  int f_chunk, int fp, int words_per_row, int nvec,
                  const int* __restrict__ shift) {
  extern __shared__ __align__(16) unsigned smem[];
  const int n_used = *n_used_p;
  const Span sp = block_span(n_used, n_chunks);
  if (sp.u0 >= sp.u1) return;
  const int n_cells = fp * B;
  long long* qg = reinterpret_cast<long long*>(smem);
  long long* qh = qg + STAGE_ROWS;
  const Cells cs = carve_cells(qh + STAGE_ROWS, n_cells);
  uint32_t* stage = reinterpret_cast<uint32_t*>(cs.c + n_cells);
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(stage);
  const int row_bytes = words_per_row * 4;
  const int tid = threadIdx.x;
  const float sg = pow2f(shift[0]);
  const float sh = pow2f(shift[1]);

  zero_cells(cs, n_cells);
  uint4 pre[PRE_VECS];
  int pre_s = -1;  // the tile held in pre
  int cur_leaf = -1, cur_f0 = 0;
  for (long long u = sp.u0; u < sp.u1; ++u) {
    const int c = (int)(u / n_used);
    const int t = (int)(u - (long long)c * n_used);
    const int s = __ldg(src + t);
    if (s < 0) continue;  // dead plan slot: contributes nothing
    const int leaf = __ldg(tile_leaf + t);
    if (leaf < 0 || leaf >= P) continue;  // no such output leaf: dead
    const int f0 = c * f_chunk;
    const int nf = min(f_chunk, F - f0);
    if (cur_leaf >= 0 && (leaf != cur_leaf || f0 != cur_f0)) {
      __syncthreads();  // the last tile's adds are done
      flush_leaf(cs, acc, cur_leaf, cur_f0, fp, F, B);
    }
    cur_leaf = leaf;
    cur_f0 = f0;
    // the plan's next tile, mostly the next one this block adds
    const int s_next = t + 1 < n_used ? __ldg(src + t + 1) : -1;
    if (pre_s != s) load_tile(pre, rec, s, nvec);  // not prefetched
    __syncthreads();  // stage readers and the flush are done
#pragma unroll
    for (int j = 0; j < PRE_VECS; ++j) {
      const int e = tid + j * blockDim.x;
      if (e < STAGE_ROWS * nvec) {
        const int r = e / nvec, cc = e - r * nvec;
        uint32_t* d = stage + r * words_per_row + cc * 4;
        d[0] = pre[j].x;
        d[1] = pre[j].y;
        d[2] = pre[j].z;
        d[3] = pre[j].w;
        if (cc == 0) {  // the row's g and h
          qg[r] = quantize(__uint_as_float(pre[j].x), sg);
          qh[r] = quantize(__uint_as_float(pre[j].y), sh);
        }
      }
    }
    // the next tile into registers while this one is added
    pre_s = s_next;
    if (s_next >= 0) load_tile(pre, rec, s_next, nvec);
    __syncthreads();
    for (int r = tid >> 5; r < STAGE_ROWS; r += blockDim.x >> 5) {
      const uint8_t* row = sb + r * row_bytes;
      if (row[8] != 1) continue;  // not a live row (warp-uniform)
      const long long rg = qg[r], rh = qh[r];
      const uint8_t* bins = row + 9 + f0 * isz;
      for_features(nf, [&](int fl) {
        const int bin = isz == 1 ? (int)bins[fl]
                                 : (int)bins[2 * fl] | ((int)bins[2 * fl + 1] << 8);
        if (bin < B) add_row(cs, bin * fp + fl, rg, rh);
      });
    }
  }
  __syncthreads();
  if (cur_leaf >= 0) flush_leaf(cs, acc, cur_leaf, cur_f0, fp, F, B);
}

// Row mode.  recs: (n_rows, rec_words) u32 words [g, h, bin bytes...];
// buf: plan slots (row ids, n_rows = empty); src[t]: t for a plan tile with
// a live row, else -1.  stage_words >= the words any feature chunk's bytes
// span, odd.
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_rows_kernel(const uint32_t* __restrict__ recs, int rec_words,
                 int n_rows, const int* __restrict__ buf,
                 const int* __restrict__ src,
                 const int* __restrict__ tile_leaf,
                 const int* __restrict__ n_used_p, int n_chunks,
                 u64* __restrict__ acc, int P, int F, int B, int isz,
                 int f_chunk, int fp, int stage_words,
                 const int* __restrict__ shift) {
  extern __shared__ __align__(16) unsigned smem[];
  const int n_used = *n_used_p;
  const Span sp = block_span(n_used, n_chunks);
  if (sp.u0 >= sp.u1) return;
  const int n_cells = fp * B;
  long long* qg = reinterpret_cast<long long*>(smem);
  long long* qh = qg + STAGE_ROWS;
  const Cells cs = carve_cells(qh + STAGE_ROWS, n_cells);
  int* sid = cs.c + n_cells;
  uint32_t* stage = reinterpret_cast<uint32_t*>(sid + STAGE_ROWS);
  const int tid = threadIdx.x;
  const float sg = pow2f(shift[0]);
  const float sh = pow2f(shift[1]);

  zero_cells(cs, n_cells);
  // ROW_THREADS threads stage each row of a tile: this thread's row and
  // part, and its loads of it, held in registers (p_*) for the next tile
  // while the current one is added
  const int r_own = tid / ROW_THREADS, part = tid - r_own * ROW_THREADS;
  int p_id = -1, pre_t = -1, pre_f0 = -1;
  uint32_t p_g = 0u, p_h = 0u, p_w[STAGE_BATCH];
  auto load_row = [&](int id, int w_lo, int nw) {
    p_id = id;
    const bool ok = id >= 0 && id < n_rows;
    const uint32_t* rr = recs + (size_t)(ok ? id : 0) * rec_words;
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int cc = part + j * ROW_THREADS;
      p_w[j] = ok && cc < nw ? __ldg(rr + 2 + w_lo + cc) : 0u;
    }
    if (part == 0 && ok) {
      p_g = __ldg(rr);
      p_h = __ldg(rr + 1);
    }
  };
  int cur_leaf = -1, cur_f0 = 0;
  for (long long u = sp.u0; u < sp.u1; ++u) {
    const int c = (int)(u / n_used);
    const int t = (int)(u - (long long)c * n_used);
    if (__ldg(src + t) < 0) continue;  // tile without live rows
    const int leaf = __ldg(tile_leaf + t);
    if (leaf < 0 || leaf >= P) continue;  // no such output leaf: dead
    const int f0 = c * f_chunk;
    const int nf = min(f_chunk, F - f0);
    if (cur_leaf >= 0 && (leaf != cur_leaf || f0 != cur_f0)) {
      __syncthreads();
      flush_leaf(cs, acc, cur_leaf, cur_f0, fp, F, B);
    }
    cur_leaf = leaf;
    cur_f0 = f0;
    // this chunk's bin bytes [b_lo, b_lo + nf*isz) lie in words w_lo.. of
    // the bins, starting `skew` bytes into the first word
    const int b_lo = f0 * isz;
    const int w_lo = b_lo >> 2;
    const int nw = ((b_lo + nf * isz + 3) >> 2) - w_lo;
    const int skew = b_lo - 4 * w_lo;
    // the next plan tile's ids now, its words after the stage below
    const int nid = t + 1 < n_used
                        ? __ldg(buf + (size_t)(t + 1) * STAGE_ROWS + r_own)
                        : -1;
    if (pre_t != t || pre_f0 != f0)  // not prefetched
      load_row(__ldg(buf + (size_t)t * STAGE_ROWS + r_own), w_lo, nw);
    __syncthreads();  // stage readers and the flush are done
    {
      const bool ok = p_id >= 0 && p_id < n_rows;
      if (part == 0) {
        sid[r_own] = ok ? p_id : -1;
        qg[r_own] = ok ? quantize(__uint_as_float(p_g), sg) : 0;
        qh[r_own] = ok ? quantize(__uint_as_float(p_h), sh) : 0;
      }
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j) {
        const int cc = part + j * ROW_THREADS;
        if (cc < nw) stage[r_own * stage_words + cc] = p_w[j];
      }
      // words past the registers, read now
      const uint32_t* rr = recs + (size_t)(ok ? p_id : 0) * rec_words;
      for (int cc = part + STAGE_BATCH * ROW_THREADS; cc < nw;
           cc += ROW_THREADS)
        stage[r_own * stage_words + cc] = ok ? __ldg(rr + 2 + w_lo + cc) : 0u;
    }
    pre_t = t + 1;
    pre_f0 = f0;
    load_row(nid, w_lo, nw);
    __syncthreads();
    for (int r = tid >> 5; r < STAGE_ROWS; r += blockDim.x >> 5) {
      if (sid[r] < 0) continue;  // warp-uniform
      const long long rg = qg[r], rh = qh[r];
      const uint8_t* rb =
          reinterpret_cast<const uint8_t*>(stage + r * stage_words) + skew;
      for_features(nf, [&](int fl) {
        const int bin = isz == 1 ? (int)rb[fl]
                                 : (int)rb[2 * fl] | ((int)rb[2 * fl + 1] << 8);
        if (bin < B) add_row(cs, bin * fp + fl, rg, rh);
      });
    }
  }
  __syncthreads();
  if (cur_leaf >= 0) flush_leaf(cs, acc, cur_leaf, cur_f0, fp, F, B);
}

// The plan tiles in use.  Row mode (buf given): src[t] = t for a tile with
// a live row (an id below n_rows), else -1.  Both modes: n_used = 1 + the
// last tile with src >= 0 (0 when none), on the device, so the work items
// stop there and no block is left with only the dead tail of a static plan.
__global__ void plan_used_kernel(const int* __restrict__ buf, int n_rows,
                                 int* __restrict__ src, int n_sel,
                                 int* __restrict__ n_used) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (t >= n_sel) return;
  const int lane = threadIdx.x & 31;
  bool live;
  if (buf) {
    bool any = false;
    for (int r = lane; r < STAGE_ROWS; r += 32) {
      const int id = __ldg(buf + (size_t)t * STAGE_ROWS + r);
      any |= id >= 0 && id < n_rows;
    }
    live = __any_sync(0xffffffffu, any);
    if (lane == 0) src[t] = live ? t : -1;
  } else {
    live = src[t] >= 0;
  }
  if (lane == 0 && live) atomicMax(n_used, t + 1);
}

static int launch_plan_used(const void* buf, int n_rows, void* src,
                            int n_sel, void* n_used, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(n_used, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  plan_used_kernel<<<(n_sel + 7) / 8, 256, 0, st>>>(
      static_cast<const int*>(buf), n_rows, static_cast<int*>(src), n_sel,
      static_cast<int*>(n_used));
  return (int)cudaGetLastError();
}

// Shared memory of one block: the quantised g/h of a tile (int64), its
// cells (20 B each, for fp features: the pitch) and, in row mode, the
// tile's row ids; then `stage_bytes` of staged rows.
static size_t block_smem(int fp, int B, bool rows, size_t stage_bytes) {
  return (size_t)STAGE_ROWS * 2 * sizeof(long long) +
         (size_t)fp * B * 5 * sizeof(unsigned) +
         (rows ? (size_t)STAGE_ROWS * sizeof(int) : 0) + stage_bytes;
}

// the most words a row-mode chunk's bytes can span (a skew of up to 3
// bytes), odd
static int rows_stage_words(int f_chunk, int isz) {
  return ((f_chunk * isz + 3 + 3) / 4) | 1;
}

// Features per block and their pitch: whole warps of features (a pitch that
// is a multiple of 32, so adds never meet in a bank) when 32 of them fit,
// else as many as fit; then balanced over F.  smem(f_chunk, fp) is the
// block's shared memory.  Returns 0 when not even one feature fits.
template <class Smem>
static int pick_chunk(int F, size_t optin, Smem smem, int* f_chunk, int* fp) {
  int g = 0;
  while (g < (F + 31) / 32 && smem(32 * (g + 1), 32 * (g + 1)) <= optin) ++g;
  int cap = 32 * g;
  if (g == 0) {
    while (cap < F && smem(cap + 1, cap + 1) <= optin) ++cap;
    if (cap == 0) return 0;
  }
  *f_chunk = balanced(F, cap);
  *fp = g > 0 ? (*f_chunk + 31) / 32 * 32 : *f_chunk;
  return 1;
}

// Set the kernel's shared memory, and size the grid to one wave of
// resident blocks (at most n_items).  info = {smem, grid, f_chunk}.
template <class K>
static int launch_shape(K kernel, size_t smem, int n_sm, long long n_items,
                        int* grid, int f_chunk, int* info) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      HIST_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long g = (long long)per_sm * n_sm;
  *grid = (int)(n_items < g ? (n_items > 0 ? n_items : 1) : g);
  info[0] = (int)smem;
  info[1] = *grid;
  info[2] = f_chunk;
  return 0;
}

extern "C" int dryad_hist_tiles(const void* rec, const void* src,
                                const void* tile_leaf, int n_sel,
                                void* n_used, void* acc, int F, int B,
                                int isz, const void* shift, void* out, int P,
                                int* info, void* stream) {
  const int used = 9 + F * isz;
  const int nvec = (used + 15) / 16;
  const int words_per_row = nvec * 4 + 1;  // odd: conflict-free columns
  const size_t stage = (size_t)STAGE_ROWS * words_per_row * sizeof(uint32_t);
  int optin = 0, n_sm = 0, f_chunk = 0, fp = 0;
  cudaError_t err = device_limits(&optin, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (!pick_chunk(F, optin, [&](int, int p) {
        return block_smem(p, B, false, stage);
      }, &f_chunk, &fp))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (F + f_chunk - 1) / f_chunk;
  const size_t smem = block_smem(fp, B, false, stage);
  int grid = 0;
  int rc = launch_shape(hist_items_kernel, smem, n_sm,
                        (long long)n_sel * n_chunks, &grid, f_chunk, info);
  if (rc != 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  rc = launch_plan_used(nullptr, 0, const_cast<void*>(src), n_sel, n_used,
                        st);
  if (rc != 0) return rc;
  hist_items_kernel<<<grid, HIST_THREADS, smem, st>>>(
      static_cast<const uint8_t*>(rec), static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf), static_cast<const int*>(n_used),
      n_chunks, static_cast<u64*>(acc), P, F, B, isz, f_chunk, fp,
      words_per_row, nvec, static_cast<const int*>(shift));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out == nullptr: accumulate only; the caller converts the int64 sums
  if (out == nullptr) return 0;
  return launch_out(acc, shift, out, (long long)P * 3 * F * B,
                    (long long)F * B, st);
}

extern "C" int dryad_hist_rows(const void* recs, int rec_words, int n_rows,
                               const void* buf, void* src,
                               const void* tile_leaf, int n_sel,
                               void* n_used, void* acc, int F, int B, int isz,
                               const void* shift, void* out, int P, int* info,
                               void* stream) {
  int optin = 0, n_sm = 0, f_chunk = 0, fp = 0;
  cudaError_t err = device_limits(&optin, &n_sm);
  if (err != cudaSuccess) return (int)err;
  auto smem_of = [&](int fc, int p) {
    return block_smem(p, B, true, (size_t)STAGE_ROWS *
                                      rows_stage_words(fc, isz) *
                                      sizeof(uint32_t));
  };
  if (!pick_chunk(F, optin, smem_of, &f_chunk, &fp))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (F + f_chunk - 1) / f_chunk;
  const size_t smem = smem_of(f_chunk, fp);
  int grid = 0;
  int rc = launch_shape(hist_rows_kernel, smem, n_sm,
                        (long long)n_sel * n_chunks, &grid, f_chunk, info);
  if (rc != 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  rc = launch_plan_used(buf, n_rows, src, n_sel, n_used, st);
  if (rc != 0) return rc;
  hist_rows_kernel<<<grid, HIST_THREADS, smem, st>>>(
      static_cast<const uint32_t*>(recs), rec_words, n_rows,
      static_cast<const int*>(buf), static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf), static_cast<const int*>(n_used),
      n_chunks, static_cast<u64*>(acc), P, F, B, isz, f_chunk, fp,
      rows_stage_words(f_chunk, isz), static_cast<const int*>(shift));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out == nullptr: accumulate only; the caller converts the int64 sums
  if (out == nullptr) return 0;
  return launch_out(acc, shift, out, (long long)P * 3 * F * B,
                    (long long)F * B, st);
}
