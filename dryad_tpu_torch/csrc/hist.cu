// K1: leaf-segmented histograms of planned 512-row tiles, in two modes.
//
// Replaces the TPU kernel dryad_tpu/engine/pallas_hist.py::_hist_kernel
// (launched by _hist_tiles).  Same function, not the TPU mechanics: no
// one-hot product, no bf16 limb split, no feature-major transpose.  Per
// output leaf it sums g, h and 1 over the live rows per (feature, bin), into
// fp32 cells.
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
// What bounds it on the H100: the per-(feature, bin) updates, not the
// bytes.  A 512-row tile is 37 used bytes per row at Higgs' 28 u8 features
// (~19 KB) but 14,336 histogram updates, all into shared memory.
//
// Design (both modes):
// * Determinism without float atomics: hist_accum.cuh.  Each feature of a
//   block belongs to one warp.
// * Accuracy: g and h sums run in fp64 (shared memory, partials and the
//   cross-block pass) and round to fp32 once.  A fixed-order fp32 sum over
//   10M rows drifts past atol 1e-4 on bins whose sum cancels (measured on
//   the H100 at 2M rows: 1.2e-3); fp64 keeps the result within an ulp of
//   the exact sum.  Counts are fp32 (exact below 2^24).
// * Work items: a block accumulates up to TILES_PER_ITEM consecutive plan
//   tiles of one leaf and writes one partial histogram.  A second kernel
//   sums each leaf's partials in item order, and writes every leaf, so a
//   leaf without live tiles is zero.  Dead plan tiles are skipped.
// * A block stages each tile's used bytes in shared memory with an odd word
//   stride, so the 32 lanes reading one byte column hit 32 banks.
// * Features are split into chunks (grid.y) so that one block's histogram
//   (20 B per cell) stays near 100 KB: two blocks fit an SM at Higgs'
//   28 x 256 (two chunks of 14 features).  Each chunk's block stages the
//   tile again.
// Simple and right first: no TMA, no cp.async pipelining, no tuning yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define TILE_ROWS 512
#define REC_WB 128
#define THREADS 256
#define NWARPS (THREADS / 32)
#define TILES_PER_ITEM 16  // must match engine/hist.py TILES_PER_ITEM

// The block's partial histogram (fp64 g, h and the count) into the item's
// (3, F, B) slice of the partials.
__device__ __forceinline__ void write_partial(const double* smem,
                                              double* partials, int item,
                                              int F, int B, int f0, int nf,
                                              int f_chunk) {
  const float* hc = reinterpret_cast<const float*>(smem + 2 * f_chunk * B);
  double* dst = partials + (size_t)item * 3 * F * B;
  for (int i = threadIdx.x; i < 3 * nf * B; i += blockDim.x) {
    const int plane = i / (nf * B);
    const int rem = i - plane * nf * B;
    dst[(size_t)plane * F * B + (size_t)f0 * B + rem] =
        plane < 2 ? smem[plane * f_chunk * B + rem] : (double)hc[rem];
  }
}

__global__ void __launch_bounds__(THREADS)
hist_items_kernel(const uint8_t* __restrict__ rec,
                  const int* __restrict__ src,
                  const int* __restrict__ tile_leaf,
                  const int* __restrict__ item_first, int n_sel,
                  double* __restrict__ partials, int F, int B, int isz,
                  int f_chunk, int words_per_row, int nvec) {
  extern __shared__ double smem[];
  const int item = blockIdx.x;
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, F - f0);
  const int first = item_first[item];
  if (first >= n_sel) return;  // unused item slot (static bound)
  const int leaf = tile_leaf[first];

  double* hg = smem;
  double* hh = hg + f_chunk * B;
  float* hc = reinterpret_cast<float*>(hh + f_chunk * B);
  uint32_t* stage = reinterpret_cast<uint32_t*>(hc + f_chunk * B);
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(stage);
  const int row_bytes = words_per_row * 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  zero_hist(hg, f_chunk * B);

  for (int k = 0; k < TILES_PER_ITEM; ++k) {
    const int idx = first + k;
    if (idx >= n_sel || tile_leaf[idx] != leaf) break;  // uniform
    const int s = src[idx];
    if (s < 0) continue;  // dead plan slot: contributes nothing
    __syncthreads();      // previous tile's readers are done with stage
    const uint4* tile =
        reinterpret_cast<const uint4*>(rec + (size_t)s * TILE_ROWS * REC_WB);
    for (int e = tid; e < TILE_ROWS * nvec; e += THREADS) {
      const int r = e / nvec;
      const int c = e - r * nvec;
      const uint4 v = __ldg(tile + (size_t)r * (REC_WB / 16) + c);
      uint32_t* d = stage + r * words_per_row + c * 4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    __syncthreads();
    for (int fl = warp; fl < nf; fl += NWARPS) {
      const int f = f0 + fl;
      for (int ch = 0; ch < TILE_ROWS / 32; ++ch) {
        const uint8_t* chunk = sb + ch * 32 * row_bytes;
        const uint8_t* row = chunk + lane * row_bytes;
        const int bin = isz == 1 ? (int)row[9 + f]
                                 : (int)row[9 + 2 * f] | ((int)row[10 + 2 * f] << 8);
        const bool live = row[8] == 1 && bin < B;
        warp_add_chunk(
            live ? fl * B + bin : -1,
            [&](int j, float& g, float& h) {
              const float* rj = reinterpret_cast<const float*>(chunk + j * row_bytes);
              g = rj[0];
              h = rj[1];
            },
            hg, hh, hc);
      }
    }
  }
  __syncthreads();
  write_partial(smem, partials, item, F, B, f0, nf, f_chunk);
}

// Row mode.  recs: (n_rows, rec_words) u32 words [g, h, bin bytes...];
// buf: plan slots (row ids, n_rows = empty); src[i]: plan tile of slot i or
// -1 for a tile without live rows.  stage_words >= the words any feature
// chunk's bytes span, odd.
__global__ void __launch_bounds__(THREADS)
hist_rows_kernel(const uint32_t* __restrict__ recs, int rec_words,
                 int n_rows, const int* __restrict__ buf,
                 const int* __restrict__ src,
                 const int* __restrict__ tile_leaf,
                 const int* __restrict__ item_first, int n_sel,
                 double* __restrict__ partials, int F, int B, int isz,
                 int f_chunk, int stage_words) {
  extern __shared__ double smem[];
  const int item = blockIdx.x;
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, F - f0);
  const int first = item_first[item];
  if (first >= n_sel) return;  // unused item slot (static bound)
  const int leaf = tile_leaf[first];

  double* hg = smem;
  double* hh = hg + f_chunk * B;
  float* hc = reinterpret_cast<float*>(hh + f_chunk * B);
  float* sg = hc + f_chunk * B;
  float* sh = sg + TILE_ROWS;
  int* sid = reinterpret_cast<int*>(sh + TILE_ROWS);
  uint32_t* stage = reinterpret_cast<uint32_t*>(sid + TILE_ROWS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this chunk's bin bytes [b_lo, b_lo + nf*isz) lie in words w_lo.. of the
  // bins, starting `skew` bytes into the first word
  const int b_lo = f0 * isz;
  const int w_lo = b_lo >> 2;
  const int nw = ((b_lo + nf * isz + 3) >> 2) - w_lo;
  const int skew = b_lo - 4 * w_lo;

  zero_hist(hg, f_chunk * B);

  for (int k = 0; k < TILES_PER_ITEM; ++k) {
    const int idx = first + k;
    if (idx >= n_sel || tile_leaf[idx] != leaf) break;  // uniform
    const int s = src[idx];
    if (s < 0) continue;  // tile without live rows
    __syncthreads();      // previous tile's readers are done with stage
    for (int r = tid; r < TILE_ROWS; r += THREADS) {
      const int id = buf[(size_t)s * TILE_ROWS + r];
      const bool ok = id >= 0 && id < n_rows;
      sid[r] = ok ? id : -1;
      const uint32_t* rr = recs + (size_t)(ok ? id : 0) * rec_words;
      sg[r] = ok ? __uint_as_float(__ldg(rr)) : 0.f;
      sh[r] = ok ? __uint_as_float(__ldg(rr + 1)) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < TILE_ROWS * nw; e += THREADS) {
      const int r = e / nw;
      const int c = e - r * nw;
      const int id = sid[r];
      stage[r * stage_words + c] =
          id >= 0 ? __ldg(recs + (size_t)id * rec_words + 2 + w_lo + c) : 0u;
    }
    __syncthreads();
    for (int fl = warp; fl < nf; fl += NWARPS) {
      for (int ch = 0; ch < TILE_ROWS / 32; ++ch) {
        const int r = ch * 32 + lane;
        const uint8_t* rb =
            reinterpret_cast<const uint8_t*>(stage + r * stage_words) + skew;
        const int bin = isz == 1 ? (int)rb[fl]
                                 : (int)rb[2 * fl] | ((int)rb[2 * fl + 1] << 8);
        const bool live = sid[r] >= 0 && bin < B;
        warp_add_chunk(
            live ? fl * B + bin : -1,
            [&](int j, float& g, float& h) {
              g = sg[ch * 32 + j];
              h = sh[ch * 32 + j];
            },
            hg, hh, hc);
      }
    }
  }
  __syncthreads();
  write_partial(smem, partials, item, F, B, f0, nf, f_chunk);
}

// Second pass: each leaf's partials summed in item order (a fixed order).
__global__ void hist_reduce_kernel(const double* __restrict__ partials,
                                   const int* __restrict__ leaf_item_start,
                                   float* __restrict__ out, int P, int fb3) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)P * fb3) return;
  const int leaf = (int)(e / fb3);
  const int k = (int)(e - (size_t)leaf * fb3);
  const int s = leaf_item_start[leaf];
  const int t = leaf_item_start[leaf + 1];
  double acc = 0.0;
  for (int i = s; i < t; ++i) acc += partials[(size_t)i * fb3 + k];
  out[e] = (float)acc;
}

static int launch_reduce(const void* partials, const void* leaf_item_start,
                         void* out, int P, int F, int B, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fb3 = 3 * F * B;
  const size_t total = (size_t)P * fb3;
  hist_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const double*>(partials),
      static_cast<const int*>(leaf_item_start), static_cast<float*>(out), P,
      fb3);
  return (int)cudaGetLastError();
}

extern "C" int dryad_hist_tiles(const void* rec, const void* src,
                                const void* tile_leaf, const void* item_first,
                                int n_sel, int n_items, void* partials, int F,
                                int B, int isz, int f_chunk, int n_chunks,
                                const void* leaf_item_start, void* out, int P,
                                void* stream) {
  const int used = 9 + F * isz;
  const int nvec = (used + 15) / 16;
  const int words_per_row = nvec * 4 + 1;  // odd: conflict-free columns
  const size_t smem = (size_t)f_chunk * B * (2 * sizeof(double) + sizeof(float)) +
                      (size_t)TILE_ROWS * words_per_row * sizeof(uint32_t);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      hist_items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_items, n_chunks);
  hist_items_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(rec), static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf), static_cast<const int*>(item_first),
      n_sel, static_cast<double*>(partials), F, B, isz, f_chunk, words_per_row,
      nvec);
  return launch_reduce(partials, leaf_item_start, out, P, F, B, st);
}

extern "C" int dryad_hist_rows(const void* recs, int rec_words, int n_rows,
                               const void* buf, const void* src,
                               const void* tile_leaf, const void* item_first,
                               int n_sel, int n_items, void* partials, int F,
                               int B, int isz, int f_chunk, int n_chunks,
                               const void* leaf_item_start, void* out, int P,
                               void* stream) {
  // the most words a chunk's bytes can span (a skew of up to 3 bytes)
  const int nw_max = (f_chunk * isz + 3 + 3) / 4;
  const int stage_words = nw_max | 1;  // odd: conflict-free columns
  const size_t smem = (size_t)f_chunk * B * (2 * sizeof(double) + sizeof(float)) +
                      (size_t)TILE_ROWS * (2 * sizeof(float) + sizeof(int)) +
                      (size_t)TILE_ROWS * stage_words * sizeof(uint32_t);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_items, n_chunks);
  hist_rows_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const uint32_t*>(recs), rec_words, n_rows,
      static_cast<const int*>(buf), static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf), static_cast<const int*>(item_first),
      n_sel, static_cast<double*>(partials), F, B, isz, f_chunk, stage_words);
  return launch_reduce(partials, leaf_item_start, out, P, F, B, st);
}
