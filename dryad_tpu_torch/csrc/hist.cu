// K1: leaf-segmented histograms straight from 128-byte layout records.
//
// Replaces the TPU kernel dryad_tpu/engine/pallas_hist.py::_hist_kernel
// (launched by _hist_tiles).  Same function, not the TPU mechanics: no
// one-hot product, no bf16 limb split, no feature-major transpose.  Per
// output leaf it sums g*valid, h*valid and valid per (feature, bin) into
// fp32 cells, reading each planned source tile in place (g at byte 0, h at
// 4, valid flag at 8, bins from 9).
//
// What bounds it on the H100: the per-(feature, bin) updates, not the
// bytes.  A 512-row tile is 37 used bytes per row at Higgs' 28 u8
// features (~19 KB) but 14,336 histogram updates, all into shared memory.
//
// Design:
// * Determinism without float atomics.  Each block keeps a private
//   histogram in shared memory, and each feature belongs to exactly one
//   warp, so no two threads ever write one cell.  Inside a warp, 32 rows
//   go at a time: __match_any_sync groups lanes with the same bin, and the
//   group's lowest lane adds the group's values in lane order, then adds
//   that sum to the cell.  The order of every sum is fixed by the data
//   layout alone.
// * Accuracy: g and h sums run in fp64 (shared memory, partials and the
//   cross-block pass) and round to fp32 once.  A fixed-order fp32 sum over
//   10M rows drifts past atol 1e-4 on bins whose sum cancels (measured on
//   the H100 at 2M rows: 1.2e-3); fp64 keeps the result within an ulp of
//   the exact sum.  Counts are fp32 (exact below 2^24).
// * Work items: a block accumulates up to TILES_PER_ITEM consecutive plan
//   tiles of one leaf and writes one partial histogram.  A second kernel
//   sums each leaf's partials in item order, and writes every leaf, so a
//   leaf without live tiles is zero.
// * A block stages each tile's used record bytes in shared memory with an
//   odd word stride, so the 32 lanes reading one byte column hit 32 banks.
// * Features are split into chunks (grid.y) so that one block's
//   histogram (20 B per cell) stays near 100 KB: two blocks fit an SM at
//   Higgs' 28 x 256 (two chunks of 14 features, ~98 KB each with the
//   stage).  Each chunk's block stages the tile again.
// Simple and right first: no TMA, no cp.async pipelining, no tuning yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_ROWS 512
#define REC_WB 128
#define THREADS 256
#define TILES_PER_ITEM 16  // must match engine/hist.py TILES_PER_ITEM

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
  const int nwarps = THREADS / 32;

  for (int i = tid; i < 2 * f_chunk * B; i += THREADS) smem[i] = 0.0;
  for (int i = tid; i < f_chunk * B; i += THREADS) hc[i] = 0.f;

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
    for (int fl = warp; fl < nf; fl += nwarps) {
      const int f = f0 + fl;
      double* hgf = hg + fl * B;
      double* hhf = hh + fl * B;
      float* hcf = hc + fl * B;
      for (int ch = 0; ch < TILE_ROWS / 32; ++ch) {
        const uint8_t* row = sb + (ch * 32 + lane) * row_bytes;
        const int bin = isz == 1 ? (int)row[9 + f]
                                 : (int)row[9 + 2 * f] | ((int)row[10 + 2 * f] << 8);
        const bool live = row[8] == 1 && bin < B;
        const int key = live ? bin : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (live && lane == __ffs(peers) - 1) {
          double sg = 0.0, sh = 0.0;
          unsigned m = peers;
          while (m) {  // fixed order: ascending lane = ascending row
            const int j = __ffs(m) - 1;
            m &= m - 1;
            const float* rj =
                reinterpret_cast<const float*>(sb + (ch * 32 + j) * row_bytes);
            sg += rj[0];
            sh += rj[1];
          }
          hgf[bin] += sg;
          hhf[bin] += sh;
          hcf[bin] += (float)__popc(peers);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  double* dst = partials + (size_t)item * 3 * F * B;
  for (int i = tid; i < 3 * nf * B; i += THREADS) {
    const int plane = i / (nf * B);
    const int rem = i - plane * nf * B;
    dst[(size_t)plane * F * B + (size_t)f0 * B + rem] =
        plane < 2 ? smem[plane * f_chunk * B + rem] : (double)hc[rem];
  }
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
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fb3 = 3 * F * B;
  const size_t total = (size_t)P * fb3;
  hist_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const double*>(partials),
      static_cast<const int*>(leaf_item_start), static_cast<float*>(out), P,
      fb3);
  return (int)cudaGetLastError();
}
