// K2: one level's row move on the wired leaf-ordered layout.
//
// Replaces the TPU kernel dryad_tpu/engine/leafperm.py::_perm_kernel
// (launched by permute_records).  For each 512-row source tile, every row
// with pos[tile, side, j] < 512 is copied (128 bytes) to row
// dst_side[tile] + pos[tile, side, j] of the output.
//
// What bounds it on the H100: bytes.  Each live record is read once and
// written once (128 B each way), plus 8 B of pos per row; at 10M rows that
// is ~2.6 GB, ~0.8 ms at 3.35 TB/s.
//
// Design:
// * The TPU kernel compacts a tile with a one-hot product and writes whole
//   512-row windows, zero tails included; that is right only because TPU
//   grid steps run in order.  Blocks here run concurrently and in no order,
//   so the kernel writes only the real rows, into a buffer the wrapper has
//   zeroed.  Real rows have distinct destinations, so the result does not
//   depend on block order and equals the numpy oracle bit for bit.
// * One block per source tile; 8 threads move one 128-byte record as 16-
//   byte vectors, so a warp moves 4 whole records with coalesced accesses.
// * Destinations are clamped to (n_out_tiles-1)*512, as the reference
//   does, so a violated bound misplaces rows inside the buffer, never past.
// Simple and right first: no TMA bulk copies yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_ROWS 512
#define REC_VEC 8  // 128-byte record = 8 x 16 B
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
perm_kernel(const uint4* __restrict__ rec, const int* __restrict__ pos,
            const int* __restrict__ dstl, const int* __restrict__ dstr,
            uint4* __restrict__ out, int cap_rows) {
  const int tile = blockIdx.x;
  const int dl = min(dstl[tile], cap_rows);
  const int dr = min(dstr[tile], cap_rows);
  const int* pl = pos + (size_t)tile * 2 * TILE_ROWS;
  const int* pr = pl + TILE_ROWS;
  const uint4* src = rec + (size_t)tile * TILE_ROWS * REC_VEC;
  for (int e = threadIdx.x; e < TILE_ROWS * REC_VEC; e += THREADS) {
    const int r = e / REC_VEC;
    const int c = e - r * REC_VEC;
    const int a = pl[r];
    const int b = pr[r];
    if (a < TILE_ROWS) {
      out[(size_t)(dl + a) * REC_VEC + c] = src[(size_t)r * REC_VEC + c];
    } else if (b < TILE_ROWS) {
      out[(size_t)(dr + b) * REC_VEC + c] = src[(size_t)r * REC_VEC + c];
    }
  }
}

extern "C" int dryad_permute_records(const void* rec, const void* pos,
                                     const void* dstl, const void* dstr,
                                     void* out, int n_tiles, int cap_rows,
                                     void* stream) {
  if (n_tiles <= 0) return 0;
  perm_kernel<<<n_tiles, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rec), static_cast<const int*>(pos),
      static_cast<const int*>(dstl), static_cast<const int*>(dstr),
      static_cast<uint4*>(out), cap_rows);
  return (int)cudaGetLastError();
}
