// The deterministic histogram update shared by K1 (hist.cu, both modes) and
// K3 (hist_nat.cu).
//
// A block keeps a private histogram in shared memory: fp64 g and h sums and
// an fp32 count per cell.  Every cell belongs to exactly one warp, so no two
// threads ever write one cell and no float atomics are needed.  A warp takes
// 32 rows at a time, one per lane; lanes whose rows land in the same cell
// form a group (__match_any_sync), and the group's lowest lane adds the
// group's g and h in ascending lane order, then adds those sums and the
// group's size to the cell.  The order of every sum is fixed by the data
// layout alone, so two launches give bitwise-equal partials.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// One warp's update from one 32-row chunk.  `cell` is the lane's cell in
// the block's histogram, or -1 for a row that adds nothing; the caller
// guarantees that no other warp writes a cell this warp writes.
// gh(j, g, h) loads lane j's weights.
template <class GH>
__device__ __forceinline__ void warp_add_chunk(int cell, GH gh, double* hg,
                                               double* hh, float* hc) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (cell >= 0 && lane == __ffs(peers) - 1) {
    double sg = 0.0, sh = 0.0;
    unsigned m = peers;
    while (m) {  // fixed order: ascending lane = ascending row
      const int j = __ffs(m) - 1;
      m &= m - 1;
      float gj, hj;
      gh(j, gj, hj);
      sg += gj;
      sh += hj;
    }
    hg[cell] += sg;
    hh[cell] += sh;
    hc[cell] += (float)__popc(peers);
  }
  __syncwarp();
}

// Zero a block's histogram of n_cells cells (hg, hh, then hc, contiguous).
__device__ __forceinline__ void zero_hist(double* hg, int n_cells) {
  for (int i = threadIdx.x; i < 2 * n_cells; i += blockDim.x) hg[i] = 0.0;
  float* hc = reinterpret_cast<float*>(hg + 2 * n_cells);
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hc[i] = 0.f;
}
