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
// reaches past 32 bits, as most do at the tree's shift), not the bytes: a
// Higgs tile is 37 used bytes a row (~19 KB) but 14,336 pairs.  A warp
// that adds one row at a time, each row a chain of loads, low adds and the
// high adds that wait on them, runs at a sixth of the card's conflict-free
// atomic rate (tools/hist_split.py): so the lanes here batch their pairs.
//
// Design (both modes; the launch plan comes from engine/hist.py):
// * No cell has an owner: cells lie feature-fastest with a pitch that is a
//   multiple of 32 features where 32 fit, so the lanes of a row's features
//   hit 32 banks whatever the bins.  A block holds as many features as fit
//   beside its ring at 20 B per cell, in whole warps of 32: all 28 of Higgs
//   at 256 bins (164 KB of cells), so each tile is staged once.  Row mode
//   at Epsilon's 2000 features takes chunks of 32 (63 chunks).  Where the
//   pitch is not a multiple of 32 (a few features at 1024 bins) the lanes
//   take several rows' features at once: their adds meet at random banks
//   anyway.
// * Work items: each plan tile up to the last live one, times each feature
//   chunk.  The grid is one wave of resident blocks (one per SM), a
//   multiple of the chunks where that idles at most 2% of the SMs; each
//   block takes a balanced contiguous span of the items, so then one
//   chunk over a range of tiles.  A block adds its cells to a global (P,
//   3, F, B) int64 accumulator (global atomics, nonzero cells only)
//   whenever its leaf or chunk changes, so it flushes about once per leaf
//   it meets.  Dead plan tiles are skipped.  A last pass converts the
//   accumulator to f32 (hist_accum.cuh), so every leaf is written and an
//   empty leaf is zero.
// * A ring of stages (two to four, as the plan fits) is filled by
//   asynchronous copies while an earlier stage is added, with one block
//   barrier a tile: layout mode with two 256-row boxes of a 2D TMA tensor
//   map over the records (the used bytes, 9 + F * itemsize rounded to 16),
//   completing on the stage's mbarrier; row mode, which gathers rows by id
//   (TMA cannot), with 16-byte cp.async copies in commit groups of the
//   16-byte aligned span around the bytes a block needs of each row.
// * Each warp owns 16 rows of a tile: its lanes quantise them, then add
//   their pairs four at a time, every low add before any high add
//   (add_pairs).

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_accum.cuh"

#define REC_WB 128
#define ROWS_PER_WARP (STAGE_ROWS / (HIST_THREADS / 32))
#define K1_PAIRS 4  // pairs a lane adds at once
#define K1_MAX_STAGES 4
#define K1_BARRIERS 32   // bytes for the stages' mbarriers

// The launch plan (engine/hist.py::tiles_plan, rows_plan).
struct K1Plan {
  int f_chunk, fp, stages, n_chunks;
  int q;            // a tile's quantised g and h kept in shared memory
  int stage_bytes;  // a stage's bytes: 512 rows at `pitch`
  int pitch;        // a staged row's bytes
};

// Shared memory: the ring, the stages' barriers, each stage's live flags
// (row mode), a tile's quantised g and h (where the plan keeps them: else
// null), then the cells.
struct K1Smem {
  uint8_t* ring;
  u64* full;
  uint8_t* live;  // [stage][row]
  long long *qg, *qh;
  Cells cs;
};

__device__ __forceinline__ K1Smem carve_k1(uint8_t* smem, const K1Plan& pl,
                                           int B) {
  K1Smem s;
  s.ring = smem;
  s.full = reinterpret_cast<u64*>(smem + (size_t)pl.stages * pl.stage_bytes);
  s.live = reinterpret_cast<uint8_t*>(s.full) + K1_BARRIERS;
  uint8_t* at = s.live + K1_MAX_STAGES * STAGE_ROWS;
  s.qg = s.qh = nullptr;
  if (pl.q) {
    s.qg = reinterpret_cast<long long*>(at);
    s.qh = s.qg + STAGE_ROWS;
    at += STAGE_ROWS * 2 * sizeof(long long);
  }
  s.cs = carve_cells(at, pl.fp * B);
  return s;
}

// The block's span [u0, u1) of the n_used * n_chunks work items (chunk
// major): a balanced contiguous span.  Where the grid is a multiple of
// the chunks (the plan makes it so where that idles few SMs), every span
// lies in one chunk, so no block flushes its cells twice for a chunk it
// only began.
struct Span {
  long long u0, u1;
};

__device__ __forceinline__ Span block_span(int n_used, int n_chunks) {
  const long long U = (long long)n_used * n_chunks;
  return {U * blockIdx.x / gridDim.x, U * (blockIdx.x + 1) / gridDim.x};
}

// A work item: its index u (chunk major), its chunk c and plan tile t
// (stepped without dividing: a 64-bit division is a long call on the card).
struct Item {
  long long u;
  int c, t;
};

__device__ __forceinline__ Item item_at(long long u, int n_used) {
  const int c = (int)(u / n_used);
  return {u, c, (int)(u - (long long)c * n_used)};
}

__device__ __forceinline__ Item step(Item it, int n_used) {
  ++it.u;
  if (++it.t == n_used) {
    it.t = 0;
    ++it.c;
  }
  return it;
}

// The first item at or after `it` with a live tile and an output leaf
// (it.u == u1 when none).
__device__ __forceinline__ Item next_live(Item it, long long u1, int n_used,
                                          const int* __restrict__ src,
                                          const int* __restrict__ tl,
                                          int P) {
  for (; it.u < u1; it = step(it, n_used)) {
    if (__ldg(src + it.t) < 0) continue;  // dead plan slot
    const int leaf = __ldg(tl + it.t);
    if (leaf >= 0 && leaf < P) break;  // else no such output leaf: dead
  }
  return it;
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

// This warp's 16 rows of the staged tile: lane i < 16 asks whether row
// r0 + i is live (row.live) and, with Q, quantises its g and h into s.qg,
// s.qh; then the lanes add the rows' (row, feature) pairs, L lanes a row
// (fl fastest), K1_PAIRS at a time, quantising g and h at the pair without
// Q.  row.bins(r) is the first byte of the chunk's bins.
template <bool Q, class Row>
__device__ __forceinline__ void add_warp_rows(const K1Smem& s, int nf,
                                              int fp, int isz, int B,
                                              float sg, float sh, Row row) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * ROWS_PER_WARP;
  bool live = false;
  if (lane < ROWS_PER_WARP) {
    live = row.live(r0 + lane);
    if (Q && live) {
      s.qg[r0 + lane] = quantize(row.g(r0 + lane), sg);
      s.qh[r0 + lane] = quantize(row.h(r0 + lane), sh);
    }
  }
  const unsigned lm = __ballot_sync(FULL_MASK, live);
  __syncwarp();
  if (lm == 0) return;
  int idx[K1_PAIRS];
  long long qg[K1_PAIRS], qh[K1_PAIRS];
  bool on[K1_PAIRS];
  // pair u: (row r, feature fl) of this lane, or off
  auto pair = [&](int u, int r, int fl, bool ok) {
    on[u] = ok && fl < nf && ((lm >> (r - r0)) & 1);
    idx[u] = 0;
    qg[u] = qh[u] = 0;
    if (on[u]) {
      const uint8_t* b = row.bins(r);
      const int bin =
          isz == 1 ? (int)b[fl] : (int)b[2 * fl] | ((int)b[2 * fl + 1] << 8);
      on[u] = bin < B;
      idx[u] = bin * fp + fl;
      qg[u] = Q ? s.qg[r] : quantize(row.g(r), sg);
      qh[u] = Q ? s.qh[r] : quantize(row.h(r), sh);
    }
  };
  if (fp == 32) {  // a row a warp-wide step, a lane a feature
    for (int j = 0; j < ROWS_PER_WARP; j += K1_PAIRS) {
#pragma unroll
      for (int u = 0; u < K1_PAIRS; ++u) pair(u, r0 + j + u, lane, true);
      add_pairs<K1_PAIRS>(s.cs, idx, qg, qh, on);
    }
    return;
  }
  const int L = fp % 32 == 0 ? fp : nf;  // lanes a row
  const int n_pairs = ROWS_PER_WARP * L;
  int j = lane / L, fl = lane - j * L;
  const int dj = 32 / L, dfl = 32 - dj * L;
  for (int p0 = 0; p0 < n_pairs; p0 += 32 * K1_PAIRS) {
#pragma unroll
    for (int u = 0; u < K1_PAIRS; ++u) {
      const bool ok = p0 + 32 * u + lane < n_pairs;
      pair(u, r0 + (ok ? j : 0), fl, ok);
      fl += dfl;
      j += dj;
      if (fl >= L) {
        fl -= L;
        ++j;
      }
    }
    add_pairs<K1_PAIRS>(s.cs, idx, qg, qh, on);
  }
}

// A staged layout record: g, h, the valid flag, the bins.
struct LayoutRow {
  const uint8_t* st;
  int pitch, off;  // off: the chunk's first bin byte
  __device__ bool live(int r) const { return st[r * pitch + 8] == 1; }
  __device__ float g(int r) const {
    return *reinterpret_cast<const float*>(st + r * pitch);
  }
  __device__ float h(int r) const {
    return *reinterpret_cast<const float*>(st + r * pitch + 4);
  }
  __device__ const uint8_t* bins(int r) const { return st + r * pitch + off; }
};

// A staged row of the record table (hist_rows_kernel): flags[r] is 0 for
// an empty plan slot, else 1 + the bytes the staged span starts before the
// row's first needed byte; g and h are in the span (gh null: the whole
// record) or in the stage's (g, h) pairs.
struct RecRow {
  const uint8_t* st;
  const uint8_t* flags;
  const float* gh;
  int pitch;
  __device__ bool live(int r) const { return flags[r] != 0; }
  __device__ const uint8_t* at(int r) const {
    return st + r * pitch + flags[r] - 1;
  }
  __device__ float g(int r) const {
    return gh ? gh[2 * r] : *reinterpret_cast<const float*>(at(r));
  }
  __device__ float h(int r) const {
    return gh ? gh[2 * r + 1] : *reinterpret_cast<const float*>(at(r) + 4);
  }
  __device__ const uint8_t* bins(int r) const { return at(r) + (gh ? 0 : 8); }
};

// The item loop both modes share: issue(it, slot, next) starts the copies
// of item `it` (none for it.u < 0) into ring slot `slot` (next: the item it
// will issue after, or u < 0), wait(k, slot) waits for the k-th item's, and
// add(it, slot) adds it.  Item k + stages - 1 is issued right after the
// barrier that ends item k - 1's adds, so the copies of the next items
// overlap this one's adds.
template <class Issue, class Wait, class Add>
__device__ __forceinline__ void item_loop(const K1Smem& s, const K1Plan& pl,
                                          u64* acc, int n_used, Span sp,
                                          const int* __restrict__ src,
                                          const int* __restrict__ tl, int P,
                                          int F, int B, Issue issue,
                                          Wait wait, Add add) {
  const Item none{-1, 0, 0};
  Item load = next_live(item_at(sp.u0, n_used), sp.u1, n_used, src, tl, P);
  Item it = load;
  // issue the item at `load` (where it is one) and step to the next
  auto issue_next = [&](int k_load) {
    const bool live = load.u < sp.u1;
    const Item nx =
        live ? next_live(step(load, n_used), sp.u1, n_used, src, tl, P)
             : load;
    issue(live && (HIST_SPLIT != 2 || k_load == 0) ? load : none,
          k_load % pl.stages, nx.u < sp.u1 && HIST_SPLIT != 2 ? nx : none);
    load = nx;
  };
  int k_load = 0;
  for (; k_load < pl.stages - 1; ++k_load) issue_next(k_load);
  int cur_leaf = -1, cur_f0 = 0;
  for (int k = 0; it.u < sp.u1; ++k) {
    const int slot = k % pl.stages;
    wait(k, slot);
    __syncthreads();  // item k - 1's adds are done: its slot and the cells
    const int leaf = __ldg(tl + it.t);
    const int f0 = it.c * pl.f_chunk;
    if (cur_leaf >= 0 && (leaf != cur_leaf || f0 != cur_f0)) {
      flush_leaf(s.cs, acc, cur_leaf, cur_f0, pl.fp, F, B);
      __syncthreads();
    }
    cur_leaf = leaf;
    cur_f0 = f0;
    issue_next(k_load++);
    add(it, HIST_SPLIT == 2 ? 0 : slot);
    it = next_live(step(it, n_used), sp.u1, n_used, src, tl, P);
  }
  __syncthreads();
  if (cur_leaf >= 0) flush_leaf(s.cs, acc, cur_leaf, cur_f0, pl.fp, F, B);
}

// 2D TMA load of a box at (c0, c1) of `map`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, u64* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Layout mode.  `rec_map`: the records (rows x 128 bytes) with a box of 256
// rows x pl.pitch bytes.
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_items_kernel(const __grid_constant__ CUtensorMap rec_map,
                  const int* __restrict__ src,
                  const int* __restrict__ tile_leaf,
                  const int* __restrict__ n_used_p, u64* __restrict__ acc,
                  int P, int F, int B, int isz, K1Plan pl,
                  const int* __restrict__ shift) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_used = *n_used_p;
  const Span sp = block_span(n_used, pl.n_chunks);
  if (sp.u0 >= sp.u1) return;
  const K1Smem s = carve_k1(smem, pl, B);
  const float sg = pow2f(shift[0]);
  const float sh = pow2f(shift[1]);
  zero_cells(s.cs, pl.fp * B);
  if (threadIdx.x == 0) {
    for (int k = 0; k < pl.stages; ++k) mbar_init(s.full + k, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int half = (STAGE_ROWS / 2) * pl.pitch;
  auto issue = [&](Item it, int slot, Item) {
    if (threadIdx.x != 0 || it.u < 0) return;
    const int row = __ldg(src + it.t) * STAGE_ROWS;
    uint8_t* st = s.ring + (size_t)slot * pl.stage_bytes;
    mbar_expect_tx(s.full + slot, pl.stage_bytes);
    tma_load_2d(st, &rec_map, 0, row, s.full + slot);
    tma_load_2d(st + half, &rec_map, 0, row + STAGE_ROWS / 2, s.full + slot);
  };
  auto wait = [&](int k, int slot) {
    if (HIST_SPLIT != 2 || k == 0)
      mbar_wait(s.full + slot, (k / pl.stages) & 1);
  };
  auto add = [&](Item it, int slot) {
    const int f0 = it.c * pl.f_chunk;
    const int nf = min(pl.f_chunk, F - f0);
    const uint8_t* st = s.ring + (size_t)slot * pl.stage_bytes;
    const LayoutRow row{st, pl.pitch, 9 + f0 * isz};
    if (pl.q)
      add_warp_rows<true>(s, nf, pl.fp, isz, B, sg, sh, row);
    else
      add_warp_rows<false>(s, nf, pl.fp, isz, B, sg, sh, row);
  };
  item_loop(s, pl, acc, n_used, sp, src, tile_leaf, P, F, B, issue, wait,
            add);
}

// Row mode.  recs: (n_rows, rec_words) u32 words [g, h, bin bytes...];
// buf: plan slots (row ids, n_rows = empty); src[t]: t for a plan tile with
// a live row, else -1.  A staged row is the record's bytes that the block
// needs, copied as the 16-byte aligned span around them (so the copies are
// 16 bytes whatever the record width; the span starts `off` bytes before
// them, kept in the stage's flags as off + 1, 0 for an empty slot): the
// whole record where one chunk holds every feature, else the chunk's bin
// bytes, with g and h copied apart into the stage's (g, h) pairs.  A
// span that would pass the table's end (its last rows) is copied in
// 4-byte words instead.
__global__ void __launch_bounds__(HIST_THREADS, 1)
hist_rows_kernel(const uint32_t* __restrict__ recs, int rec_words,
                 int n_rows, const int* __restrict__ buf,
                 const int* __restrict__ src,
                 const int* __restrict__ tile_leaf,
                 const int* __restrict__ n_used_p, u64* __restrict__ acc,
                 int P, int F, int B, int isz, K1Plan pl,
                 const int* __restrict__ shift) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int n_used = *n_used_p;
  const Span sp = block_span(n_used, pl.n_chunks);
  if (sp.u0 >= sp.u1) return;
  const K1Smem s = carve_k1(smem, pl, B);
  const float sg = pow2f(shift[0]);
  const float sh = pow2f(shift[1]);
  zero_cells(s.cs, pl.fp * B);
  __syncthreads();
  const bool whole = pl.f_chunk >= F;
  const uint8_t* table = reinterpret_cast<const uint8_t*>(recs);
  const uint8_t* table_end = table + (size_t)n_rows * rec_words * 4;
  // this thread's row of a staged tile, and its share of the row's copies;
  // the id of its row in the next item issued, loaded an item ahead
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  long long pre_u = -1;
  int pre_id = 0;
  auto id_of = [&](Item it) {
    return __ldg(buf + (size_t)it.t * STAGE_ROWS + r);
  };
  auto issue = [&](Item it, int slot, Item next) {
    if (it.u >= 0) {
      const int id = it.u == pre_u ? pre_id : id_of(it);
      const bool ok = id >= 0 && id < n_rows;
      int off = 0;
      if (ok) {
        uint8_t* st = s.ring + (size_t)slot * pl.stage_bytes;
        uint8_t* d = st + r * pl.pitch;
        const uint8_t* row = table + (size_t)id * rec_words * 4;
        const int f0 = it.c * pl.f_chunk;
        const uint8_t* a = whole ? row : row + 8 + f0 * isz;
        const uint8_t* e = whole ? row + 4 * rec_words
                                 : a + min(pl.f_chunk, F - f0) * isz;
        const uint8_t* a16 = reinterpret_cast<const uint8_t*>(
            reinterpret_cast<uintptr_t>(a) & ~(uintptr_t)15);
        const uint8_t* e16 = reinterpret_cast<const uint8_t*>(
            (reinterpret_cast<uintptr_t>(e) + 15) & ~(uintptr_t)15);
        off = (int)(a - a16);
        if (e16 <= table_end) {
          for (int v = part; v < (int)(e16 - a16) / 16; v += 2)
            cp_async<16>(d + 16 * v, a16 + 16 * v);
        } else {  // the table's last rows: whole words, within it
          const uint8_t* a4 = reinterpret_cast<const uint8_t*>(
              reinterpret_cast<uintptr_t>(a) & ~(uintptr_t)3);
          const int n4 = (int)((e + 3 - a4) / 4);
          for (int v = part; v < n4; v += 2)
            cp_async<4>(d + (a4 - a16) + 4 * v, a4 + 4 * v);
        }
        if (!whole && part == 1) {  // g and h
          uint8_t* gh = st + STAGE_ROWS * pl.pitch + 8 * r;
          if ((reinterpret_cast<uintptr_t>(row) & 7) == 0) {
            cp_async<8>(gh, row);
          } else {
            cp_async<4>(gh, row);
            cp_async<4>(gh + 4, row + 4);
          }
        }
      }
      if (part == 0) s.live[slot * STAGE_ROWS + r] = ok ? off + 1 : 0;
    }
    cp_async_commit();  // one group an item, empty or not
    pre_u = next.u;
    if (next.u >= 0) pre_id = id_of(next);
  };
  auto wait = [&](int, int) { cp_async_wait(pl.stages - 2); };
  auto add = [&](Item it, int slot) {
    const int f0 = it.c * pl.f_chunk;
    const int nf = min(pl.f_chunk, F - f0);
    const uint8_t* st = s.ring + (size_t)slot * pl.stage_bytes;
    const RecRow row{st, s.live + slot * STAGE_ROWS,
                     whole ? nullptr
                           : reinterpret_cast<const float*>(
                                 st + STAGE_ROWS * pl.pitch),
                     pl.pitch};
    if (pl.q)
      add_warp_rows<true>(s, nf, pl.fp, isz, B, sg, sh, row);
    else
      add_warp_rows<false>(s, nf, pl.fp, isz, B, sg, sh, row);
  };
  item_loop(s, pl, acc, n_used, sp, src, tile_leaf, P, F, B, issue, wait,
            add);
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
    live = __any_sync(FULL_MASK, any);
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

// A stage: 512 rows at `pitch` and, for row mode's chunks, their (g, h).
static K1Plan k1_plan(int F, int f_chunk, int fp, int stages, int pitch,
                      int q, bool gh) {
  K1Plan pl;
  pl.q = q;
  pl.f_chunk = f_chunk;
  pl.fp = fp;
  pl.stages = stages;
  pl.n_chunks = (F + f_chunk - 1) / f_chunk;
  pl.pitch = pitch;
  pl.stage_bytes = STAGE_ROWS * (pitch + (gh ? 8 : 0));
  return pl;
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a record buffer: 2D (rows, 128 bytes), a box of 256
// rows of `pitch` bytes.  A thread keeps the last one it encoded, so calls
// on one buffer (a tree's levels) encode it once.  nullptr on failure.
static const CUtensorMap* record_map(const void* rec, long long n_rows,
                                     int pitch) {
  thread_local CUtensorMap map;
  thread_local const void* map_rec = nullptr;
  thread_local long long map_rows = -1;
  thread_local int map_pitch = -1;
  if (rec == map_rec && n_rows == map_rows && pitch == map_pitch)
    return &map;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return nullptr;
  map_rec = nullptr;
  const cuuint64_t dims[2] = {REC_WB, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {REC_WB};
  const cuuint32_t box[2] = {(cuuint32_t)pitch, STAGE_ROWS / 2};
  const cuuint32_t ones[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(rec),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return nullptr;
  map_rec = rec;
  map_rows = n_rows;
  map_pitch = pitch;
  return &map;
}

// The largest dynamic shared memory one block may take, and the SM count:
// the inputs of the launch plans (engine/hist.py, engine/hist_nat.py).
extern "C" int dryad_device_limits(int* smem_optin, int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// The plans' numbers: features a block and their pitch, ring stages, a
// staged row's bytes, blocks and shared-memory bytes (engine/hist.py).
extern "C" int dryad_hist_tiles(const void* rec, long long n_rec_rows,
                                const void* src, const void* tile_leaf,
                                int n_sel, void* n_used, void* acc, int F,
                                int B, int isz, const void* shift, void* out,
                                int P, int f_chunk, int fp, int stages,
                                int pitch, int q, int grid, int smem,
                                int* info, void* stream) {
  const CUtensorMap* map = record_map(rec, n_rec_rows, pitch);
  if (map == nullptr) return (int)cudaErrorInvalidValue;
  int rc = prepare_launch(hist_items_kernel, (size_t)smem, HIST_THREADS);
  if (rc != 0) return rc;
  info[0] = smem;
  info[1] = grid;
  info[2] = f_chunk;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  rc = launch_plan_used(nullptr, 0, const_cast<void*>(src), n_sel, n_used,
                        st);
  if (rc != 0) return rc;
  hist_items_kernel<<<grid, HIST_THREADS, smem, st>>>(
      *map, static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf),
      static_cast<const int*>(n_used), static_cast<u64*>(acc), P, F, B, isz,
      k1_plan(F, f_chunk, fp, stages, pitch, q, false),
      static_cast<const int*>(shift));
  cudaError_t err = cudaGetLastError();
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
                               const void* shift, void* out, int P,
                               int f_chunk, int fp, int stages, int pitch,
                               int q, int grid, int smem, int* info,
                               void* stream) {
  int rc = prepare_launch(hist_rows_kernel, (size_t)smem, HIST_THREADS);
  if (rc != 0) return rc;
  info[0] = smem;
  info[1] = grid;
  info[2] = f_chunk;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  rc = launch_plan_used(buf, n_rows, src, n_sel, n_used, st);
  if (rc != 0) return rc;
  hist_rows_kernel<<<grid, HIST_THREADS, smem, st>>>(
      static_cast<const uint32_t*>(recs), rec_words, n_rows,
      static_cast<const int*>(buf), static_cast<const int*>(src),
      static_cast<const int*>(tile_leaf), static_cast<const int*>(n_used),
      static_cast<u64*>(acc), P, F, B, isz,
      k1_plan(F, f_chunk, fp, stages, pitch, q, f_chunk < F),
      static_cast<const int*>(shift));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // out == nullptr: accumulate only; the caller converts the int64 sums
  if (out == nullptr) return 0;
  return launch_out(acc, shift, out, (long long)P * 3 * F * B,
                    (long long)F * B, st);
}
