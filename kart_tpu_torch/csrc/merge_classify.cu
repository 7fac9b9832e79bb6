// K4: the 3-way merge classify, as a key-range tiled merge join that builds
// the union of the keys on the card.
//
// Replaces kart_tpu/ops/merge_kernel.py _merge_classify_padded_core with its
// _join, and the host union (np.union1d) that feeds it: over the sorted
// union of the ancestor (a), ours (o) and theirs (t) keys, each key's
// (present, oid) in every side and the 3-way rule
//     o == t -> keep ours (0); o == a -> take theirs (1);
//     t == a -> keep ours (0); otherwise -> conflict (2)
// where two versions are the same when both are absent or both are present
// with equal oids. Outputs, per union key in key order, the key, the
// decision byte and the presence byte (a=1 | o=2 | t=4), and the counts
// [conflicts, take theirs, union size]. Each side arrives key-sorted with
// unique keys, and only its first `count` rows are read.
//
// Design. The splitters are every S-th key of each side; a slice, the keys
// from one splitter to the next in their merged order, holds at most S rows
// of each side (equal splitters give empty slices).
// 1. tile_plan_kernel ranks each splitter among the other sides' splitters:
//    a block's warps find by 32-way searches which of them lie between its
//    first and last key, those come into shared memory, and each thread
//    counts the ones below its key there. No row is searched yet.
// 2. tile_rows_kernel groups consecutive slices into tiles of at most
//    kRows rows in all, by the slices' approximate row offsets (from the
//    splitter counts, at most 2 S above the exact ones), and finds each
//    tile's first row of each side exactly: a search of the S rows after
//    the last splitter below its key, 8 ways a step.
// 3. merge_tiles_kernel, one block a tile: cp.async copies the tile's keys
//    (three contiguous runs) into shared memory, its oid words in a second
//    group awaited only before they are compared. The tile is cut by the
//    keys of its largest side: each thread takes a run of that side's rows
//    and the other sides' rows in the same key range (their lower bounds of
//    its first key, searched from the proportional row) and merges its three
//    runs in key order, once to count its union keys (a block scan gives
//    its place), once to compare the oid words and write each union key, its
//    decision and presence at the tile's least place, the rows before it.
//    Counts: warp shuffles, then one atomic per block and counter; the
//    tile's union count goes to its group's and its super-group's sums.
// 4. compact_kernel, a warp a tile: its union rows from its least place to
//    its offset, the sums of the super-groups, groups and tiles before it.
//    The offsets are exact sums, so the output does not depend on the order
//    the blocks run in.
// Measured here and left behind (PERF.md, PR 7): one thread a row of
// searches (issue-bound), a single pass with a decoupled look-back for the
// offsets (each look-back walked far back past the ~1000 tiles in flight),
// a count pass before the write pass, and persistent double-buffered blocks.
//
// Bound: bytes. Each side's keys (8 B) and oids (20 B) are read once, and a
// union row writes 8 + 1 + 1 B. The least-place round trip adds 20 B a union
// row that the bound leaves out. S = 128 (kSliceRows): the fastest of 64,
// 128 and 256 at 2M rows a side, within 2% of 256 at 10M.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kSliceRows = 128;  // S: chosen by measurement (PERF.md, PR 7)
constexpr int kPlanThreads = 128;
constexpr int kCompactThreads = 256;

struct Side {
  const int64_t* keys;
  const int32_t* oids;  // (count, 5)
  int64_t count;
};

struct Sides {
  Side s[3];
};

__host__ __device__ __forceinline__ int64_t tiles_of(int64_t count, int64_t tile) {
  return (count + tile - 1) / tile;
}

// -> the first of keys[lo * stride], keys[(lo + 1) * stride], ... below
// hi * stride that is not below `key` (hi if none)
__device__ __forceinline__ int64_t lower_bound(const int64_t* keys, int64_t lo, int64_t hi,
                                               int64_t key, int64_t stride) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid * stride) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// -> the count of keys[0], keys[stride], ..., keys[(m - 1) stride] below
// `key`, by the whole warp: 32 probes a step cut the range 33 ways.
__device__ __forceinline__ int64_t warp_count_below(const int64_t* keys, int64_t m,
                                                    int64_t stride, int64_t key, int lane) {
  int64_t lo = 0, hi = m;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(0xffffffffu, __ldg(keys + p * stride) < key);
    const int c = __popc(below);  // probes below the key: a prefix of the lanes
    const int64_t p_lo = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
    const int64_t p_hi = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
    if (c > 0) lo = p_lo + 1;
    if (c < 32) hi = p_hi;
  }
  const bool below = lo + lane < hi && __ldg(keys + (lo + lane) * stride) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// A splitter's row of the plan: its key, and each side's splitters below
// it (for its own side, its index). Side s's lower bound of the key lies in
// ((c_s - 1) S, min(c_s S, n_s)].
struct PlanRow {
  int64_t key, below[3];
};

// -> side s's lower bound of a plan row's key: a search of the S rows
// after its last splitter below the key
template <int S>
__device__ __forceinline__ int64_t row_bound(const Side& side, int64_t key, int64_t c) {
  if (c == 0) return 0;
  int64_t lo = (c - 1) * S + 1, hi = c * S < side.count ? c * S : side.count;
  // seven probes at once cut the range eight ways, then a binary search
  while (hi - lo > 8) {
    int below = 0;
#pragma unroll
    for (int j = 1; j < 8; ++j) below += __ldg(side.keys + lo + (hi - lo) * j / 8) < key;
    const int64_t new_lo = below > 0 ? lo + (hi - lo) * below / 8 + 1 : lo;
    hi = below < 7 ? lo + (hi - lo) * (below + 1) / 8 : hi;
    lo = new_lo;
  }
  return lower_bound(side.keys, lo, hi, key, 1);
}

// plan: PlanRow [slices], in the merged order of the splitters (equal keys
// ordered a, o, t). Block (x, side): that side's splitters [128 x, 128 (x +
// 1)), one a thread. Its warps first find, by 32-way searches, which of
// each other side's splitters lie between its first and last key; those
// come into shared memory (at most kWindow of them, else each thread
// searches the side's splitters in device memory), and each thread counts
// the ones below its key there.
template <int S>
__global__ void __launch_bounds__(kPlanThreads)
tile_plan_kernel(Sides sd, PlanRow* __restrict__ plan, unsigned long long* __restrict__ counts) {
  constexpr int kWindow = 1024;
  __shared__ int64_t s_window[2][kWindow];
  __shared__ int64_t s_bounds[2][2];  // per other side: splitters below the first and last key
  const int side = blockIdx.y;
  const Side& mine = side == 0 ? sd.s[0] : (side == 1 ? sd.s[1] : sd.s[2]);
  if (counts != nullptr && blockIdx.x == 0 && side == 0 && threadIdx.x < 3) counts[threadIdx.x] = 0;
  const int64_t m_mine = tiles_of(mine.count, S);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kPlanThreads;
  if (i0 >= m_mine) return;  // the whole block
  const int64_t i_last = (i0 + kPlanThreads < m_mine ? i0 + kPlanThreads : m_mine) - 1;
  const int64_t i = i0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w: the other side w / 2, the block's first (w even) or last key
  {
    const int j = warp >> 1;
    const int s2 = j < side ? j : j + 1;
    const Side& other = s2 == 0 ? sd.s[0] : (s2 == 1 ? sd.s[1] : sd.s[2]);
    const int64_t edge = __ldg(mine.keys + ((warp & 1) ? i_last : i0) * S);
    const int64_t c = warp_count_below(other.keys, tiles_of(other.count, S), S, edge, lane);
    if (lane == 0) s_bounds[j][warp & 1] = c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s2 = j < side ? j : j + 1;
    const Side& other = s2 == 0 ? sd.s[0] : (s2 == 1 ? sd.s[1] : sd.s[2]);
    const int64_t lo = s_bounds[j][0], n = s_bounds[j][1] - lo;
    if (n <= kWindow) {
      for (int64_t k = threadIdx.x; k < n; k += kPlanThreads) {
        s_window[j][k] = __ldg(other.keys + (lo + k) * S);
      }
    }
  }
  __syncthreads();
  if (i > i_last) return;
  PlanRow row;
  row.key = __ldg(mine.keys + i * S);
  int64_t pos = i;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s2 = j < side ? j : j + 1;
    const Side& other = s2 == 0 ? sd.s[0] : (s2 == 1 ? sd.s[1] : sd.s[2]);
    const int64_t lo = s_bounds[j][0], n = s_bounds[j][1] - lo;
    int64_t c;
    if (n <= kWindow) {
      int a = 0, b = static_cast<int>(n);
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_window[j][mid] < row.key) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      c = lo + a;
    } else {
      c = lower_bound(other.keys, lo, lo + n, row.key, S);
    }
    // the other side's splitters before this one: those below its key, and
    // on an equal key that of an earlier side
    pos += c;
    if (s2 < side && c * S < other.count && __ldg(other.keys + c * S) == row.key) ++pos;
    if (s2 == 0) row.below[0] = c;
    if (s2 == 1) row.below[1] = c;
    if (s2 == 2) row.below[2] = c;
  }
  if (side == 0) row.below[0] = i;
  if (side == 1) row.below[1] = i;
  if (side == 2) row.below[2] = i;
  plan[pos] = row;
}

// A slice (the keys from one splitter to the next) holds at most S rows of
// each side; a tile, the slices one block takes, at most kRows in all.
template <int S>
struct Tile {
  static constexpr int kRows = 12 * S;  // a's rows, then o's, then t's
  // a tile takes a slice while the approximate rows before it, the sum of
  // min(c_s S, n_s), are within kFill of the tile's first: they are at
  // most 2 S above the exact rows, and a slice adds at most 3 S
  static constexpr int kFill = kRows - 5 * S;
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
};

constexpr int kGroup = 32;  // tiles a group sum covers: one warp's loads

// The scratch the launch needs, in int64 words: the slice plan, the tiles'
// rows, their union counts, the groups' sums, and the tiles' outputs
// before compaction (each tile's at the rows before it, its least place).
struct Scratch {
  PlanRow* plan;         // slices
  int64_t* tile_rows;    // tiles x 6: each side's first row, then its end
  int64_t* tile_union;   // tiles
  int64_t* group_union;  // groups of kGroup tiles: their union counts
  int64_t* super_union;  // supers of kGroup groups: their union counts
  int64_t* keys;         // rows: union keys, tile by tile
  int16_t* marks;        // rows: decision | presence << 8
  int64_t slices, tiles, groups, supers;
};

template <int S>
Scratch carve(const Sides& sd, void* base) {
  Scratch sc;
  const int64_t rows = sd.s[0].count + sd.s[1].count + sd.s[2].count;
  sc.slices = tiles_of(sd.s[0].count, S) + tiles_of(sd.s[1].count, S) + tiles_of(sd.s[2].count, S);
  sc.tiles = tiles_of(rows, Tile<S>::kFill) + 1;
  sc.groups = tiles_of(sc.tiles, kGroup);
  sc.supers = tiles_of(sc.groups, kGroup);
  sc.plan = static_cast<PlanRow*>(base);
  sc.tile_rows = reinterpret_cast<int64_t*>(sc.plan + sc.slices);
  sc.tile_union = sc.tile_rows + 6 * sc.tiles;
  sc.group_union = sc.tile_union + sc.tiles;
  sc.super_union = sc.group_union + sc.groups;
  sc.keys = sc.super_union + sc.supers;
  sc.marks = reinterpret_cast<int16_t*>(sc.keys + rows);
  return sc;
}

template <int S>
int64_t scratch_words(const Sides& sd) {
  const Scratch sc = carve<S>(sd, nullptr);
  const int64_t rows = sd.s[0].count + sd.s[1].count + sd.s[2].count;
  return 4 * sc.slices + 7 * sc.tiles + sc.groups + sc.supers + rows + tiles_of(rows, 4);
}

template <int S>
__device__ __forceinline__ int64_t approx_rows(const Sides& sd, const PlanRow& row) {
  int64_t f = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    f += row.below[s] * S < sd.s[s].count ? row.below[s] * S : sd.s[s].count;
  }
  return f;
}

// One thread a slice k (and one for the end, k = slices): the approximate
// rows before it, f(k), put it in tile ceil(f(k) / kFill), the end in the
// last tile. A tile starts at its first slice, where the tile before it
// ends: that thread searches each side's rows for the slice's key. A
// slice's f is at most 3 S above the last one's, so consecutive slices'
// tiles differ by at most one and every tile starts somewhere. Also clears
// the group sums.
template <int S>
__global__ void __launch_bounds__(kPlanThreads) tile_rows_kernel(Sides sd, Scratch sc) {
  const int64_t k = grid_start();
  if (k < sc.groups) sc.group_union[k] = 0;
  if (k < sc.supers) sc.super_union[k] = 0;
  if (k > sc.slices) return;
  int64_t q;
  if (k == sc.slices) {
    q = sc.tiles - 1;
  } else {
    q = tiles_of(approx_rows<S>(sd, sc.plan[k]), Tile<S>::kFill);
  }
  const int64_t q_prev = k > 0 ? tiles_of(approx_rows<S>(sd, sc.plan[k - 1]), Tile<S>::kFill) : -1;
  if (k == sc.slices) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      sc.tile_rows[6 * q + 3 + s] = sd.s[s].count;
      if (q > q_prev) sc.tile_rows[6 * q + s] = sd.s[s].count;
      if (q > q_prev && q > 0) sc.tile_rows[6 * (q - 1) + 3 + s] = sd.s[s].count;
    }
    return;
  }
  if (q == q_prev) return;
  const PlanRow row = sc.plan[k];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int64_t at = row_bound<S>(sd.s[s], row.key, row.below[s]);
    sc.tile_rows[6 * q + s] = at;
    if (q > 0) sc.tile_rows[6 * (q - 1) + 3 + s] = at;
  }
}

// The plan alone, for checks: out int64 [(slices + 1) * 3], row k each
// side's first row of slice k, the last row the sides' counts.
template <int S>
__global__ void __launch_bounds__(kPlanThreads)
plan_rows_kernel(Sides sd, const PlanRow* __restrict__ plan, int64_t slices,
                 int64_t* __restrict__ out) {
  const int64_t k = grid_start();
  if (k > slices) return;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    out[3 * k + s] = k == slices ? sd.s[s].count : row_bound<S>(sd.s[s], plan[k].key, plan[k].below[s]);
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// -> the first row of keys[0 : n) not below `key`, searched from a guess
// (a tile's sides mostly hold the same keys, so a row's bound lies near its
// proportional place): steps of 1, 2, 4, ... away from the guess, then a
// binary search. Neighbouring threads search neighbouring keys.
__device__ __forceinline__ int search_near(const int64_t* keys, int n, int64_t key, int g) {
  int lo, hi;
  if (g < n && keys[g] < key) {
    lo = g + 1;
    hi = lo;
    int step = 1;
    while (hi < n && keys[hi] < key) {
      lo = hi + 1;
      hi += step;
      step <<= 1;
    }
    if (hi > n) hi = n;
  } else {
    hi = g;
    lo = g - 1;
    int step = 1;
    while (lo >= 0 && keys[lo] >= key) {
      hi = lo;
      lo -= step;
      step <<= 1;
    }
    lo = lo < 0 ? 0 : lo + 1;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The next union key of a thread's run: the least of the three sides'
// next keys, each side that holds it, and that side's row (tile-local).
struct Heads {
  int at[3], end[3];
  __device__ __forceinline__ bool done() const {
    return at[0] >= end[0] && at[1] >= end[1] && at[2] >= end[2];
  }
  // -> the presence bits of the least next key, which goes to `key`; the
  // rows holding it stay in at[] until advance()
  __device__ __forceinline__ int least(const int64_t* keys, int64_t& key) const {
    const bool h0 = at[0] < end[0], h1 = at[1] < end[1], h2 = at[2] < end[2];
    const int64_t k0 = h0 ? keys[at[0]] : 0, k1 = h1 ? keys[at[1]] : 0, k2 = h2 ? keys[at[2]] : 0;
    key = h0 ? k0 : (h1 ? k1 : k2);
    if (h1 && k1 < key) key = k1;
    if (h2 && k2 < key) key = k2;
    return (h0 && k0 == key) | ((h1 && k1 == key) << 1) | ((h2 && k2 == key) << 2);
  }
  __device__ __forceinline__ void advance(int bits) {
    at[0] += bits & 1;
    at[1] += (bits >> 1) & 1;
    at[2] += (bits >> 2) & 1;
  }
};

// One block a tile: the tile's union keys, decisions and presence bits at
// its least place (the rows before it), its union count into its group's
// and super-group's sums. The block cuts its tile by the keys of its largest side: thread t
// takes that side's rows [t p, (t + 1) p), p = ceil(rows / threads), and the
// other sides' rows in the same key range (their lower bounds of its first
// key, searched from the proportional row), and merges its three runs in
// key order, once to count its union keys and once to write them.
template <int S>
__global__ void __launch_bounds__(Tile<S>::kThreads)
merge_tiles_kernel(Sides sd, Scratch sc, unsigned long long* __restrict__ counts) {
  using Shape = Tile<S>;
  constexpr int kRows = Shape::kRows;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kWarps = Shape::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_key = reinterpret_cast<int64_t*>(smem);
  int32_t* s_oid = reinterpret_cast<int32_t*>(s_key + kRows);  // (kRows, 5)
  __shared__ int16_t s_start[3][kThreads + 1];  // each thread's first row of each side
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_counts[2][kWarps];

  const int64_t tile = blockIdx.x;
  const int64_t* rows = sc.tile_rows + 6 * tile;
  int64_t row0[3];
  int b[4];  // side s's rows are [b[s], b[s + 1]) in shared memory
  b[0] = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    row0[s] = rows[s];
    b[s + 1] = b[s] + static_cast<int>(rows[3 + s] - row0[s]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the tile's keys, all three sides in flight at once, then its oid words
  // in a second group, awaited only before they are compared
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int n = b[s + 1] - b[s];
    const int64_t* keys = sd.s[s].keys + row0[s];
    for (int r = threadIdx.x; r < n; r += kThreads) {
      __pipeline_memcpy_async(s_key + b[s] + r, keys + r, sizeof(int64_t));
    }
  }
  __pipeline_commit();
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int n = 5 * (b[s + 1] - b[s]);
    const int32_t* oids = sd.s[s].oids + 5 * row0[s];
    for (int w = threadIdx.x; w < n; w += kThreads) {
      __pipeline_memcpy_async(s_oid + 5 * b[s] + w, oids + w, sizeof(int32_t));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();

  // each thread's runs: cut by the largest side's keys
  {
    const int n0 = b[1], n1 = b[2] - b[1], n2 = b[3] - b[2];
    const int d = n0 >= n1 && n0 >= n2 ? 0 : (n1 >= n2 ? 1 : 2);
    const int nd = d == 0 ? n0 : (d == 1 ? n1 : n2);
    const int per = (nd + kThreads - 1) / kThreads;
    const int i = threadIdx.x * per;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < 3; ++s) s_start[s][kThreads] = static_cast<int16_t>(b[s + 1] - b[s]);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int n = b[s + 1] - b[s];
      int at;
      if (threadIdx.x == 0) {
        at = 0;
      } else if (i >= nd) {
        at = n;
      } else if (s == d) {
        at = i;
      } else {
        const int64_t key = s_key[(d == 0 ? 0 : (d == 1 ? b[1] : b[2])) + i];
        at = search_near(s_key + b[s], n, key,
                         min(n, __float2int_rd(i * (static_cast<float>(n) / nd))));
      }
      s_start[s][threadIdx.x] = static_cast<int16_t>(at);
    }
  }
  __syncthreads();
  Heads h;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    h.at[s] = b[s] + s_start[s][threadIdx.x];
    h.end[s] = b[s] + s_start[s][threadIdx.x + 1];
  }

  // the run's union keys, then the ones before it: a block scan
  int mine = 0;
  {
    Heads c = h;
    while (!c.done()) {
      int64_t key;
      c.advance(c.least(s_key, key));
      ++mine;
    }
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = incl - mine;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  if (threadIdx.x == kThreads - 1) {
    sc.tile_union[tile] = before + mine;
    if (before + mine) {
      const auto n = static_cast<unsigned long long>(before + mine);
      atomicAdd(reinterpret_cast<unsigned long long*>(sc.group_union) + tile / kGroup, n);
      atomicAdd(reinterpret_cast<unsigned long long*>(sc.super_union) + tile / (kGroup * kGroup), n);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // the run again: each union key's oids compared word by word, the 3-way
  // rule and the writes at the tile's least place
  int64_t out = row0[0] + row0[1] + row0[2] + before;
  unsigned long long conflicts = 0, take = 0;
  while (!h.done()) {
    int64_t key;
    const int pres = h.least(s_key, key);
    const bool pa = pres & 1, po = pres & 2, pt = pres & 4;
    const int32_t* wa = s_oid + 5 * h.at[0];
    const int32_t* wo = s_oid + 5 * h.at[1];
    const int32_t* wt = s_oid + 5 * h.at[2];
    bool ot = true, oa = true, ta = true;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int32_t a = pa ? wa[j] : 0, o = po ? wo[j] : 0, t = pt ? wt[j] : 0;
      ot &= o == t;
      oa &= o == a;
      ta &= t == a;
    }
    // the same version: both absent, or both present with equal oids
    int8_t dec;
    if (po == pt && (!po || ot)) {
      dec = 0;
    } else if (po == pa && (!po || oa)) {
      dec = 1;
    } else if (pt == pa && (!pt || ta)) {
      dec = 0;
    } else {
      dec = 2;
    }
    sc.keys[out] = key;
    sc.marks[out] = static_cast<int16_t>(dec | (pres << 8));
    ++out;
    conflicts += dec == 2;
    take += dec == 1;
    h.advance(pres);
  }

  conflicts = warp_sum(conflicts);
  take = warp_sum(take);
  if (lane == 0) {
    s_counts[0][warp] = conflicts;
    s_counts[1][warp] = take;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long c = 0, t = 0;
    for (int w = 0; w < kWarps; ++w) {
      c += s_counts[0][w];
      t += s_counts[1][w];
    }
    if (c) atomicAdd(counts, c);
    if (t) atomicAdd(counts + 1, t);
  }
}

// A warp a tile (kCompactThreads / 32 tiles a block): its union rows from
// its least place to its offset; each lane loads kBatch rows before it
// stores them. The last tile's warp writes the union size.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(Scratch sc, int64_t* __restrict__ uni, int8_t* __restrict__ decision,
               int8_t* __restrict__ presence, unsigned long long* __restrict__ counts) {
  constexpr int kBatch = 8;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (kCompactThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= sc.tiles) return;
  // the union rows before the tile: those of the supers, of the groups in
  // its super and of the tiles in its group before it
  const int64_t group = tile / kGroup, super = group / kGroup;
  unsigned long long v = 0;
  for (int64_t j = lane; j < super; j += 32) v += sc.super_union[j];
  if (super * kGroup + lane < group) v += sc.group_union[super * kGroup + lane];
  if (group * kGroup + lane < tile) v += sc.tile_union[group * kGroup + lane];
  const int64_t to = static_cast<int64_t>(warp_sum(v));
  const int64_t* rows = sc.tile_rows + 6 * tile;
  const int64_t from = rows[0] + rows[1] + rows[2];
  const int n = static_cast<int>(sc.tile_union[tile]);
  if (tile == sc.tiles - 1 && lane == 0) counts[2] = static_cast<unsigned long long>(to + n);
  const int64_t* __restrict__ keys = sc.keys + from;
  const int16_t* __restrict__ marks = sc.marks + from;
  for (int i0 = 0; i0 < n; i0 += 32 * kBatch) {
    int64_t k[kBatch];
    int16_t m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * 32 + lane;
      k[j] = i < n ? keys[i] : 0;
      m[j] = i < n ? marks[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * 32 + lane;
      if (i < n) {
        uni[to + i] = k[j];
        decision[to + i] = static_cast<int8_t>(m[j] & 0xff);
        presence[to + i] = static_cast<int8_t>(m[j] >> 8);
      }
    }
  }
}

Sides make_sides(const void* a_keys, const void* a_oids, int64_t a_count,
                 const void* o_keys, const void* o_oids, int64_t o_count,
                 const void* t_keys, const void* t_oids, int64_t t_count) {
  return Sides{{
      {static_cast<const int64_t*>(a_keys), static_cast<const int32_t*>(a_oids), a_count},
      {static_cast<const int64_t*>(o_keys), static_cast<const int32_t*>(o_oids), o_count},
      {static_cast<const int64_t*>(t_keys), static_cast<const int32_t*>(t_oids), t_count},
  }};
}

template <int S>
cudaError_t launch_plan(const Sides& sd, PlanRow* plan, unsigned long long* counts,
                        cudaStream_t stream) {
  int64_t m = 1;  // the most splitters of a side, at least one block
  for (int s = 0; s < 3; ++s) m = tiles_of(sd.s[s].count, S) > m ? tiles_of(sd.s[s].count, S) : m;
  const dim3 grid(static_cast<unsigned>(tiles_of(m, kPlanThreads)), 3);
  tile_plan_kernel<S><<<grid, kPlanThreads, 0, stream>>>(sd, plan, counts);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_plan_rows(const Sides& sd, void* scratch, int64_t* out, cudaStream_t stream) {
  const Scratch sc = carve<S>(sd, scratch);
  cudaError_t err = launch_plan<S>(sd, sc.plan, nullptr, stream);
  if (err != cudaSuccess) return err;
  plan_rows_kernel<S><<<static_cast<unsigned>(tiles_of(sc.slices + 1, kPlanThreads)),
                        kPlanThreads, 0, stream>>>(sd, sc.plan, sc.slices, out);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_classify(const Sides& sd, void* scratch, void* uni, void* decision,
                            void* presence, void* counts, cudaStream_t stream) {
  using Shape = Tile<S>;
  const Scratch sc = carve<S>(sd, scratch);
  auto* c = static_cast<unsigned long long*>(counts);
  cudaError_t err = launch_plan<S>(sd, sc.plan, c, stream);
  if (err != cudaSuccess) return err;
  const int64_t items = (sc.slices + 1 > sc.groups ? sc.slices + 1 : sc.groups);
  tile_rows_kernel<S><<<static_cast<unsigned>((items + kPlanThreads - 1) / kPlanThreads),
                        kPlanThreads, 0, stream>>>(sd, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t kSmem = Shape::kRows * (8 + 20);
  err = cudaFuncSetAttribute(merge_tiles_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(sc.tiles);
  merge_tiles_kernel<S><<<blocks, Shape::kThreads, kSmem, stream>>>(sd, sc, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  compact_kernel<<<static_cast<unsigned>(tiles_of(sc.tiles, kCompactThreads / 32)),
                   kCompactThreads, 0, stream>>>(sc, static_cast<int64_t*>(uni),
                                                       static_cast<int8_t*>(decision),
                                                       static_cast<int8_t*>(presence), c);
  return cudaGetLastError();
}

}  // namespace

// Rows of each side per slice; the wrapper checks it against its own
// constant.
extern "C" int kart_merge_slice_rows() { return kSliceRows; }

// The plan alone, for checks: plan int64 [(slices + 1) * 3], row k each
// side's first row of slice k (slices: the sum of ceil(count /
// kSliceRows) over the sides), the last row the counts; scratch as for
// kart_merge_classify. Returns the CUDA error code of the launches.
extern "C" int kart_merge_tile_plan(const void* a_keys, int64_t a_count, const void* o_keys,
                                    int64_t o_count, const void* t_keys, int64_t t_count,
                                    void* scratch, void* plan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Sides sd = make_sides(a_keys, nullptr, a_count, o_keys, nullptr, o_count, t_keys,
                              nullptr, t_count);
  return static_cast<int>(launch_plan_rows<kSliceRows>(sd, scratch, static_cast<int64_t*>(plan),
                                                       static_cast<cudaStream_t>(stream)));
}

// int64 words of scratch kart_merge_classify needs.
extern "C" int64_t kart_merge_scratch_words(int64_t a_count, int64_t o_count, int64_t t_count) {
  return scratch_words<kSliceRows>(make_sides(nullptr, nullptr, a_count, nullptr, nullptr,
                                              o_count, nullptr, nullptr, t_count));
}

// a/o/t: key-sorted sides (int64 keys, (n, 5) 32-bit oid words), only the
// first *_count rows read; a side with count 0 may pass null pointers.
// scratch: kart_merge_scratch_words int64 words. uni (int64), decision and
// presence (int8): a_count + o_count + t_count rows each, the first `union
// size` written. counts: int64 [conflicts, take_theirs, union size]. Launches
// the plan, the tiles' rows, the merge and the compaction on `stream` of
// `device` (each with at least one block); returns the CUDA error code of
// the launches.
extern "C" int kart_merge_classify(const void* a_keys, const void* a_oids, int64_t a_count,
                                   const void* o_keys, const void* o_oids, int64_t o_count,
                                   const void* t_keys, const void* t_oids, int64_t t_count,
                                   void* scratch, void* uni, void* decision, void* presence,
                                   void* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Sides sd = make_sides(a_keys, a_oids, a_count, o_keys, o_oids, o_count, t_keys,
                              t_oids, t_count);
  return static_cast<int>(launch_classify<kSliceRows>(sd, scratch, uni, decision, presence,
                                                      counts, static_cast<cudaStream_t>(stream)));
}

KART_ERROR_STRING_EXPORT
