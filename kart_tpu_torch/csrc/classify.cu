// K1: the diff classify join, as a merge-path co-rank join.
//
// Replaces kart_tpu/ops/diff_kernel.py:55 _classify_mergesort_core with its
// oid fold _fold_oids (:37), the TPU's sort join. Both sides arrive
// key-sorted with unique keys per side, so the reference's stable sort of
// concat(old, new) by (key, position) is a merge: by key, and on equal keys
// old before new. A key on both sides is an adjacent (old, new) pair in that
// order, and each row's class follows from its partner:
//   old row: match ? (same oid ? UNCHANGED : UPDATE) : DELETE
//   new row: match ? (same oid ? UNCHANGED : UPDATE) : INSERT
// The five oid words are compared directly (no 64-bit fold, so no collision
// re-check). Only the first `count` rows of a side are read: padding rows and
// lengths past count stay invisible. Two null class pointers select the
// counts-only mode that `-o feature-count` uses.
//
// Design. The merged order of n_old + n_new rows is cut into tiles of kTile
// (1024) merged rows.
// 1. corank_kernel, one thread per tile boundary d = t * kTile (clamped to
//    the total), binary-searches its co-rank i, the old rows among the first
//    d merged rows: the largest i with old[i-1] <= new[d-i] (old first on
//    equal keys). Tile t owns old rows [i0, i1) and new rows [j0, j1), where
//    i0, i1 are the co-ranks of its two boundaries and j = d - i.
// 2. classify_tiles, one block per tile, copies the tile's keys into shared
//    memory with one halo row a side, old [i0-1, i1) and new [j0, j1],
//    clamped at 0 and at count. The halo rule: an old row's lower bound in
//    new lies in [j0, j1], and a new row's match in old (its upper bound - 1)
//    in [i0-1, i1-1], so every partner is in shared memory. A pair cut by a
//    tile boundary is compared by both tiles, each for its own row. Each
//    thread takes kPerThread consecutive merged rows of the tile, finds where
//    they start by a co-rank search over the tile's keys (at most kTile + 1)
//    and merges them, which pairs each row with its partner. The oid words
//    are one contiguous run a side (a tile's rows, and its partners), so
//    their copies coalesce. With classes to write they are copied with the
//    keys, so a tile waits on memory once; in counts-only mode only matched
//    rows' oids are copied, after the join, and no class is written. The
//    block compares the five words of each pair, writes the class bytes
//    (coalesced) and reduces the counts [inserts, updates, deletes]: warp
//    shuffles, then one atomic per block and counter. Updates are counted
//    on the old side only, as the reference does. Every copy is cp.async, so
//    all of a thread's copies are in flight at once, and the kernel is held
//    to 32 registers so that 7 blocks (all that shared memory allows) fit an
//    SM: the tile's copies are the only memory in flight, and occupancy is
//    what keeps enough of them flying.
//
// Bound: bytes. Each side's keys (8 B) and oids (20 B) are read once and one
// class byte is written a row: 29 B a row, 580 MB at 10M rows a side. Halo
// rows and co-ranks add a few bytes a tile; the co-rank searches are ~24
// dependent loads for each of the ~20k boundaries, not for each row.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kTile = 1024;          // merged rows per tile
constexpr int kSlots = kTile + 2;    // a tile's rows and one halo row a side
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;  // merged rows a thread walks
constexpr int kBlocksPerSm = 7;  // shared memory allows 7; registers held to it
constexpr int kCorankThreads = 128;
constexpr int8_t kUnchanged = 0, kInsert = 1, kUpdate = 2, kDelete = 3;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kCorankThreads)
corank_kernel(const int64_t* __restrict__ old_keys, int64_t n_old,
              const int64_t* __restrict__ new_keys, int64_t n_new,
              int64_t n_tiles, int64_t* __restrict__ coranks) {
  const int64_t t = grid_start();
  if (t > n_tiles) return;
  const int64_t d = min64(t * kTile, n_old + n_new);
  int64_t lo = d > n_new ? d - n_new : 0;
  int64_t hi = min64(d, n_old);
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (old_keys[mid] <= new_keys[d - mid - 1]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  coranks[t] = lo;
}

__device__ __forceinline__ bool oid_equal(const int32_t* a, const int32_t* b) {
  return a[0] == b[0] && a[1] == b[1] && a[2] == b[2] && a[3] == b[3] &&
         a[4] == b[4];
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
classify_tiles(const int64_t* __restrict__ old_keys,
               const int32_t* __restrict__ old_oids, int64_t n_old,
               const int64_t* __restrict__ new_keys,
               const int32_t* __restrict__ new_oids, int64_t n_new,
               const int64_t* __restrict__ coranks,
               int8_t* __restrict__ old_class, int8_t* __restrict__ new_class,
               unsigned long long* __restrict__ counts) {
  // A tile's rows in shared memory: slots [0, n_os) hold old rows from
  // `os`, slots [n_os, n_s) new rows from `j0`; the tile owns the slots
  // [own_begin, own_end), which leaves out the halo rows.
  __shared__ int64_t s_key[kSlots];
  __shared__ int32_t s_oid[5 * kSlots];
  __shared__ int16_t s_partner[kSlots];  // partner slot, -1 if unmatched
  __shared__ unsigned long long s_part[3][kThreads / 32];

  const bool counts_only = old_class == nullptr && new_class == nullptr;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t d1 = min64(d0 + kTile, n_old + n_new);
  const int64_t i0 = coranks[blockIdx.x], i1 = coranks[blockIdx.x + 1];
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  const int64_t os = i0 > 0 ? i0 - 1 : 0;
  const int64_t je = j1 < n_new ? j1 + 1 : n_new;
  const int n_os = static_cast<int>(i1 - os);            // old slots
  const int n_s = n_os + static_cast<int>(je - j0);      // all slots
  const int own_begin = static_cast<int>(i0 - os);       // skips old halo
  const int own_end = n_os + static_cast<int>(j1 - j0);  // skips new halo
  const int o_words = 5 * n_os;

  for (int r = threadIdx.x; r < n_s; r += kThreads) {
    __pipeline_memcpy_async(
        s_key + r, r < n_os ? old_keys + os + r : new_keys + j0 + (r - n_os),
        sizeof(int64_t));
    s_partner[r] = -1;
  }
  // with classes to write, every slot's oids fly with the keys
  if (!counts_only) {
    for (int w = threadIdx.x; w < 5 * n_s; w += kThreads) {
      __pipeline_memcpy_async(s_oid + w,
                              w < o_words ? old_oids + 5 * os + w
                                          : new_oids + 5 * j0 + (w - o_words),
                              sizeof(int32_t));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // The join, as a merge of the owned rows: thread k takes merged rows
  // [kPerThread * k, kPerThread * (k + 1)) of the tile, finds where they
  // start by a co-rank search over the tile's keys and walks them. A row is
  // emitted with the other side's next row at hand: for an old row that is
  // its lower bound in new (the new halo past the last one), for a new row
  // the old row before it (the old halo before the first one).
  {
    const int na = n_os - own_begin, nb = own_end - n_os;
    const int k0 = min(kPerThread * static_cast<int>(threadIdx.x), na + nb);
    const int k1 = min(k0 + kPerThread, na + nb);
    int lo = max(0, k0 - nb), hi = min(k0, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[own_begin + mid] <= s_key[n_os + k0 - mid - 1]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int a = lo, b = k0 - lo;
    for (int k = k0; k < k1; k++) {
      int r, p;
      if (a < na && (b >= nb || s_key[own_begin + a] <= s_key[n_os + b])) {
        r = own_begin + a++;
        p = n_os + b;
        p = p < n_s && s_key[p] == s_key[r] ? p : -1;
        if (p >= own_end) s_partner[p] = static_cast<int16_t>(r);
      } else {
        r = n_os + b++;
        p = own_begin + a - 1;
        p = p >= 0 && s_key[p] == s_key[r] ? p : -1;
        if (p >= 0 && p < own_begin) s_partner[p] = static_cast<int16_t>(r);
      }
      s_partner[r] = static_cast<int16_t>(p);
    }
  }
  __syncthreads();

  // counts only: the oids of matched rows (owned, and the halo rows they
  // match), and of no other row
  if (counts_only) {
    for (int w = threadIdx.x; w < 5 * n_s; w += kThreads) {
      if (s_partner[w / 5] >= 0) {
        __pipeline_memcpy_async(
            s_oid + w,
            w < o_words ? old_oids + 5 * os + w
                        : new_oids + 5 * j0 + (w - o_words),
            sizeof(int32_t));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  unsigned long long ins = 0, upd = 0, del = 0;
  for (int r = own_begin + threadIdx.x; r < own_end; r += kThreads) {
    const int p = s_partner[r];
    const bool is_old = r < n_os;
    int8_t cls;
    if (p >= 0) {
      cls = oid_equal(s_oid + 5 * r, s_oid + 5 * p) ? kUnchanged : kUpdate;
    } else {
      cls = is_old ? kDelete : kInsert;
    }
    if (is_old) {
      upd += cls == kUpdate;
      del += cls == kDelete;
      if (!counts_only) old_class[os + r] = cls;
    } else {
      ins += cls == kInsert;
      if (!counts_only) new_class[j0 + (r - n_os)] = cls;
    }
  }

  ins = warp_sum(ins);
  upd = warp_sum(upd);
  del = warp_sum(del);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_part[0][warp] = ins;
    s_part[1][warp] = upd;
    s_part[2][warp] = del;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s[3] = {0, 0, 0};
    for (int w = 0; w < kThreads / 32; w++) {
      s[0] += s_part[0][w];
      s[1] += s_part[1][w];
      s[2] += s_part[2][w];
    }
    for (int c = 0; c < 3; c++) {
      if (s[c]) atomicAdd(counts + c, s[c]);
    }
  }
}

int64_t tiles_for(int64_t n_old, int64_t n_new) {
  return (n_old + n_new + kTile - 1) / kTile;
}

cudaError_t launch_coranks(const void* old_keys, int64_t n_old,
                           const void* new_keys, int64_t n_new, void* coranks,
                           cudaStream_t stream) {
  const int64_t n_tiles = tiles_for(n_old, n_new);
  const int64_t blocks = (n_tiles + kCorankThreads) / kCorankThreads;
  corank_kernel<<<static_cast<unsigned>(blocks), kCorankThreads, 0, stream>>>(
      static_cast<const int64_t*>(old_keys), n_old,
      static_cast<const int64_t*>(new_keys), n_new, n_tiles,
      static_cast<int64_t*>(coranks));
  return cudaGetLastError();
}

}  // namespace

// Merged rows per tile; the wrapper checks it against its own constant.
extern "C" int kart_classify_tile_rows() { return kTile; }

// The partition alone: coranks int64[tiles + 1], tiles = ceil((n_old +
// n_new) / kTile), of the first n_old / n_new keys. Launches on `stream` of
// `device`; returns the CUDA error code of the launch.
extern "C" int kart_classify_coranks(const void* old_keys, int64_t n_old,
                                     const void* new_keys, int64_t n_new,
                                     void* coranks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_coranks(old_keys, n_old, new_keys, n_new,
                                         coranks,
                                         static_cast<cudaStream_t>(stream)));
}

// The join, n_old + n_new > 0. coranks: int64[tiles + 1] scratch. counts:
// int64[3], zeroed by the caller. old_class/new_class: int8 rows (null for an
// empty side), or both null for counts only. Launches both kernels on `stream` of `device`; returns the
// CUDA error code of the launches.
extern "C" int kart_classify(const void* old_keys, const void* old_oids,
                             int64_t n_old, const void* new_keys,
                             const void* new_oids, int64_t n_new,
                             void* coranks, void* old_class, void* new_class,
                             void* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_coranks(old_keys, n_old, new_keys, n_new, coranks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  classify_tiles<<<static_cast<unsigned>(tiles_for(n_old, n_new)), kThreads,
                   0, s>>>(
      static_cast<const int64_t*>(old_keys),
      static_cast<const int32_t*>(old_oids), n_old,
      static_cast<const int64_t*>(new_keys),
      static_cast<const int32_t*>(new_oids), n_new,
      static_cast<const int64_t*>(coranks), static_cast<int8_t*>(old_class),
      static_cast<int8_t*>(new_class),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
