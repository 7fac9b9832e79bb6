// K1: the diff classify join.
//
// Replaces kart_tpu/ops/diff_kernel.py _classify_mergesort_core with its
// oid fold _fold_oids (the TPU's sort join), and has the semantics of
// _classify_binsearch_core: both sides arrive key-sorted with unique keys,
// so no sort is needed. One thread per row of either side binary-searches
// its key in the other side's first `count` rows and, on a match, compares
// the five oid words directly (no 64-bit fold, so no collision re-check):
//   old row: match ? (same oid ? UNCHANGED : UPDATE) : DELETE
//   new row: match ? (same oid ? UNCHANGED : UPDATE) : INSERT
// Counts [inserts, updates, deletes] are reduced per block (warp shuffles)
// and added with one atomic per block and counter; updates are counted on
// the old side only, as the reference does. Null class pointers select the
// counts-only mode that `-o feature-count` uses.
//
// Bound: bytes. Each side's keys (8 B) and oids (20 B) are read once and one
// class byte is written per row: 58 B a row pair, 580 MB at 10M rows a
// side. The binary search's probes land in a few hot cache lines per warp
// (neighbouring rows search neighbouring keys) and the first levels of the
// search tree stay in L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int8_t kUnchanged = 0, kInsert = 1, kUpdate = 2, kDelete = 3;

__device__ __forceinline__ int64_t lower_bound(const int64_t* keys, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
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

__global__ void __launch_bounds__(kThreads)
classify_kernel(const int64_t* __restrict__ old_keys,
                const int32_t* __restrict__ old_oids, int64_t n_old,
                const int64_t* __restrict__ new_keys,
                const int32_t* __restrict__ new_oids, int64_t n_new,
                int8_t* __restrict__ old_class, int8_t* __restrict__ new_class,
                unsigned long long* __restrict__ counts) {
  unsigned long long ins = 0, upd = 0, del = 0;
  const int64_t total = n_old + n_new;
  for (int64_t i = grid_start(); i < total; i += grid_stride()) {
    const bool is_old = i < n_old;
    const int64_t r = is_old ? i : i - n_old;
    const int64_t key = is_old ? old_keys[r] : new_keys[r];
    const int64_t* other_keys = is_old ? new_keys : old_keys;
    const int64_t n_other = is_old ? n_new : n_old;
    const int64_t j = lower_bound(other_keys, n_other, key);
    int8_t cls;
    if (j < n_other && other_keys[j] == key) {
      const int32_t* own = (is_old ? old_oids : new_oids) + 5 * r;
      const int32_t* other = (is_old ? new_oids : old_oids) + 5 * j;
      cls = oid_equal(own, other) ? kUnchanged : kUpdate;
    } else {
      cls = is_old ? kDelete : kInsert;
    }
    if (is_old) {
      upd += cls == kUpdate;
      del += cls == kDelete;
      if (old_class != nullptr) old_class[r] = cls;
    } else {
      ins += cls == kInsert;
      if (new_class != nullptr) new_class[r] = cls;
    }
  }

  __shared__ unsigned long long part[3][kThreads / 32];
  ins = warp_sum(ins);
  upd = warp_sum(upd);
  del = warp_sum(del);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = ins;
    part[1][warp] = upd;
    part[2][warp] = del;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s[3] = {0, 0, 0};
    for (int w = 0; w < kThreads / 32; w++) {
      s[0] += part[0][w];
      s[1] += part[1][w];
      s[2] += part[2][w];
    }
    for (int c = 0; c < 3; c++) {
      if (s[c]) atomicAdd(counts + c, s[c]);
    }
  }
}

}  // namespace

// counts: int64[3], zeroed by the caller. old_class/new_class: int8 rows or
// null (counts only). Launches on `stream` of `device`; returns the CUDA
// error code of the launch.
extern "C" int kart_classify(const void* old_keys, const void* old_oids,
                             int64_t n_old, const void* new_keys,
                             const void* new_oids, int64_t n_new,
                             void* old_class, void* new_class, void* counts,
                             int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  classify_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(old_keys),
      static_cast<const int32_t*>(old_oids), n_old,
      static_cast<const int64_t*>(new_keys),
      static_cast<const int32_t*>(new_oids), n_new,
      static_cast<int8_t*>(old_class), static_cast<int8_t*>(new_class),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
