// K4: the 3-way merge classify.
//
// Replaces kart_tpu/ops/merge_kernel.py _merge_classify_padded_core with its
// _join: three searchsorted joins of the ancestor, ours and theirs sides onto
// the sorted union of their keys, then the 3-way rule per union key
//     o == t -> keep ours (0); o == a -> take theirs (1);
//     t == a -> keep ours (0); otherwise -> conflict (2)
// where two versions are the same when both are absent or both are present
// with equal oids. Outputs, per union row, the decision byte and the
// presence byte (a=1 | o=2 | t=4), and on the card the counts of
// conflicts and take-theirs rows. Rows at or past union_count get decision
// 0 (their presence is still computed, as the JAX version does).
//
// Design: one thread per union key, three binary searches over the
// key-sorted sides (each over its first `count` keys only, so padding is
// never found and an empty side is never read), the five u32 oid words
// compared directly. The counts reduce in the block (warp shuffles, then
// shared memory) and take one atomic a block per counter.
//
// Bound: bytes. Each side's keys and oids are read once (28 B a row), the
// union once (8 B a row), two bytes written a union row. The searches'
// dependent loads make it latency-bound in practice; a merge-path join like
// K1's is the later redesign.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Side {
  const int64_t* keys;
  const uint32_t* oids;  // (count, 5)
  int64_t count;
};

// -> the row holding `key` in side.keys[0 : count), or -1
__device__ __forceinline__ int64_t find(const Side& s, int64_t key) {
  int64_t lo = 0, hi = s.count;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(s.keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < s.count && __ldg(s.keys + lo) == key) ? lo : -1;
}

__device__ __forceinline__ void load_oid(const Side& s, int64_t row, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = row >= 0 ? __ldg(s.oids + row * 5 + j) : 0u;
}

// both absent, or both present with equal oids
__device__ __forceinline__ bool same(int64_t r1, const uint32_t* w1, int64_t r2,
                                     const uint32_t* w2) {
  if (r1 < 0 || r2 < 0) return r1 < 0 && r2 < 0;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 5; ++j) eq &= w1[j] == w2[j];
  return eq;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
merge_classify_kernel(Side a, Side o, Side t, const int64_t* __restrict__ uni,
                      int64_t n_union, int64_t union_count,
                      int8_t* __restrict__ decision, int8_t* __restrict__ presence,
                      unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long part[2][kThreads / 32];
  const int64_t i = grid_start();
  unsigned long long conflicts = 0, take = 0;
  if (i < n_union) {
    const int64_t key = __ldg(uni + i);
    const int64_t ra = find(a, key), ro = find(o, key), rt = find(t, key);
    uint32_t wa[5], wo[5], wt[5];
    load_oid(a, ra, wa);
    load_oid(o, ro, wo);
    load_oid(t, rt, wt);
    int8_t d = 0;
    if (i < union_count) {
      if (same(ro, wo, rt, wt)) {
        d = 0;
      } else if (same(ro, wo, ra, wa)) {
        d = 1;
      } else if (same(rt, wt, ra, wa)) {
        d = 0;
      } else {
        d = 2;
      }
    }
    decision[i] = d;
    presence[i] = static_cast<int8_t>((ra >= 0) | ((ro >= 0) << 1) | ((rt >= 0) << 2));
    conflicts = d == 2;
    take = d == 1;
  }
  conflicts = warp_sum(conflicts);
  take = warp_sum(take);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = conflicts;
    part[1][warp] = take;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long c = 0, tt = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      c += part[0][w];
      tt += part[1][w];
    }
    if (c) atomicAdd(counts, c);
    if (tt) atomicAdd(counts + 1, tt);
  }
}

}  // namespace

// a/o/t: key-sorted sides (int64 keys, (n, 5) u32 oids), only the first
// *_count rows read; a side with count 0 may pass null pointers. uni: the
// sorted union keys (n_union), rows past union_count are padding.
// decision, presence: n_union bytes each. counts: int64 [conflicts,
// take_theirs], zeroed by the caller. Launches one block even for an empty
// union, so a merge of a dataset is always one launch.
extern "C" int kart_merge_classify(const void* a_keys, const void* a_oids, int64_t a_count,
                                   const void* o_keys, const void* o_oids, int64_t o_count,
                                   const void* t_keys, const void* t_oids, int64_t t_count,
                                   const void* uni, int64_t n_union, int64_t union_count,
                                   void* decision, void* presence, void* counts,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Side a{static_cast<const int64_t*>(a_keys), static_cast<const uint32_t*>(a_oids), a_count};
  const Side o{static_cast<const int64_t*>(o_keys), static_cast<const uint32_t*>(o_oids), o_count};
  const Side t{static_cast<const int64_t*>(t_keys), static_cast<const uint32_t*>(t_oids), t_count};
  const int64_t blocks = n_union > 0 ? (n_union + kThreads - 1) / kThreads : 1;
  merge_classify_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, o, t, static_cast<const int64_t*>(uni), n_union, union_count,
      static_cast<int8_t*>(decision), static_cast<int8_t*>(presence),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
