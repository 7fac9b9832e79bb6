// K5: the spatial join's envelope-overlap test, build tile x probe batch.
//
// Replaces kart_tpu/diff/backend.py _make_sharded_join._step (B9), whose
// predicate is _join_overlap_np: for probe row p and build row b, both
// (w, s, e, n) f32 with a cyclic longitude (e < w wraps),
//     lat   = (b.s <= p.n) & (p.s <= b.n)
//     a     = b.w <= p.e          b = p.w <= b.e
//     bwrap = b.e < b.w           pwrap = p.e < p.w
//     hit   = lat & ((a & b) | (bwrap & pwrap) | ((bwrap ^ pwrap) & (a | b)))
// Comparisons only, written as the reference writes them: a NaN row never
// matches, -0.0 equals 0.0, subnormals compare as they are (no fast math,
// no flush to zero), +-inf orders as IEEE says.
//
// Two modes, one kernel:
//   counts: per probe row its int32 match count, and the int64 pair total
//     (each block sums its rows and adds once with an integer atomic, so the
//     total does not depend on the order of the blocks);
//   pairs: with `offs`, the exclusive scan of the counts, each probe row
//     writes its matches as (probe row, build row) at offs[row], in build
//     row order: the pairs come out in row-major order, np.nonzero's.
//
// Bound: operations. B x T pair tests of ~12 instructions (6 f32 compares,
// ~6 predicate ops and the count); the bytes (16 B a row) are negligible.
// Design: one thread a probe row, its envelope in registers; the build tile
// (up to 4096 rows, 64 KB) is staged through shared memory in chunks of
// kChunk rows (16 KB, under the 48 KB of static shared memory), which every
// thread of the block then reads by broadcast.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;

__device__ __forceinline__ bool overlap(const float4 p, const float4 b) {
  // x=w, y=s, z=e, w=n
  const bool lat = (b.y <= p.w) & (p.y <= b.w);
  const bool a = b.x <= p.z;
  const bool bb = p.x <= b.z;
  const bool bwrap = b.z < b.x;
  const bool pwrap = p.z < p.x;
  const bool both = bwrap & pwrap;
  const bool one = bwrap ^ pwrap;
  return lat & ((a & bb) | both | (one & (a | bb)));
}

__global__ void __launch_bounds__(kThreads)
envelope_join_kernel(const float4* __restrict__ build, int t,
                     const float4* __restrict__ probe, int b,
                     int* __restrict__ counts,
                     unsigned long long* __restrict__ total,
                     const int64_t* __restrict__ offs,
                     int* __restrict__ pair_probe, int* __restrict__ pair_build) {
  __shared__ float4 tile[kChunk];
  __shared__ int warp_sums[kThreads / 32];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < b;
  const float4 p = live ? probe[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  int count = 0;
  int64_t at = (live && offs != nullptr) ? offs[row] : 0;
  for (int c0 = 0; c0 < t; c0 += kChunk) {
    const int n = min(kChunk, t - c0);
    for (int k = threadIdx.x; k < n; k += kThreads) tile[k] = build[c0 + k];
    __syncthreads();
    if (live) {
      if (offs == nullptr) {
        for (int k = 0; k < n; ++k) count += overlap(p, tile[k]);
      } else {
        for (int k = 0; k < n; ++k) {
          if (overlap(p, tile[k])) {
            pair_probe[at] = row;
            pair_build[at] = c0 + k;
            ++at;
          }
        }
      }
    }
    __syncthreads();
  }
  if (offs != nullptr) return;
  if (live) counts[row] = count;
  int s = count;
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block_sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) block_sum += warp_sums[w];
    if (block_sum) atomicAdd(total, static_cast<unsigned long long>(block_sum));
  }
}

}  // namespace

// build: (t, 4) f32, probe: (b, 4) f32, both 16-byte aligned rows.
// Counts mode (offs == null): counts int32 (b,), total one int64 that the
// launcher zeroes first. Pairs mode: offs int64 (b,), the exclusive scan of
// a counts-mode run's counts; pair_probe and pair_build int32 (total,).
extern "C" int kart_envelope_join(const void* build, int t, const void* probe,
                                  int b, void* counts, void* total,
                                  const void* offs, void* pair_probe,
                                  void* pair_build, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offs == nullptr) {
    err = cudaMemsetAsync(total, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (b + kThreads - 1) / kThreads;
  envelope_join_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(build), t, static_cast<const float4*>(probe),
      b, static_cast<int*>(counts), static_cast<unsigned long long*>(total),
      static_cast<const int64_t*>(offs), static_cast<int*>(pair_probe),
      static_cast<int*>(pair_build));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
