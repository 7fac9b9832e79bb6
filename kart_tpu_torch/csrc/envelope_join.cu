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
//   counts: per probe row its int32 match count, and the int64 pair total,
//     both integer sums with atomics, so the order of the blocks cannot
//     change them; with `slice_counts`, also each (probe row, slice) count,
//     row-major;
//   pairs: with `offs`, the exclusive scan of those (row, slice) counts in
//     row-major order, each (row, slice) writes its matches as (probe row,
//     build row) from its own offset, in build-row order: the pairs come out
//     in row-major order, np.nonzero's.
//
// Bound: operations. B x T pair tests; the bytes (16 B a row) are
// negligible. The reference's form is ~12 instructions a test (6 f32
// compares, ~5 predicate ops, the count); with each row's wrap bit known the
// least is 4 compares chained on their predicate and the count's add (lat &
// a & b where neither row wraps, lat & (a | b) where one does, lat alone
// with 2 compares where both do), which is the bound chip_smoke.py's
// k5_bound counts from the inputs. What held the one-thread-a-probe-row
// design to 44% of the 12-instruction count: too few warps at
// the join's batch sizes (a 12,288-row batch was 96 blocks for 132 SMs), one
// shared load for each test, and the build row's wrap bit recomputed by
// every probe row. Design:
//   - a grid over (probe rows x build slices): a block takes kBlockRows probe
//     rows against one slice of the tile, the wrapper (tile_slices) cutting
//     the tile into as many slices as fill every SM many times over,
//     whatever the batch;
//   - register blocking: a thread holds kRows probe rows, so each build row
//     read from shared memory (one broadcast 16-byte load) feeds kRows tests,
//     each summed into its own counter;
//   - a slice is staged once, padded with NaN rows (which never match) to a
//     multiple of 32, and each 32 rows' wrap bits are one ballot word;
//   - where neither a 32-row chunk of the slice nor a thread's probe rows
//     hold a wrapping row (a clear ballot word), the test is the four
//     compares ANDed: (a & b) is the whole longitude term when neither
//     side wraps. Elsewhere the block branches on each build row's wrap bit
//     (the same for every thread), which leaves one 3-input predicate op for
//     the longitude term. On the H100 the kernel's time followed the
//     instructions a test, not its occupancy;
//   - each (row, slice) count goes once to its row with an integer atomic.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // probe rows a thread
constexpr int kBlockRows = kThreads * kRows;
constexpr int kMaxSlice = 1024;  // build rows a slice, at most (16 KB staged)
constexpr unsigned kFull = 0xffffffffu;

// The reference's hit, float4 x=w, y=s, z=e, w=n, for a build row that
// wraps: (a & b) | pwrap | (!pwrap & (a | b)) is a | b | pwrap
__device__ __forceinline__ bool overlap_bwrap(const float4 p, const bool pwrap, const float4 b) {
  const bool a = b.x <= p.z;
  const bool bb = p.x <= b.z;
  return (b.y <= p.w) & (p.y <= b.w) & (a | bb | pwrap);
}

// ... and for a build row that does not wrap: (a & b) | (pwrap & (a | b))
__device__ __forceinline__ bool overlap_no_bwrap(const float4 p, const bool pwrap,
                                                 const float4 b) {
  const bool a = b.x <= p.z;
  const bool bb = p.x <= b.z;
  return (b.y <= p.w) & (p.y <= b.w) & ((a & bb) | (pwrap & (a | bb)));
}

__global__ void __launch_bounds__(kThreads)
envelope_join_kernel(const float4* __restrict__ build, int t, int slice, int n_slices,
                     const float4* __restrict__ probe, int b,
                     int* __restrict__ counts,
                     unsigned long long* __restrict__ total,
                     int* __restrict__ slice_counts,
                     const int64_t* __restrict__ offs,
                     int* __restrict__ pair_probe, int* __restrict__ pair_build) {
  __shared__ float4 tile[kMaxSlice];
  __shared__ unsigned wraps[kMaxSlice / 32];
  __shared__ long long warp_sums[kThreads / 32];
  const int s = blockIdx.x % n_slices;
  const int row_block = blockIdx.x / n_slices;
  const int lo = s * slice;
  const int n = min(slice, t - lo);
  const int n_pad = (n + 31) & ~31;
  const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
  // n_pad is a multiple of 32 and each warp's rows are 32-aligned, so every
  // lane of a warp runs the same iterations and the ballot is whole
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    const float4 e = k < n ? build[lo + k] : nan4;
    tile[k] = e;
    const unsigned w = __ballot_sync(kFull, e.z < e.x);
    if ((k & 31) == 0) wraps[k >> 5] = w;
  }
  __syncthreads();

  const int row0 = row_block * kBlockRows + threadIdx.x;
  float4 p[kRows];
  bool pwrap[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    p[r] = row < b ? probe[row] : nan4;
    pwrap[r] = p[r].z < p[r].x;
  }

  bool any_pwrap = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) any_pwrap |= pwrap[r];

  if (offs == nullptr) {
    int c[kRows] = {};
    for (int k0 = 0; k0 < n_pad; k0 += 32) {
      const unsigned w = wraps[k0 >> 5];
      if ((w | static_cast<unsigned>(any_pwrap)) == 0) {
        // no row of either side wraps: the test is four compares, ANDed
#pragma unroll 8
        for (int kk = 0; kk < 32; ++kk) {
          const float4 e = tile[k0 + kk];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            c[r] += (e.y <= p[r].w) & (p[r].y <= e.w) & (e.x <= p[r].z) & (p[r].x <= e.z);
        }
        continue;
      }
      // the build row's wrap bit is the same for the whole block: branch on
      // it, and the longitude term is one function of (a, b, pwrap)
      for (int kk = 0; kk < 32; ++kk) {
        const float4 e = tile[k0 + kk];
        if ((w >> kk) & 1u) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) c[r] += overlap_bwrap(p[r], pwrap[r], e);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) c[r] += overlap_no_bwrap(p[r], pwrap[r], e);
        }
      }
    }
    long long sum = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r * kThreads;
      if (row < b) {
        if (c[r]) atomicAdd(&counts[row], c[r]);
        if (slice_counts != nullptr)
          slice_counts[static_cast<int64_t>(row) * n_slices + s] = c[r];
      }
      sum += c[r];
    }
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(kFull, sum, d);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long block_sum = 0;
      for (int w = 0; w < kThreads / 32; ++w) block_sum += warp_sums[w];
      if (block_sum) atomicAdd(total, static_cast<unsigned long long>(block_sum));
    }
    return;
  }

  // pairs: only the rows with a match in this slice walk it
  int64_t at[kRows];
  bool need[kRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r * kThreads;
    const int64_t cell = static_cast<int64_t>(row) * n_slices + s;
    need[r] = row < b && slice_counts[cell] > 0;
    at[r] = need[r] ? offs[cell] : 0;
    any |= need[r];
  }
  if (!any) return;
  for (int k0 = 0; k0 < n_pad; k0 += 32) {
    const unsigned w = wraps[k0 >> 5];
    for (int kk = 0; kk < 32; ++kk) {
      const float4 e = tile[k0 + kk];
      const bool bwrap = (w >> kk) & 1u;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (need[r] && (bwrap ? overlap_bwrap(p[r], pwrap[r], e)
                              : overlap_no_bwrap(p[r], pwrap[r], e))) {
          pair_probe[at[r]] = row0 + r * kThreads;
          pair_build[at[r]] = lo + k0 + kk;
          ++at[r];
        }
      }
    }
  }
}

}  // namespace

// build: (t, 4) f32, probe: (b, 4) f32, both 16-byte aligned rows; the tile
// is cut into n_slices slices of `slice` build rows (a multiple of 32, at
// most 1024; the last may be shorter).
// Counts mode (offs == null): counts int32 (b,) and total one int64, both
// zeroed here first; slice_counts, when not null, int32 (b * n_slices,).
// Pairs mode: slice_counts from a counts-mode run with the same slicing and
// offs int64 (b * n_slices,) their exclusive scan; pair_probe and
// pair_build int32 (total,).
extern "C" int kart_envelope_join(const void* build, int t, int slice, int n_slices,
                                  const void* probe, int b, void* counts, void* total,
                                  void* slice_counts, const void* offs, void* pair_probe,
                                  void* pair_build, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (offs == nullptr) {
    err = cudaMemsetAsync(total, 0, sizeof(unsigned long long), st);
    if (err == cudaSuccess && b > 0)
      err = cudaMemsetAsync(counts, 0, static_cast<size_t>(b) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b == 0 || t == 0) return static_cast<int>(cudaGetLastError());
  if (slice <= 0 || slice > kMaxSlice || (slice & 31) || n_slices <= 0 ||
      static_cast<int64_t>(n_slices - 1) * slice >= t ||
      static_cast<int64_t>(n_slices) * slice < t)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>((b + kBlockRows - 1) / kBlockRows) * n_slices;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  envelope_join_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float4*>(build), t, slice, n_slices,
      static_cast<const float4*>(probe), b, static_cast<int*>(counts),
      static_cast<unsigned long long*>(total), static_cast<int*>(slice_counts),
      static_cast<const int64_t*>(offs), static_cast<int*>(pair_probe),
      static_cast<int*>(pair_build));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
