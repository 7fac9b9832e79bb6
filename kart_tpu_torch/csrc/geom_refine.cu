// K6: the query's exact refine, one verdict a candidate pair.
//
// Replaces kart_tpu/diff/backend.py _make_sharded_refine._step (B10) over
// kart_tpu/geom.py seg_pairs_intersect and ray_crossings; the host twin is
// refine_pairs_host, the packer of its slabs device_batch.pack_geom_pairs.
// For pair (a, b) with SA segments of feature a and SB of feature b:
//     seg_any = some (i < SA, j < SB) with segment i touching segment j
//               (the straddle test, or an endpoint on the other segment);
//     a_in_b  = some A segment start with an odd count of B segments that
//               an upward ray from it crosses (the half-open vertex rule
//               (sy0 <= py) != (sy1 <= py) and the exact cross product);
//     b_in_a  = the same the other way;
//     verdict = seg_any | (b is a polygon & a_in_b) | (a is a polygon & b_in_a)
// Coordinates are int32 below 2^25 in magnitude: every difference fits 26
// bits and every product of two differences 52, so the cross products are
// exact as int32 x int32 -> int64 products (no float anywhere).
//
// Bound: operations, sum over pairs of SA*SB segment tests (~58 integer
// instructions each: 16 widening int32 multiplies, 4 int64 subtractions of
// 2 instructions, 8 int64 sign tests of 2, 24 int32 subtractions, the
// predicate logic) plus 2 * SA*SB ray crossings (~14 each).
// Design: one warp a pair (a grid-stride loop over pairs, one launch a
// refine call). Segments are gathered here from each column's flat segment
// table, which lives on the card, so only the pair indices cross the bus;
// the padded slabs of the reference do not exist. The segment test runs
// with the lanes over the flattened SA x SB matrix; each containment test
// with the lanes over the starts of one side, each lane summing the ray
// crossings of its start over every segment of the other side. A warp
// stops a term once some lane found a hit: the OR cannot change after.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kKindPoly = 3;

__device__ __forceinline__ long long cross(int ux, int uy, int vx, int vy) {
  return static_cast<long long>(ux) * vy - static_cast<long long>(uy) * vx;
}

__device__ __forceinline__ bool span(int s0, int s1, int p) {
  return static_cast<long long>(s0 - p) * (s1 - p) <= 0;
}

// geom.seg_pairs_intersect, term for term
__device__ __forceinline__ bool seg_hit(int ax0, int ay0, int ax1, int ay1,
                                        int bx0, int by0, int bx1, int by1) {
  const long long d1 = cross(bx1 - bx0, by1 - by0, ax0 - bx0, ay0 - by0);
  const long long d2 = cross(bx1 - bx0, by1 - by0, ax1 - bx0, ay1 - by0);
  const long long d3 = cross(ax1 - ax0, ay1 - ay0, bx0 - ax0, by0 - ay0);
  const long long d4 = cross(ax1 - ax0, ay1 - ay0, bx1 - ax0, by1 - ay0);
  const bool straddle = ((d1 > 0 && d2 < 0) || (d1 < 0 && d2 > 0)) &&
                        ((d3 > 0 && d4 < 0) || (d3 < 0 && d4 > 0));
  const bool t1 = d1 == 0 && span(bx0, bx1, ax0) && span(by0, by1, ay0);
  const bool t2 = d2 == 0 && span(bx0, bx1, ax1) && span(by0, by1, ay1);
  const bool t3 = d3 == 0 && span(ax0, ax1, bx0) && span(ay0, ay1, by0);
  const bool t4 = d4 == 0 && span(ax0, ax1, bx1) && span(ay0, ay1, by1);
  return straddle || t1 || t2 || t3 || t4;
}

// geom.ray_crossings
__device__ __forceinline__ bool crosses(int px, int py, int sx0, int sy0,
                                        int sx1, int sy1) {
  const bool upward = (sy0 <= py) != (sy1 <= py);
  const long long cr = cross(sx1 - sx0, sy1 - sy0, px - sx0, py - sy0);
  const bool left = (sy1 > sy0 && cr > 0) || (sy1 < sy0 && cr < 0);
  return upward && left;
}

struct Segs {
  const int* x0;
  const int* y0;
  const int* x1;
  const int* y1;
  const int64_t* offs;
  const uint8_t* kinds;
};

// Some start of `pts` (n_pts segments from p0) inside the even-odd rings of
// `ring` (n_ring segments from r0): the lanes take the starts.
__device__ bool any_start_inside(const Segs& pts, int64_t p0, int64_t n_pts,
                                 const Segs& ring, int64_t r0, int64_t n_ring,
                                 int lane) {
  for (int64_t base = 0; base < n_pts; base += 32) {
    const int64_t i = base + lane;
    bool inside = false;
    if (i < n_pts) {
      const int px = pts.x0[p0 + i], py = pts.y0[p0 + i];
      unsigned parity = 0;
      for (int64_t j = r0; j < r0 + n_ring; ++j)
        parity ^= crosses(px, py, ring.x0[j], ring.y0[j], ring.x1[j], ring.y1[j]);
      inside = parity & 1u;
    }
    if (__any_sync(kFull, inside)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
geom_refine_kernel(Segs A, Segs B, const int64_t* __restrict__ ia,
                   const int64_t* __restrict__ ib, int64_t n_pairs,
                   uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = grid_start() >> 5;
  const int64_t n_warps = grid_stride() >> 5;
  for (int64_t p = warp; p < n_pairs; p += n_warps) {
    const int64_t a = ia[p], b = ib[p];
    const int64_t a0 = A.offs[a], sa = A.offs[a + 1] - a0;
    const int64_t b0 = B.offs[b], sb = B.offs[b + 1] - b0;
    const bool a_poly = A.kinds[a] == kKindPoly;
    const bool b_poly = B.kinds[b] == kKindPoly;
    bool hit = false;
    const int64_t cells = sa * sb;
    for (int64_t base = 0; base < cells && !hit; base += 32) {
      const int64_t k = base + lane;
      bool h = false;
      if (k < cells) {
        const int64_t i = a0 + k / sb, j = b0 + k % sb;
        h = seg_hit(A.x0[i], A.y0[i], A.x1[i], A.y1[i],
                    B.x0[j], B.y0[j], B.x1[j], B.y1[j]);
      }
      hit = __any_sync(kFull, h);
    }
    if (!hit && b_poly && sb > 0) hit = any_start_inside(A, a0, sa, B, b0, sb, lane);
    if (!hit && a_poly && sa > 0) hit = any_start_inside(B, b0, sb, A, a0, sa, lane);
    if (lane == 0) out[p] = hit ? 1 : 0;
  }
}

}  // namespace

// Each side: the flat segment table of a vertex column (x0, y0, x1, y1
// int32 (S,), offs int64 (N+1,)) and its kinds uint8 (N,). ia, ib: int64
// (n_pairs,) feature indices into A and B. out: n_pairs bytes.
extern "C" int kart_geom_refine(const void* ax0, const void* ay0,
                                const void* ax1, const void* ay1,
                                const void* a_offs, const void* a_kinds,
                                const void* bx0, const void* by0,
                                const void* bx1, const void* by1,
                                const void* b_offs, const void* b_kinds,
                                const void* ia, const void* ib, int64_t n_pairs,
                                void* out, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Segs A{static_cast<const int*>(ax0), static_cast<const int*>(ay0),
               static_cast<const int*>(ax1), static_cast<const int*>(ay1),
               static_cast<const int64_t*>(a_offs),
               static_cast<const uint8_t*>(a_kinds)};
  const Segs B{static_cast<const int*>(bx0), static_cast<const int*>(by0),
               static_cast<const int*>(bx1), static_cast<const int*>(by1),
               static_cast<const int64_t*>(b_offs),
               static_cast<const uint8_t*>(b_kinds)};
  geom_refine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, static_cast<const int64_t*>(ia), static_cast<const int64_t*>(ib),
      n_pairs, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
