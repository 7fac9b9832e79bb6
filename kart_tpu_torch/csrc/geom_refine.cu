// K6: the query's exact refine, one verdict a candidate pair.
//
// Replaces kart_tpu/diff/backend.py _make_sharded_refine._step (B10) over
// kart_tpu/geom.py seg_pairs_intersect and ray_crossings; the host twin is
// refine_pairs_host, the packer of its slabs device_batch.pack_geom_pairs.
// For pair (a, b) with SA segments of feature a and SB of feature b:
//     seg_any = some (i < SA, j < SB) with segment i touching segment j
//               (the straddle test, or an endpoint on the other segment);
//     a_in_b  = some A segment start with an odd count of B segments that
//               the ray from it crosses (the half-open vertex rule
//               (sy0 <= py) != (sy1 <= py) and the exact cross product);
//     b_in_a  = the same the other way;
//     verdict = seg_any | (b is a polygon & a_in_b) | (a is a polygon & b_in_a)
// Coordinates are int32 below 2^25 in magnitude: every difference fits 26
// bits and every product of two differences 52, so the cross products are
// exact as int32 x int32 -> int64 products (no float anywhere).
//
// Bound: operations. The reference's work is SA*SB segment tests (~58
// integer instructions each) plus 2 * SA*SB ray crossings (~14) for a false
// verdict. This design culls most of it, so its bound is its own work (the
// culls' compares on every cell and start they visit, the terms on what
// survives: chip_smoke.py's k6_work, from the inputs), with the reference's
// beside it. What held the one-warp-a-pair design to 30% of the reference's
// work: a 64-bit division and modulo in every cell, eight global loads a
// cell, idle lanes on short sides (a box is a closed 5-vertex ring, 5
// segments: a box pair kept 25 of 32 lanes busy in the segment term and 5
// in each containment term, each of those walking 5 segments serially), a
// static grid-stride loop that left long pairs for the tail, and the whole
// matrix walked for every false verdict. Design, two kernels a call:
//   - short pairs (both sides at most kGroup segments: the point layer's
//     boxes, a --bbox rectangle against them): kGroup lanes a pair, four
//     pairs a warp, every segment in a register and passed round the group
//     by shuffles, as many steps as the warp's longest short side; this
//     kernel also lists the other pairs;
//   - long pairs, from that list: one warp a pair, taken from an atomic
//     counter, so no long pair waits for the tail. The longer side's
//     segments that survive the box cull sit on the lanes, in registers
//     (gathered first, up to 4 a lane, one where they are few), the other
//     side is staged through shared memory in chunks of kStage and read by
//     broadcast; the starts that survive their cull are gathered the same
//     way. Indices within a pair are 32-bit; no cell divides.
// Exact culls, each proven where it is applied, on each feature's segments'
// box, which the resident table keeps beside the segments:
//   - disjoint boxes (seg_hit_cull): a segment pair whose integer bounding
//     boxes are disjoint does not touch; a segment whose box misses the
//     other feature's box touches none of its segments, and two features
//     whose boxes miss have no segment term at all;
//   - starts that cross nothing (start_may_cross): a start outside the other
//     side's half-open y range, or at or right of its largest x, is crossed
//     by none of its segments and walks no ring; where a feature's box lies
//     so (starts_may_cross), none of its starts is read.
// A start left of the other side's smallest x is NOT culled: it crosses
// every segment whose y range holds it, and that count is even only where
// the rings close, which the kernel does not assume.
// Every term stops once some lane found a hit: the OR cannot change after.

#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kKindPoly = 3;
constexpr int kGroup = 8;  // lanes a short pair, and its longest side
constexpr int kShortThreads = 256;
constexpr int kLongWarps = 4;
constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kStage = 128;  // segments (or starts) a warp stages at once
constexpr int kVote = 16;    // staged segments between two votes on a hit

struct Seg {
  int x0, y0, x1, y1;
};

struct Box {
  int lx, hx, ly, hy;  // low and high x, low and high y, inclusive
};

struct Segs {
  const int* x0;
  const int* y0;
  const int* x1;
  const int* y1;
  const int64_t* offs;
  const uint8_t* kinds;
  const int4* boxes;  // each feature's segments' box: low x, high x, low y, high y
};

__device__ __forceinline__ Seg load_seg(const Segs& t, int64_t i) {
  return {t.x0[i], t.y0[i], t.x1[i], t.y1[i]};
}

__device__ __forceinline__ Box seg_box(const Seg& s) {
  return {min(s.x0, s.x1), max(s.x0, s.x1), min(s.y0, s.y1), max(s.y0, s.y1)};
}

__device__ __forceinline__ Box no_box() { return {INT_MAX, INT_MIN, INT_MAX, INT_MIN}; }

// the empty box (no_box) meets nothing
__device__ __forceinline__ bool meets(const Box& a, const Box& b) {
  return a.lx <= b.hx && b.lx <= a.hx && a.ly <= b.hy && b.ly <= a.hy;
}

// the union of a box over `width` lanes (a power of two up to 32)
__device__ __forceinline__ Box reduce_box(Box b, int width) {
  for (int d = 1; d < width; d <<= 1) {
    b.lx = min(b.lx, __shfl_xor_sync(kFull, b.lx, d));
    b.hx = max(b.hx, __shfl_xor_sync(kFull, b.hx, d));
    b.ly = min(b.ly, __shfl_xor_sync(kFull, b.ly, d));
    b.hy = max(b.hy, __shfl_xor_sync(kFull, b.hy, d));
  }
  return b;
}

__device__ __forceinline__ Seg shfl_seg(const Seg& s, int src) {
  return {__shfl_sync(kFull, s.x0, src), __shfl_sync(kFull, s.y0, src),
          __shfl_sync(kFull, s.x1, src), __shfl_sync(kFull, s.y1, src)};
}

__device__ __forceinline__ long long cross(int ux, int uy, int vx, int vy) {
  return static_cast<long long>(ux) * vy - static_cast<long long>(uy) * vx;
}

__device__ __forceinline__ bool span(int s0, int s1, int p) {
  return static_cast<long long>(s0 - p) * (s1 - p) <= 0;
}

// geom.seg_pairs_intersect, term for term
__device__ __forceinline__ bool seg_hit(const Seg& a, const Seg& b) {
  const long long d1 = cross(b.x1 - b.x0, b.y1 - b.y0, a.x0 - b.x0, a.y0 - b.y0);
  const long long d2 = cross(b.x1 - b.x0, b.y1 - b.y0, a.x1 - b.x0, a.y1 - b.y0);
  const long long d3 = cross(a.x1 - a.x0, a.y1 - a.y0, b.x0 - a.x0, b.y0 - a.y0);
  const long long d4 = cross(a.x1 - a.x0, a.y1 - a.y0, b.x1 - a.x0, b.y1 - a.y0);
  const bool straddle = ((d1 > 0 && d2 < 0) || (d1 < 0 && d2 > 0)) &&
                        ((d3 > 0 && d4 < 0) || (d3 < 0 && d4 > 0));
  const bool t1 = d1 == 0 && span(b.x0, b.x1, a.x0) && span(b.y0, b.y1, a.y0);
  const bool t2 = d2 == 0 && span(b.x0, b.x1, a.x1) && span(b.y0, b.y1, a.y1);
  const bool t3 = d3 == 0 && span(a.x0, a.x1, b.x0) && span(a.y0, a.y1, b.y0);
  const bool t4 = d4 == 0 && span(a.x0, a.x1, b.x1) && span(a.y0, a.y1, b.y1);
  return straddle || t1 || t2 || t3 || t4;
}

// seg_hit after the box cull. Exact: each touch term t1..t4 puts an endpoint
// of one segment inside the other's x span and y span (the two span products
// <= 0), so inside both boxes. A straddle puts each segment's endpoints
// strictly on both sides of the other's line; then neither is a point, the
// lines are not parallel (d1 == d2 when they are), and the one point where
// they cross lies on both segments, so in both boxes. Disjoint boxes: no term.
__device__ __forceinline__ bool seg_hit_cull(const Seg& a, const Box& ab, const Seg& b,
                                             const Box& bb) {
  return meets(ab, bb) && seg_hit(a, b);
}

// geom.ray_crossings
__device__ __forceinline__ bool crosses(int px, int py, const Seg& s) {
  const bool upward = (s.y0 <= py) != (s.y1 <= py);
  const long long cr = cross(s.x1 - s.x0, s.y1 - s.y0, px - s.x0, py - s.y0);
  const bool left = (s.y1 > s.y0 && cr > 0) || (s.y1 < s.y0 && cr < 0);
  return upward && left;
}

// Whether start (px, py) may cross some segment of a side whose segments'
// box is `f`. Exact: `upward` needs min(sy0, sy1) <= py < max(sy0, sy1), so
// f.ly <= py < f.hy. With upward, t = (py - sy0) / (sy1 - sy0) lies in
// [0, 1] and cr = (sy1 - sy0) * (xs - px), xs = sx0 + t * (sx1 - sx0) being
// the segment's x at height py; `left` needs cr of the sign of sy1 - sy0,
// so xs > px, and xs <= max(sx0, sx1) <= f.hx: px < f.hx.
__device__ __forceinline__ bool start_may_cross(int px, int py, const Box& f) {
  return py >= f.ly && py < f.hy && px < f.hx;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// --- short pairs: kGroup lanes a pair ---------------------------------------

__global__ void __launch_bounds__(kShortThreads)
geom_refine_short_kernel(Segs A, Segs B, const int64_t* __restrict__ ia,
                         const int64_t* __restrict__ ib, int64_t n_pairs,
                         int* __restrict__ long_pairs, unsigned* __restrict__ n_long,
                         uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (kGroup - 1);
  const int leader = lane & ~(kGroup - 1);
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kShortThreads + threadIdx.x) / kGroup;
  const bool live = p < n_pairs;
  int64_t a0 = 0, b0 = 0;
  int na = 0, nb = 0;
  bool a_poly = false, b_poly = false;
  if (live) {
    const int64_t a = ia[p], b = ib[p];
    a0 = A.offs[a];
    b0 = B.offs[b];
    na = static_cast<int>(A.offs[a + 1] - a0);
    nb = static_cast<int>(B.offs[b + 1] - b0);
    a_poly = A.kinds[a] == kKindPoly;
    b_poly = B.kinds[b] == kKindPoly;
  }
  const bool is_short = live && na <= kGroup && nb <= kGroup;

  // the other pairs go on the long kernel's list, one atomic a warp
  const bool push = live && !is_short && r == 0;
  const unsigned pushing = __ballot_sync(kFull, push);
  if (pushing) {
    const int first = __ffs(pushing) - 1;
    unsigned base = 0;
    if (lane == first) base = atomicAdd(n_long, static_cast<unsigned>(__popc(pushing)));
    base = __shfl_sync(kFull, base, first);
    if (push) long_pairs[base + __popc(pushing & lanes_below(lane))] = static_cast<int>(p);
  }
  if (!__any_sync(kFull, is_short)) return;

  // lane r holds segment r of each side
  const bool has_a = is_short && r < na;
  const bool has_b = is_short && r < nb;
  const Seg sa = has_a ? load_seg(A, a0 + r) : Seg{0, 0, 0, 0};
  const Seg sb = has_b ? load_seg(B, b0 + r) : Seg{0, 0, 0, 0};
  const Box ba = has_a ? seg_box(sa) : no_box();
  const Box bb = has_b ? seg_box(sb) : no_box();
  const Box fa = reduce_box(ba, kGroup);
  const Box fb = reduce_box(bb, kGroup);
  const bool a_start = has_a && b_poly && start_may_cross(sa.x0, sa.y0, fb);
  const bool b_start = has_b && a_poly && start_may_cross(sb.x0, sb.y0, fa);
  const unsigned group_lanes = ((1u << kGroup) - 1u) << leader;
  bool hit = false;
  unsigned parity_a = 0, parity_b = 0;
  const int steps = __reduce_max_sync(kFull, is_short ? max(na, nb) : 0);
  for (int j = 0; j < steps; ++j) {
    const Seg aj = shfl_seg(sa, leader + j);
    const Seg bj = shfl_seg(sb, leader + j);
    if (has_a && j < nb && seg_hit_cull(sa, ba, bj, seg_box(bj))) hit = true;
    if (a_start && j < nb) parity_a ^= crosses(sa.x0, sa.y0, bj);
    if (b_start && j < na) parity_b ^= crosses(sb.x0, sb.y0, aj);
    // a group with a touch has its verdict: stop once every short group has
    const unsigned touched = __ballot_sync(kFull, hit);
    const bool done = !is_short || (touched & group_lanes);
    if (__all_sync(kFull, done)) break;
  }
  const bool mine = hit || (parity_a & 1u) || (parity_b & 1u);
  const unsigned group = __ballot_sync(kFull, mine) & group_lanes;
  if (is_short && r == 0) out[p] = group ? 1 : 0;
}

// --- long pairs: one warp a pair ---------------------------------------------

struct Stage {
  Seg seg[kStage];
  Box box[kStage];
};

__device__ __forceinline__ Box feature_box(const Segs& t, int64_t i) {
  const int4 b = t.boxes[i];
  return {b.x, b.y, b.z, b.w};
}

// Whether some start of a side whose segments' box is fx may cross some
// segment of a side whose box is fy: every start lies in fx, so none passes
// start_may_cross unless fx reaches fy's half-open y range and left of fy.hx.
__device__ __forceinline__ bool starts_may_cross(const Box& fx, const Box& fy) {
  return fx.hy >= fy.ly && fx.ly < fy.hy && fx.lx < fy.hx;
}

// Stage segments [s0, s0 + n) (n <= kStage) of a side, keeping only those
// whose box meets `keep` when `filter`: -> how many were staged, in order.
// Every lane's loads are issued before the first store, so a chunk costs
// one trip to memory.
__device__ int stage_segs(Stage& st, const Segs& t, int64_t s0, int n, bool filter,
                          const Box& keep, int lane) {
  Seg s[kStage / 32];
#pragma unroll
  for (int u = 0; u < kStage / 32; ++u) {
    const int k = u * 32 + lane;
    s[u] = k < n ? load_seg(t, s0 + k) : Seg{0, 0, 0, 0};
  }
  __syncwarp();  // the warp is done reading the previous chunk
  int staged = 0;
#pragma unroll
  for (int u = 0; u < kStage / 32; ++u) {
    const Box b = seg_box(s[u]);
    const bool ok = u * 32 + lane < n && (!filter || meets(b, keep));
    const unsigned kept = __ballot_sync(kFull, ok);
    if (ok) {
      const int at = staged + __popc(kept & lanes_below(lane));
      st.seg[at] = s[u];
      st.box[at] = b;
    }
    staged += __popc(kept);
  }
  __syncwarp();
  return staged;
}

// Append the item of each lane with `keep` to `buf` after its `n` items, in
// lane order. -> the new count.
__device__ __forceinline__ int append(Stage& buf, int n, bool keep, const Seg& s, const Box& b,
                                      int lane) {
  const unsigned kept = __ballot_sync(kFull, keep);
  if (keep) {
    const int at = n + __popc(kept & lanes_below(lane));
    buf.seg[at] = s;
    buf.box[at] = b;
  }
  return n + __popc(kept);
}

// Some of the n (<= 32 * kR) lane segments in `buf` touching some segment of
// side S, staged in chunks; S's segments whose box misses fl (the lane
// side's box) are not staged.
template <int kR, bool kLIsA>
__device__ bool lane_segs_hit(Stage& st, const Stage& buf, int n, const Box& fl, const Segs& S,
                              int64_t s0, int ns, int lane) {
  Seg ls[kR];
  Box lb[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = r * 32 + lane;
    ls[r] = i < n ? buf.seg[i] : Seg{0, 0, 0, 0};
    lb[r] = i < n ? buf.box[i] : no_box();  // the empty box meets nothing
  }
  for (int sc = 0; sc < ns; sc += kStage) {
    const int staged = stage_segs(st, S, s0 + sc, min(kStage, ns - sc), true, fl, lane);
    bool hit = false;
    for (int k0 = 0; k0 < staged; k0 += kVote) {
      for (int k = k0; k < min(k0 + kVote, staged); ++k) {
        const Seg s = st.seg[k];
        const Box sb = st.box[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          hit |= kLIsA ? seg_hit_cull(ls[r], lb[r], s, sb) : seg_hit_cull(s, sb, ls[r], lb[r]);
        }
      }
      if (__any_sync(kFull, hit)) return true;
    }
  }
  return false;
}

// seg_any of a pair: the longer side L on the lanes, the other side S staged
// (kLIsA: L is side A, whose segments come first in seg_hit). A lane segment
// whose box misses S's box, and an S segment whose box misses L's box,
// touch nothing of the other side (seg_hit_cull) and are skipped: the live
// lane segments are gathered into `buf` first, so that the lanes hold only
// those, one a lane where they are few.
template <bool kLIsA>
__device__ bool any_segment_hit(Stage& st, Stage& buf, const Segs& L, int64_t l0, int nl,
                                const Box& fl, const Segs& S, int64_t s0, int ns, const Box& fs,
                                int lane) {
  for (int k0 = 0; k0 < nl; k0 += kStage) {
    Seg s[kStage / 32];
#pragma unroll
    for (int u = 0; u < kStage / 32; ++u) {
      const int k = k0 + u * 32 + lane;
      s[u] = k < nl ? load_seg(L, l0 + k) : Seg{0, 0, 0, 0};
    }
    __syncwarp();  // buf is read before it is refilled
    int n = 0;
#pragma unroll
    for (int u = 0; u < kStage / 32; ++u) {
      const Box b = seg_box(s[u]);
      n = append(buf, n, k0 + u * 32 + lane < nl && meets(b, fs), s[u], b, lane);
    }
    if (n == 0) continue;
    __syncwarp();
    const bool hit = n <= 32 ? lane_segs_hit<1, kLIsA>(st, buf, n, fl, S, s0, ns, lane)
                             : lane_segs_hit<kStage / 32, kLIsA>(st, buf, n, fl, S, s0, ns, lane);
    if (hit) return true;
  }
  return false;
}

// Some of the n (<= 32 * kR) starts in `buf` (x0, y0 of each entry) inside
// the even-odd rings of side Y, staged in chunks.
template <int kR>
__device__ bool starts_inside(Stage& st, const Stage& buf, int n, const Segs& Y, int64_t y0,
                              int ny, const Box& fy, int lane) {
  int px[kR], py[kR];
  bool live[kR];
  unsigned parity[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = r * 32 + lane;
    live[r] = i < n;
    px[r] = live[r] ? buf.seg[i].x0 : 0;
    py[r] = live[r] ? buf.seg[i].y0 : 0;
    parity[r] = 0;
  }
  for (int sc = 0; sc < ny; sc += kStage) {
    const int staged = stage_segs(st, Y, y0 + sc, min(kStage, ny - sc), false, fy, lane);
    for (int k = 0; k < staged; ++k) {
      const Seg s = st.seg[k];
      // the half-open y test first: only a segment it holds needs the product
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if ((s.y0 <= py[r]) != (s.y1 <= py[r])) parity[r] ^= crosses(px[r], py[r], s);
    }
  }
  bool inside = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) inside |= live[r] && (parity[r] & 1u);
  return __any_sync(kFull, inside);
}

// Some start of side X inside the even-odd rings of side Y, whose segments'
// box is fy. Starts that cross nothing are culled (start_may_cross); the
// others are gathered into `buf` and walk Y's rings, one a lane where they
// are few.
__device__ bool any_start_inside(Stage& st, Stage& buf, const Segs& X, int64_t x0, int nx,
                                 const Segs& Y, int64_t y0, int ny, const Box& fy, int lane) {
  for (int k0 = 0; k0 < nx; k0 += kStage) {
    Seg s[kStage / 32];
#pragma unroll
    for (int u = 0; u < kStage / 32; ++u) {
      const int k = k0 + u * 32 + lane;
      s[u] = Seg{0, 0, 0, 0};
      if (k < nx) {
        s[u].x0 = X.x0[x0 + k];
        s[u].y0 = X.y0[x0 + k];
      }
    }
    __syncwarp();  // buf is read before it is refilled
    int n = 0;
#pragma unroll
    for (int u = 0; u < kStage / 32; ++u) {
      const bool keep = k0 + u * 32 + lane < nx && start_may_cross(s[u].x0, s[u].y0, fy);
      n = append(buf, n, keep, s[u], no_box(), lane);
    }
    if (n == 0) continue;
    __syncwarp();
    const bool inside = n <= 32 ? starts_inside<1>(st, buf, n, Y, y0, ny, fy, lane)
                                : starts_inside<kStage / 32>(st, buf, n, Y, y0, ny, fy, lane);
    if (inside) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kLongThreads)
geom_refine_long_kernel(Segs A, Segs B, const int64_t* __restrict__ ia,
                        const int64_t* __restrict__ ib, const int* __restrict__ long_pairs,
                        const unsigned* __restrict__ n_long, unsigned* __restrict__ next,
                        uint8_t* __restrict__ out) {
  __shared__ Stage stages[kLongWarps][2];
  Stage& st = stages[threadIdx.x >> 5][0];   // the other side's segments
  Stage& buf = stages[threadIdx.x >> 5][1];  // the lane side's live items
  const int lane = threadIdx.x & 31;
  const unsigned total = *n_long;
  while (true) {
    // past the list's end the counter is only read, not bumped
    unsigned i = total;
    if (lane == 0 && *static_cast<volatile unsigned*>(next) < total) i = atomicAdd(next, 1u);
    i = __shfl_sync(kFull, i, 0);
    if (i >= total) return;
    const int64_t p = long_pairs[i];
    const int64_t a = ia[p], b = ib[p];
    const int64_t a0 = A.offs[a], b0 = B.offs[b];
    const int na = static_cast<int>(A.offs[a + 1] - a0);
    const int nb = static_cast<int>(B.offs[b + 1] - b0);
    const Box fa = feature_box(A, a), fb = feature_box(B, b);
    bool hit = false;
    if (meets(fa, fb)) {
      hit = na >= nb ? any_segment_hit<true>(st, buf, A, a0, na, fa, B, b0, nb, fb, lane)
                     : any_segment_hit<false>(st, buf, B, b0, nb, fb, A, a0, na, fa, lane);
    }
    if (!hit && B.kinds[b] == kKindPoly && starts_may_cross(fa, fb))
      hit = any_start_inside(st, buf, A, a0, na, B, b0, nb, fb, lane);
    if (!hit && A.kinds[a] == kKindPoly && starts_may_cross(fb, fa))
      hit = any_start_inside(st, buf, B, b0, nb, A, a0, na, fa, lane);
    if (lane == 0) out[p] = hit ? 1 : 0;
  }
}

// Blocks of the long kernel resident on `device` at once (its SMs times the
// blocks an SM holds), queried on a device's first call and kept. -> 0 and
// `*out`, or the CUDA error.
int long_blocks_resident(int device, int64_t* out) {
  constexpr int kDevices = 64;
  static std::atomic<int64_t> cache[kDevices];
  if (device >= 0 && device < kDevices) {
    *out = cache[device].load(std::memory_order_relaxed);
    if (*out > 0) return 0;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, geom_refine_long_kernel,
                                                        kLongThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < kDevices) cache[device].store(*out, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// Each side: the flat segment table of a vertex column (x0, y0, x1, y1
// int32 (S,), offs int64 (N+1,)), its kinds uint8 (N,) and its features'
// boxes int32 (N, 4), 16-byte aligned; a feature holds fewer than 2^31
// segments. ia, ib: int64 (n_pairs,) feature indices into
// A and B, n_pairs < 2^31. out: n_pairs bytes. scratch: int32 (n_pairs + 2,),
// the long pairs' list and two counters. may_long: 0 when no feature of
// either side holds more than kGroup segments (no long kernel then).
extern "C" int kart_geom_refine(const void* ax0, const void* ay0,
                                const void* ax1, const void* ay1,
                                const void* a_offs, const void* a_kinds, const void* a_boxes,
                                const void* bx0, const void* by0,
                                const void* bx1, const void* by1,
                                const void* b_offs, const void* b_kinds, const void* b_boxes,
                                const void* ia, const void* ib, int64_t n_pairs,
                                void* out, void* scratch, int may_long, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs <= 0) return static_cast<int>(cudaGetLastError());
  if (n_pairs >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* long_pairs = static_cast<int*>(scratch);
  unsigned* counters = reinterpret_cast<unsigned*>(long_pairs + n_pairs);
  if (may_long) {
    err = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Segs A{static_cast<const int*>(ax0), static_cast<const int*>(ay0),
               static_cast<const int*>(ax1), static_cast<const int*>(ay1),
               static_cast<const int64_t*>(a_offs),
               static_cast<const uint8_t*>(a_kinds), static_cast<const int4*>(a_boxes)};
  const Segs B{static_cast<const int*>(bx0), static_cast<const int*>(by0),
               static_cast<const int*>(bx1), static_cast<const int*>(by1),
               static_cast<const int64_t*>(b_offs),
               static_cast<const uint8_t*>(b_kinds), static_cast<const int4*>(b_boxes)};
  const int64_t short_blocks = (n_pairs * kGroup + kShortThreads - 1) / kShortThreads;
  geom_refine_short_kernel<<<static_cast<unsigned>(short_blocks), kShortThreads, 0, st>>>(
      A, B, static_cast<const int64_t*>(ia), static_cast<const int64_t*>(ib), n_pairs,
      long_pairs, counters, static_cast<uint8_t*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || !may_long) return static_cast<int>(err);
  int64_t resident = 0;
  const int rc = long_blocks_resident(device, &resident);
  if (rc != 0) return rc;
  const int64_t wanted = (n_pairs + kLongWarps - 1) / kLongWarps;
  const int64_t long_blocks = resident < wanted ? resident : wanted;
  geom_refine_long_kernel<<<static_cast<unsigned>(long_blocks), kLongThreads, 0, st>>>(
      A, B, static_cast<const int64_t*>(ia), static_cast<const int64_t*>(ib), long_pairs,
      counters, counters + 1, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
