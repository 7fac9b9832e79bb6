// K3: the cyclic-longitude bbox test of the filtered-clone pre-pass.
//
// Replaces the Pallas kernel kart_tpu/ops/bbox.py _bbox_kernel (launched by
// _bbox_pallas_inner_core / bbox_intersects_pallas), which tiles (N/128,
// 128) f32 w/s/e/n columns through VMEM with the query in SMEM. Here one
// thread per envelope (grid-stride, int64 indices) reads the four SoA
// columns with coalesced loads; the query arrives as kernel arguments.
// Arithmetic is P1's, in f32:
//   lat_ok = (s <= qn) & (qs <= n)
//   len1   = e >= w ? e - w : mod(e - w, 360)
//   len2   = qe >= qw ? qe - qw : mod(qe - qw, 360)
//   lon_ok = mod(qw - w, 360) <= len1 | mod(w - qw, 360) <= len2
// with mod the floor-mod of jnp.mod: fmodf (exact), then +360 when the
// remainder is non-zero and negative. Rows at or past `count` (the
// latitude-91 padding) write 0.
//
// Bound: bytes. 16 B read and 1 B written per envelope (170 MB at 10M).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float floor_mod360(float x) {
  float r = fmodf(x, 360.0f);
  if (r != 0.0f && r < 0.0f) r += 360.0f;
  return r;
}

__global__ void __launch_bounds__(kThreads)
bbox_kernel(const float* __restrict__ w, const float* __restrict__ s,
            const float* __restrict__ e, const float* __restrict__ n,
            int64_t count, int64_t n_items, float qw, float qs, float qe,
            float qn, uint8_t* __restrict__ out) {
  const float len2 = qe >= qw ? qe - qw : floor_mod360(qe - qw);
  for (int64_t i = grid_start(); i < n_items; i += grid_stride()) {
    if (i >= count) {
      out[i] = 0;
      continue;
    }
    const float wi = w[i], si = s[i], ei = e[i], ni = n[i];
    const bool lat_ok = (si <= qn) & (qs <= ni);
    const float len1 = ei >= wi ? ei - wi : floor_mod360(ei - wi);
    const bool lon_ok =
        (floor_mod360(qw - wi) <= len1) | (floor_mod360(wi - qw) <= len2);
    out[i] = lat_ok & lon_ok;
  }
}

}  // namespace

// w, s, e, n: n_items f32 each (padded columns); out: n_items bytes.
extern "C" int kart_bbox(const void* w, const void* s, const void* e,
                         const void* n, int64_t count, int64_t n_items,
                         float qw, float qs, float qe, float qn, void* out,
                         int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bbox_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(s),
      static_cast<const float*>(e), static_cast<const float*>(n), count,
      n_items, qw, qs, qe, qn, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
