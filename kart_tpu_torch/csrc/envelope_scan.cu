// K2: the envelope prefilter scan.
//
// Replaces kart_tpu/diff/backend.py _bbox_hits_f32_step with the thresholds
// of _query_f32_thresholds (the sharded f32 scan), and the wrapping-query
// branch of the native scan_rows_f32 (native/spatial_filter.cpp), which the
// JAX path leaves to the host. Input is the sidecar's (count, 4) f32 wsen
// rows; output one 0/1 byte per row.
//   non-wrapping query (qe >= qw): branchless f32 compares against the
//     host-widened thresholds (largest float <= b, smallest float >= b), so
//     the pure-f32 test equals the f64 one:
//       lat & ((a & b) | (wrap & (a | b)))
//   wrapping query: the native f64 cyclic test, with mod360 truncating
//     through int64 exactly as the C++ does. 360 * trunc(x / 360) is exact
//     for finite envelopes, so a fused multiply-add gives the same result.
//
// Bound: bytes. 16 B read and 1 B written per row (170 MB at 10M rows);
// each thread loads its row as one float4.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mod360(double x) {
  double d = x - 360.0 * static_cast<double>(static_cast<long long>(x / 360.0));
  if (d < 0) d += 360.0;
  return d;
}

__device__ __forceinline__ double range_len(double w, double e) {
  return e >= w ? e - w : mod360(e - w);
}

__global__ void __launch_bounds__(kThreads)
envelope_scan_kernel(const float4* __restrict__ env, int64_t n, float qw_ge,
                     float qs_ge, float qe_le, float qn_le, int wraps,
                     double qw, double qs, double qe, double qn,
                     uint8_t* __restrict__ out) {
  for (int64_t i = grid_start(); i < n; i += grid_stride()) {
    const float4 p = env[i];  // x=w, y=s, z=e, w=n
    uint8_t hit;
    if (!wraps) {
      const uint8_t lat = (p.y <= qn_le) & (qs_ge <= p.w);
      const uint8_t a = p.x <= qe_le;
      const uint8_t b = qw_ge <= p.z;
      const uint8_t wrap = p.z < p.x;
      hit = lat & ((a & b) | (wrap & (a | b)));
    } else {
      const double w = p.x, s = p.y, e = p.z, nn = p.w;
      if (s > qn || qs > nn) {
        hit = 0;
      } else {
        const double len1 = range_len(w, e);
        const double len2 = range_len(qw, qe);
        hit = (mod360(qw - w) <= len1 || mod360(w - qw) <= len2) ? 1 : 0;
      }
    }
    out[i] = hit;
  }
}

}  // namespace

// env: (n, 4) f32, 16-byte aligned. thresholds: the f32 query of
// _query_f32_thresholds (used when !wraps). query: the f64 rect (used when
// wraps). out: n bytes.
extern "C" int kart_envelope_scan(const void* env, int64_t n, float qw_ge,
                                  float qs_ge, float qe_le, float qn_le,
                                  int wraps, double qw, double qs, double qe,
                                  double qn, void* out, int blocks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  envelope_scan_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(env), n, qw_ge, qs_ge, qe_le, qn_le, wraps,
      qw, qs, qe, qn, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
