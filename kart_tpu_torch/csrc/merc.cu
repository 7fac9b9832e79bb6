// K7: the batch mercator projection.
//
// Replaces kart_tpu/diff/backend.py _make_sharded_merc._merc, applied as its
// _step does: each (w, s, e, n) f64 degree row gives
//   (mx0, my0) = merc(w, n)    the north-west corner
//   (mx1, my1) = merc(e, s)    the south-east corner
// merc(lon, lat):
//   lat = clip(lat, +-MERC_MAX_LAT)
//   x   = (lon + 180) / 360
//   s   = sin(radians(lat))
//   y   = 0.5 - log((1 + s) / (1 - s)) / (4 pi)
// Output is four f64 columns, each of m values, in one (4, m) array. The
// tile quantizer (tiles/clip.py quantize_from_merc) stays on the host.
//
// Bound: bytes. 32 B read and 32 B written a row; the f64 work (two sin, two
// log, six correctly rounded divisions) is below it on an H100. One thread a
// row, grid-stride; the row is read as two 16-byte loads and each column is
// written coalesced. No shared memory.
//
// Numerics, written so that the kernel equals its plain PyTorch version bit
// for bit and stays next to numpy's host projection:
// - every add, multiply and division is an __d*_rn intrinsic, rounded once
//   as numpy and PyTorch round each operation: nvcc would otherwise contract
//   a multiply and an add into one FMA (-fmad=true is the default, and the
//   global flags are shared with K1-K6);
// - the divisions are true divisions, as numpy's are (PyTorch's plain
//   version divides by device tensors, not by a reciprocal);
// - radians is one multiply by pi / 180 rounded to double, numpy's constant;
// - the clamp is written with comparisons, which keep NaN as np.clip and
//   torch.clamp do (fmin/fmax would return the bound for a NaN);
// - sin and log are CUDA's libdevice functions, which PyTorch's sin and log
//   kernels call too. Built without --use_fast_math.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr double kMaxLat = 85.05112877980659;     // atan(sinh(pi)) in degrees
constexpr double kDegToRad = 0.017453292519943295;  // pi / 180, rounded
constexpr double kFourPi = 12.566370614359172;      // 4 * pi, rounded

__device__ __forceinline__ double clamp_lat(double lat) {
  return lat < -kMaxLat ? -kMaxLat : (lat > kMaxLat ? kMaxLat : lat);
}

__device__ __forceinline__ double merc_x(double lon) {
  return __ddiv_rn(__dadd_rn(lon, 180.0), 360.0);
}

__device__ __forceinline__ double merc_y(double lat) {
  const double s = sin(__dmul_rn(clamp_lat(lat), kDegToRad));
  const double q = __ddiv_rn(__dadd_rn(1.0, s), __dsub_rn(1.0, s));
  return __dsub_rn(0.5, __ddiv_rn(log(q), kFourPi));
}

__global__ void __launch_bounds__(kThreads)
merc_kernel(const double2* __restrict__ env, int64_t m,
            double* __restrict__ out) {
  for (int64_t i = grid_start(); i < m; i += grid_stride()) {
    const double2 ws = env[2 * i];      // x = w, y = s
    const double2 en = env[2 * i + 1];  // x = e, y = n
    out[i] = merc_x(ws.x);
    out[m + i] = merc_y(en.y);
    out[2 * m + i] = merc_x(en.x);
    out[3 * m + i] = merc_y(ws.y);
  }
}

}  // namespace

// env: (m, 4) f64 wsen rows, 16-byte aligned. out: (4, m) f64.
extern "C" int kart_merc(const void* env, int64_t m, void* out, int blocks,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  merc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(env), m, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

KART_ERROR_STRING_EXPORT
