// The rounding codec shared by every kernel of the port: one copy, so the
// quantize pass, the streaming matmul and the plain PyTorch versions
// (kernels/rounding.py) land on the same bits.
//
// Dtype order (the reference's, repro/kernels/rounding.py quantize_tile and
// repro/kernels/fp4_matmul.py _qdq_stream_tile):
//   amax  in the input dtype (exact: a max of input values);
//   s     = max(f32(amax), 1e-12) / Q_max    IEEE division, f32;
//   sc    = T(s)                             round to nearest even;
//   t     = T(f32(x) / f32(sc))              IEEE division, then RNE to T;
//   q     = round_to_grid(f32(t))            exact integer RTN in f32;
//   y     = T(f32(q) * f32(sc))              product exact in f32, RNE to T.
// Division and product go through __fdiv_rn / __fmul_rn so neither a
// reciprocal nor a contraction can change a bit; build without
// --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace codec {

// Quantization modes shared by the launch interfaces.
enum Mode { kPass = 0, kBlock = 1, kTile = 2, kToken = 3, kTensor = 4 };
constexpr int kGroup = 128;  // quant group (block / tile edge)

struct Fmt {
  float qmax;  // largest finite magnitude, Q_max
  int emin;    // minimum normal exponent (unbiased)
  int mbits;   // mantissa bits
  int pow2;    // round the scale down to a power of two
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a pre-scaled value onto the format's grid: binade exponent from the
// f32 exponent field (clamped at emin, which gives the fixed subnormal grid),
// grid step assembled by writing e - mbits back, half-to-even, saturate.
// copysign keeps the reference's sign(x) * q * step, -0.0 included.
__device__ __forceinline__ float round_to_grid(float t, const Fmt& f) {
  float mag = fminf(fabsf(t), f.qmax);
  int e = max((__float_as_int(mag) >> 23) - 127, f.emin);
  float step = __int_as_float((e - f.mbits + 127) << 23);
  float q = rintf(__fdiv_rn(mag, step));  // step is a power of two: exact
  return copysignf(fminf(__fmul_rn(q, step), f.qmax), t);
}

// Per-group scale alpha = max(amax, eps) / Q_max (paper Eq. 3), f32.
__device__ __forceinline__ float group_scale(float amax, const Fmt& f) {
  float s = __fdiv_rn(fmaxf(amax, 1e-12f), f.qmax);
  if (f.pow2) s = __int_as_float(__float_as_int(s) & 0x7F800000);
  return s;
}

// QDQ of one element with its group's scale already cast to T.
template <typename T>
__device__ __forceinline__ T qdq(T x, T sc, const Fmt& f) {
  float scf = to_f32(sc);
  T t = from_f32<T>(__fdiv_rn(to_f32(x), scf));
  T q = from_f32<T>(round_to_grid(to_f32(t), f));
  return from_f32<T>(__fmul_rn(to_f32(q), scf));
}

// Max over the whole block; every thread gets the result.  blockDim.x must
// be a multiple of 32.  Ends with a barrier so the scratch can be reused.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// amax of |x| over rows [r0, r1) x cols [c0, c1) of a row-major matrix with
// leading dimension ld, reduced over the whole block.
template <typename T>
__device__ __forceinline__ float region_amax(const T* __restrict__ x,
                                             long ld, int r0, int r1,
                                             int c0, int c1) {
  const int w = c1 - c0, n = (r1 - r0) * w;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    m = fmaxf(m, fabsf(to_f32(x[(long)(r0 + i / w) * ld + c0 + i % w])));
  return block_max(m);
}

}  // namespace codec
