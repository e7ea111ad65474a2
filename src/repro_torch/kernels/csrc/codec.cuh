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
//
// Stochastic rounding (the reference's interpret-mode path,
// repro/kernels/rounding.py hash_bits / uniform_from_bits): the noise of
// an element is a counter hash of (seed, global row, global col) in the
// operand's quant orientation, so it does not depend on tiling or launch
// order, and the plain PyTorch version reproduces it bit for bit.  The
// TPU's hardware PRNG is not used: nothing outside the TPU can replay it.
// The seed is folded on the host (kernels/rounding.py fold_seed).
//
// The stats epilogue (the reference's _stats_accum / _stats_slab_flush /
// _stats_fold): eight f32 lanes per quantized operand, folded in one
// canonical order that every kernel and kernels/ref.py quant_stats_ref
// share, so all lanes agree bit for bit between them:
//   row partial  per (quant row, 128-wide k-slab): tree128 of the
//                per-element terms (row_stats, one warp);
//   slab partial per (128-row block-row, k-slab): tree128 of its rows'
//                partials (stats_slab_kernel, one warp a slab);
//   total        per block-row its k-slabs in order, then the block-rows
//                in order (stats_total_kernel).
// tree128 = lane l folds entries l, l+32, l+64, l+96 in turn, then an
// xor butterfly over the 32 lanes.
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
  float clip;  // f32(Q_max * (1 + 1e-6)): the stats' clip point / scale
};

// The host side of a launch builds its formats here, so the clip point is
// rounded from the same double product as the reference's numpy constant.
inline Fmt make_fmt(float qmax, int emin, int mbits, int pow2) {
  return Fmt{qmax, emin, mbits, pow2, (float)((double)qmax * (1.0 + 1e-6))};
}

// Stochastic rounding of one operand: on, and its seed.
struct Sr {
  int on;
  unsigned int seed;
  // the operand's element (0, 0) in the global operand: a data-parallel
  // rank's share of the token axis draws the one-process noise of its rows
  unsigned int row0, col0;
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

// The counter hash: murmur3's finalizer over seed, row and column; uint32
// products and sums wrap as the reference's do.
__device__ __forceinline__ unsigned int mix(unsigned int h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ unsigned int hash_bits(unsigned int seed,
                                                  unsigned int row,
                                                  unsigned int col) {
  unsigned int h = seed * 0x9E3779B9u;
  h = mix(h ^ (row * 0x85EBCA6Bu));
  return mix(h ^ (col * 0xC2B2AE35u));
}

// uint32 bits -> uniform [0, 1) from the top 24 bits (exact in f32).
__device__ __forceinline__ float uniform_from_bits(unsigned int bits) {
  return __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);  // 2^-24
}

// The SR noise of element (row, col) in quant orientation (offset by the
// operand's origin), or -1 (round to nearest) when SR is off.
__device__ __forceinline__ float noise(const Sr& sr, int row, int col) {
  return sr.on ? uniform_from_bits(hash_bits(sr.seed,
                                             sr.row0 + (unsigned int)row,
                                             sr.col0 + (unsigned int)col))
               : -1.f;
}

// Round a pre-scaled value onto the format's grid: binade exponent from the
// f32 exponent field (clamped at emin, which gives the fixed subnormal grid),
// grid step assembled by writing e - mbits back, half-to-even, saturate.
// copysign keeps the reference's sign(x) * q * step, -0.0 included.  With
// noise u >= 0 the rounding is stochastic, floor(|t| / step + u) * step.
__device__ __forceinline__ float round_to_grid(float t, const Fmt& f,
                                               float u = -1.f) {
  float mag = fminf(fabsf(t), f.qmax);
  int e = max((__float_as_int(mag) >> 23) - 127, f.emin);
  float step = __int_as_float((e - f.mbits + 127) << 23);
  float scaled = __fdiv_rn(mag, step);  // step is a power of two: exact
  float q = u < 0.f ? rintf(scaled) : floorf(__fadd_rn(scaled, u));
  return copysignf(fminf(__fmul_rn(q, step), f.qmax), t);
}

// Per-group scale alpha = max(amax, eps) / Q_max (paper Eq. 3), f32.
__device__ __forceinline__ float group_scale(float amax, const Fmt& f) {
  float s = __fdiv_rn(fmaxf(amax, 1e-12f), f.qmax);
  if (f.pow2) s = __int_as_float(__float_as_int(s) & 0x7F800000);
  return s;
}

// QDQ of one element with its group's scale already cast to T; u is the
// element's SR noise (negative: round to nearest).
template <typename T>
__device__ __forceinline__ T qdq(T x, T sc, const Fmt& f, float u = -1.f) {
  float scf = to_f32(sc);
  T t = from_f32<T>(__fdiv_rn(to_f32(x), scf));
  T q = from_f32<T>(round_to_grid(to_f32(t), f, u));
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

// ---------------------------------------------------------------------------
// The stats epilogue
// ---------------------------------------------------------------------------

constexpr int kStats = 8;         // lanes of a stats vector
constexpr float kStatsBig = 3.0e38f;

// Row partial of one (quant row, k-slab), called by a whole warp: lane l
// holds the slab row's elements l, l+32, l+64, l+96 as f32, x before and
// q after the QDQ (zero outside the operand); scale is the row-slab's
// group scale in f32 and cnt the slab's columns inside the operand.
// Lane 0 writes the 8 lanes to out.
__device__ __forceinline__ void row_stats(const float (&x)[4],
                                          const float (&q)[4], float scale,
                                          const Fmt& f, int cnt,
                                          float* __restrict__ out) {
  const float thr = __fmul_rn(scale, f.clip);
  float t[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m = fabsf(x[j]), d = __fsub_rn(x[j], q[j]);
    const float v[5] = {m > thr ? 1.f : 0.f,
                        (m > 0.f && q[j] == 0.f) ? 1.f : 0.f,
                        m > 0.f ? 1.f : 0.f, __fmul_rn(d, d),
                        __fmul_rn(x[j], x[j])};
#pragma unroll
    for (int i = 0; i < 5; ++i) t[i] = j ? __fadd_rn(t[i], v[i]) : v[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 5; ++i)
      t[i] = __fadd_rn(t[i], __shfl_xor_sync(0xffffffffu, t[i], o));
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i] = t[i];
    out[5] = scale;
    out[6] = scale;
    out[7] = (float)cnt;
  }
}

__device__ __forceinline__ float stats_op(int lane, float a, float b) {
  return lane == 5 ? fminf(a, b) : lane == 6 ? fmaxf(a, b) : __fadd_rn(a, b);
}

// One operand's fold: row partials part (rows, ks, 8) -> slab partials
// slab (ceil(rows / 128), ks, 8) -> out (8).
struct StatsJob {
  const float* part;
  float* slab;
  float* out;
  int rows, ks;
};
struct StatsJobs {
  StatsJob job[2];
};

// Slab partials: one warp a (block-row, k-slab), 8 warps a block,
// blockIdx.y indexes jobs.  Lane l loads its rows' 8 lanes as two float4
// (a row partial is 32 bytes, 32-byte aligned).
__global__ void __launch_bounds__(256) stats_slab_kernel(StatsJobs jobs) {
  const StatsJob jb = jobs.job[blockIdx.y];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int nrb = (jb.rows + kGroup - 1) / kGroup;
  if (i >= nrb * jb.ks) return;            // whole warps leave together
  const int rb = i / jb.ks, ks = i % jb.ks;
  float t[kStats];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = rb * kGroup + lane + 32 * j;
    float v[kStats] = {0.f, 0.f, 0.f, 0.f, 0.f, kStatsBig, 0.f, 0.f};
    if (row < jb.rows) {
      const float4* p = reinterpret_cast<const float4*>(
          jb.part + ((long)row * jb.ks + ks) * kStats);
      const float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
#pragma unroll
    for (int s = 0; s < kStats; ++s) t[s] = j ? stats_op(s, t[s], v[s]) : v[s];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int s = 0; s < kStats; ++s)
      t[s] = stats_op(s, t[s], __shfl_xor_sync(0xffffffffu, t[s], o));
  if (lane == 0) {
    float4* q = reinterpret_cast<float4*>(jb.slab + (long)i * kStats);
    q[0] = make_float4(t[0], t[1], t[2], t[3]);
    q[1] = make_float4(t[4], t[5], t[6], t[7]);
  }
}

// The total: one block a job.  Thread (rb, s) folds block-row rb's
// k-slabs in order into slab[rb][0][s] (it alone touches [rb][*][s]),
// then thread s folds the block-rows in order.
__global__ void __launch_bounds__(256) stats_total_kernel(StatsJobs jobs) {
  const StatsJob jb = jobs.job[blockIdx.x];
  const int nrb = (jb.rows + kGroup - 1) / kGroup;
  for (int i = threadIdx.x; i < nrb * kStats; i += blockDim.x) {
    const int s = i % kStats;
    float* row = jb.slab + (long)(i / kStats) * jb.ks * kStats + s;
    float acc = row[0];
    for (int ks = 1; ks < jb.ks; ++ks)
      acc = stats_op(s, acc, row[(long)ks * kStats]);
    row[0] = acc;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    const int s = threadIdx.x;
    float tot = jb.slab[s];
    for (int rb = 1; rb < nrb; ++rb)
      tot = stats_op(s, tot, jb.slab[(long)rb * jb.ks * kStats + s]);
    jb.out[s] = tot;
  }
}

// Launch the two fold kernels of n_jobs (1 or 2) operands.
inline void fold_stats(const StatsJobs& jobs, int n_jobs, cudaStream_t s) {
  int slabs = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int n = (jobs.job[j].rows + kGroup - 1) / kGroup * jobs.job[j].ks;
    slabs = n > slabs ? n : slabs;
  }
  stats_slab_kernel<<<dim3((slabs + 7) / 8, n_jobs), 256, 0, s>>>(jobs);
  stats_total_kernel<<<n_jobs, 256, 0, s>>>(jobs);
}

}  // namespace codec
