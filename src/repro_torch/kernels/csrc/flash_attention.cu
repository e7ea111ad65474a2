// flash_attention: causal online-softmax attention forward over (B*H, S, D)
// q and (B*KVH, S, D) k / v, output in q's dtype.
//
// Replaces repro/kernels/flash_attention.py::_fa_kernel (via
// flash_attention_fwd).  The TPU kernel walks the grid (B*H, S/bq, S/bk)
// with the KV axis innermost and sequential, carrying the running max m,
// the running sum l and the f32 accumulator in VMEM scratch across it.
// Hopper blocks run in no order, so here one block owns one (b*h, 64-row
// q tile) and runs the KV loop itself: m, l and acc live in registers,
// the q tile (pre-scaled) and each 64-key K / V tile in shared memory (f32),
// and the tile's probabilities P go through shared memory into the P.V
// product, kept f32 as the reference keeps p.  Arithmetic is the
// reference's, op for op: q cast to f32, then times 1/sqrt(D);
// s = q.k in f32; masked scores NEG_INF = -1e30; safe_m = 0 where the new
// max is still masked; corr = exp(m_prev - safe_m) zeroed where m_prev is
// masked; l floored at 1e-30 before the final division.  IEEE expf and
// division (no fast math).  KV tiles wholly above the diagonal are not
// visited: for such a tile every p is 0 and corr is 1, so skipping it
// changes no number.  GQA: q head h of batch b reads KV row
// (b*H + h) / rep = b*KVH + h / rep, the head jnp.repeat would give it,
// without repeating K / V in memory.
//
// Thread layout: 256 threads as 16 x 16; thread (ty, tx) owns the q rows
// ty + 16 i (i < 4), the key columns tx + 16 j of each score tile and the
// output columns tx + 16 c (c < D / 16).  A row's max and sum reduce over
// the 16 tx lanes of a half warp with shuffles.  Shared tiles are padded
// by one float a row against bank conflicts.
//
// Bound: gpt2-125m at batch 8 (96 x 1024 x 64 bf16): bytes, q, k, v read
// once and o written once (50 MB: 15 us at 3.35 TB/s); its causal
// operations (4 S^2 D / 2 per head, 12.9 GFLOP) take 13 us at the bf16
// tensor-core rate.  This first version runs both products on CUDA-core
// FMAs, a long way from either; mma / wgmma tiles are later work.
#include "codec.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S,
                     int rep, float scale, int causal) {
  constexpr int TC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D + 1]
  float* Ps = Vs + kBK * (D + 1);        // [kBQ][kBK + 1]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const long qbase = ((long)bh * S + q0) * D;
  const long kvbase = (long)(bh / rep) * S * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads)
    Qs[(i / D) * (D + 1) + i % D] =
        __fmul_rn(codec::to_f32(q[qbase + i]), scale);

  float m[4], l[4], acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with Ks / Vs / Ps
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const long g = kvbase + (long)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? codec::to_f32(k[g]) : 0.f;
      Vs[r * (D + 1) + c] = in ? codec::to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr =
          expf(m[i] - safe_m) * (m[i] > kNegInf / 2 ? 1.f : 0.f);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - safe_m);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[TC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < TC; ++c) vv[c] = Vs[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    const long row = qbase + (long)(ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < TC; ++c)
      o[row + tx + 16 * c] = codec::from_f32<T>(__fdiv_rn(acc[i][c], li));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int rep, float scale, int causal, cudaStream_t s) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S / kBQ, BH);
  kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, rep, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int D, int rep, float scale, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, rep, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (BH, S, D); k, v: (BH / rep, S, D); all row-major contiguous.
// S a multiple of 64, D in {16, 32, 64, 128}.  scale = f32(1 / sqrt(D)).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int D, int rep, float scale,
                                      int causal, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (S % kBQ != 0 || rep <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, BH, S, D, rep, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, BH, S, D, rep, scale, causal,
                                   s);
  return (int)cudaErrorInvalidValue;
}
