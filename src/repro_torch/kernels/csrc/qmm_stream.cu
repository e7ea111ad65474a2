// qmm_stream: y = Q(A) . Q(B) in one pass, the quantize fused into the
// matmul's K loop.  A is (M, K), B is (K, N), both row-major; modes per
// operand: pass, block (1x128 groups along K) or tile (128x128).
//
// Replaces repro/kernels/fp4_matmul.py::_stream_kernel (via _stream_qmm;
// its QDQ is _qdq_stream_tile).  The TPU kernel walks (M/bm, N/bn, K/bk)
// sequentially, keeps the f32 accumulator in VMEM scratch across the K grid
// axis and caches quantized panels in VMEM across revisits.  Hopper blocks
// run in no order, so here one block owns one BM x BN output tile and runs
// the K loop itself with the accumulator in registers; each block
// re-quantizes the A and B tiles it reads, which gives the same bits as a
// cached panel because the codec is deterministic.  Each K step is one
// 128-wide quant group: load the A and B tiles into shared memory (zero
// outside the ragged M / N / K edges, which leaves every group's amax as
// the reference's zero padding does), QDQ them in place, then accumulate
// with an f32 FMA loop.  Each thread sums its outputs in k order, so a
// row's result does not depend on M or on the tile shape.
//
// Bound: at decode (M = slots, 8) bytes, the B panel (K x N bf16, 4.7 MB
// for the FFN up-projection: 1.4 us at 3.35 TB/s); at prefill (M up to
// 512) operations, 2 M N K (2.4 GFLOP for 512 x 768 x 3072: 2.4 us at the
// 989 TFLOP/s bf16 tensor-core rate).  This first version uses CUDA-core
// FMAs and small tiles for M <= 16 so decode spreads over more blocks; it
// is far from both bounds.  mma / wgmma with TMA-fed shared-memory rings,
// and reading packed FP4 codes for B in place of the dequantized panel,
// are later work.  Trans layouts, stochastic rounding and the stats
// epilogue (training only) are not built yet; the wrapper refuses them.
#include "codec.cuh"

namespace {

constexpr int kBK = codec::kGroup;
constexpr int kThreads = 256;  // 16 x 16

// QDQ the (rows x kBK) A tile in shared memory, groups along K.
template <typename T, int BM>
__device__ void qdq_a_tile(T (*As)[kBK], const T* __restrict__ a, int mode,
                           const codec::Fmt& f, int m0, int k0, int M,
                           int K) {
  if (mode == codec::kBlock) {
    // One warp per row: each lane owns 4 of the row's 128 K values.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < BM; r += kThreads / 32) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j)
        m = fmaxf(m, fabsf(codec::to_f32(As[r][lane + 32 * j])));
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const T sc = codec::from_f32<T>(codec::group_scale(m, f));
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j)
        As[r][lane + 32 * j] = codec::qdq(As[r][lane + 32 * j], sc, f);
    }
  } else if (mode == codec::kTile) {
    // The 128-row tile reaches past this block's BM rows: its amax comes
    // from device memory (L2-resident after the first block reads it).
    const int t0 = m0 - m0 % codec::kGroup;
    const float amax = codec::region_amax(
        a, K, t0, min(t0 + codec::kGroup, M), k0, min(k0 + kBK, K));
    const T sc = codec::from_f32<T>(codec::group_scale(amax, f));
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads)
      As[i / kBK][i % kBK] = codec::qdq(As[i / kBK][i % kBK], sc, f);
  }
}

// QDQ the (kBK x BN) B tile in shared memory, groups along K.
template <typename T, int BN>
__device__ void qdq_b_tile(T (*Bs)[BN], T* col_scale,
                           const T* __restrict__ b, int mode,
                           const codec::Fmt& f, int n0, int k0, int N,
                           int K) {
  if (mode == codec::kBlock) {
    if (threadIdx.x < BN) {
      float m = 0.f;
      for (int k = 0; k < kBK; ++k)
        m = fmaxf(m, fabsf(codec::to_f32(Bs[k][threadIdx.x])));
      col_scale[threadIdx.x] = codec::from_f32<T>(codec::group_scale(m, f));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads)
      Bs[i / BN][i % BN] =
          codec::qdq(Bs[i / BN][i % BN], col_scale[i % BN], f);
  } else if (mode == codec::kTile) {
    const int t0 = n0 - n0 % codec::kGroup;
    const float amax = codec::region_amax(
        b, N, k0, min(k0 + kBK, K), t0, min(t0 + codec::kGroup, N));
    const T sc = codec::from_f32<T>(codec::group_scale(amax, f));
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads)
      Bs[i / BN][i % BN] = codec::qdq(Bs[i / BN][i % BN], sc, f);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    qmm_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int M, int N, int K, int a_mode,
                      int b_mode, codec::Fmt fa, codec::Fmt fb) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ T As[BM][kBK];
  __shared__ T Bs[kBK][BN];
  __shared__ T col_scale[BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T zero = codec::from_f32<T>(0.f);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = m0 + i / kBK, k = k0 + i % kBK;
      As[i / kBK][i % kBK] = (r < M && k < K) ? a[(long)r * K + k] : zero;
    }
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
      const int k = k0 + i / BN, n = n0 + i % BN;
      Bs[i / BN][i % BN] = (k < K && n < N) ? b[(long)k * N + n] : zero;
    }
    __syncthreads();
    qdq_a_tile<T, BM>(As, a, a_mode, fa, m0, k0, M, K);
    qdq_b_tile<T, BN>(Bs, col_scale, b, b_mode, fb, n0, k0, N, K);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = codec::to_f32(As[ty + 16 * i][k]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = codec::to_f32(Bs[k][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (r < M && n < N) c[(long)r * N + n] = codec::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int a_mode, int b_mode, codec::Fmt fa, codec::Fmt fb,
           cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_stream_kernel<T, BM, BN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, a_mode, b_mode, fa, fb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a_mode / b_mode: codec::kPass,
// kBlock or kTile.  Shared memory stays under the 48 KB static limit:
// bf16 64x64 tiles (32 KB), f32 32x32 (32 KB), 16x32 for M <= 16.
extern "C" int qmm_stream_launch(const void* a, const void* b, void* c,
                                 int M, int N, int K, int dtype, int a_mode,
                                 int b_mode, float a_qmax, int a_emin,
                                 int a_mbits, int a_pow2, float b_qmax,
                                 int b_emin, int b_mbits, int b_pow2,
                                 void* stream) {
  const codec::Fmt fa{a_qmax, a_emin, a_mbits, a_pow2};
  const codec::Fmt fb{b_qmax, b_emin, b_mbits, b_pow2};
  auto s = static_cast<cudaStream_t>(stream);
  if (a_mode < codec::kPass || a_mode > codec::kTile ||
      b_mode < codec::kPass || b_mode > codec::kTile)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0) {
    if (M <= 16)
      return launch<float, 16, 32>(a, b, c, M, N, K, a_mode, b_mode, fa, fb, s);
    return launch<float, 32, 32>(a, b, c, M, N, K, a_mode, b_mode, fa, fb, s);
  }
  if (dtype == 1) {
    if (M <= 16)
      return launch<__nv_bfloat16, 16, 32>(a, b, c, M, N, K, a_mode, b_mode,
                                           fa, fb, s);
    return launch<__nv_bfloat16, 64, 64>(a, b, c, M, N, K, a_mode, b_mode,
                                         fa, fb, s);
  }
  return (int)cudaErrorInvalidValue;
}
