// tiled_mm: y = A . B for pre-quantized (or pass-mode) operands, f32
// accumulation, output in the input dtype.  A is (M, K), B is (K, N),
// both row-major.
//
// Replaces repro/kernels/fp4_matmul.py::_mm_kernel (via _tiled_matmul),
// the two-pass pipeline's phase 2.  The TPU kernel carries its f32
// accumulator in VMEM scratch across the sequential K grid axis; here one
// block owns one BM x BN output tile, loops over K itself and keeps the
// accumulator in registers, staging BK-deep A and B tiles in shared
// memory.  Ragged M / N / K edges are masked in the kernel (zero fill on
// load, no store), so no operand is padded.
//
// Bound: at decode (M = 8) bytes, the K x N weight panel (768 x 768 bf16,
// 1.2 MB: 0.35 us at 3.35 TB/s); at prefill operations, 2 M N K.  This
// first version is a CUDA-core FMA GEMM with 16 x 32 tiles for M <= 16 and
// 64 x 64 otherwise; tensor-core (mma / wgmma) tiles are later work.
#include "codec.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    tiled_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[BM][kBK + 1];
  __shared__ float Bs[kBK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int r = m0 + i / kBK, k = k0 + i % kBK;
      As[i / kBK][i % kBK] =
          (r < M && k < K) ? codec::to_f32(a[(long)r * K + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
      const int k = k0 + i / BN, n = n0 + i % BN;
      Bs[i / BN][i % BN] =
          (k < K && n < N) ? codec::to_f32(b[(long)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + 16 * j];
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

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t s) {
  const auto* ap = static_cast<const T*>(a);
  const auto* bp = static_cast<const T*>(b);
  auto* cp = static_cast<T*>(c);
  if (M <= 16) {
    const dim3 grid((N + 31) / 32, (M + 15) / 16);
    tiled_mm_kernel<T, 16, 32><<<grid, kThreads, 0, s>>>(ap, bp, cp, M, N, K);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    tiled_mm_kernel<T, 64, 64><<<grid, kThreads, 0, s>>>(ap, bp, cp, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int tiled_mm_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (dtype == 0) return launch<float>(a, b, c, M, N, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
