// tiled_mm: y = A' . B' for pre-quantized (or pass-mode) operands, f32
// accumulation, output in the input dtype.  A' is (M, K), stored row-major
// as A (M, K), or as A (K, M) read transposed under trans_a; B' is (K, N),
// stored as B (K, N), or as B (N, K) under trans_b.
//
// Replaces repro/kernels/fp4_matmul.py::_mm_kernel (via _tiled_matmul),
// the two-pass pipeline's phase 2.  The TPU kernel carries its f32
// accumulator in VMEM scratch across the sequential K grid axis; here one
// block owns one output tile, loops over K itself and keeps the
// accumulator in registers.  The trans flags are the reference's index
// maps, realized by reading the stored layout in place; ragged M / N / K
// edges are masked in the kernel (zero fill on load, no store), so no
// operand is padded or copied.
//
// Route (gemm_sm90.cuh tensor_core_route, of dtype and M alone, the same
// rule as qmm_stream.cu):
// - bf16, M > 16 (prefill, training): the tensor-core main loop of
//   gemm_sm90.cuh with nothing between a stage's arrival and its products:
//   BM x BN output tiles of the caller's choice (128 x 128, 128 x 256 or
//   256 x 128, the same tilings as qmm_stream.cu), 128-wide K steps
//   through a cp.async ring, wgmma m64n128k16 from 128-byte-swizzled
//   tiles in their stored layout.  It is the loop qmm_stream.cu runs, so quantize_rows +
//   tiled_mm equals the stream pipeline bit for bit.  Bound: operations,
//   2 M N K (8192 x 768 x 768: 9.7 GFLOP, 9.8 us at 989 TFLOP/s bf16).
//   What holds it back: every block loads its own A and B tiles (a 128 x
//   128 tile does 64 flops per byte it loads, so the tensor cores would
//   need ~15 TB/s from L2), a block waits for its products every step
//   (only the loads of later steps stay in flight), and the 8192 x 768
//   grid (384 tiles on 132 SMs) leaves a part-filled last wave.
// - f32 (tensor cores would take it as TF32), or M <= 16 (decode): a
//   CUDA-core FMA GEMM, 16 x 32 tiles for M <= 16, 64 x 64 otherwise (f32).
//   Each K step issues all of a thread's global loads into registers
//   before any shared store, so the loads are in flight together (at M = 8
//   the load latency is the kernel's time); the shared tiles are padded by
//   one column so transposing writes do not collide on banks.  Decode is
//   bytes-bound on the K x N weight panel (768 x 768 bf16, 1.2 MB: 0.35 us
//   at 3.35 TB/s).
//
// Batched launches (the MoE experts, the counterpart of the reference's
// jax.vmap over pallas_call): batch operand pairs stored back to back,
// A (batch, M, K) or (batch, K, M), B (batch, K, N) or (batch, N, K), C
// (batch, M, N), one launch with blockIdx.z as the pair.  A block offsets
// its three base pointers to its pair and runs the unbatched code, so
// every pair's result equals the same kernel launched on that pair alone,
// bit for bit.
#include "codec.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16

template <typename T, int BM, int BN, bool trans_a, bool trans_b>
__global__ void __launch_bounds__(kThreads)
    tiled_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[BM][kBK + 1];
  __shared__ float Bs[kBK][BN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += blockIdx.z * (long)M * K;  // this block's pair of a batch
  b += blockIdx.z * (long)K * N;
  c += blockIdx.z * (long)M * N;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    constexpr int NA = BM * kBK / kThreads, NB = kBK * BN / kThreads;
    float ra[NA], rb[NB];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int ri = trans_a ? i % BM : i / kBK;
      const int ki = trans_a ? i / BM : i % kBK;
      const int r = m0 + ri, k = k0 + ki;
      ra[j] = (r < M && k < K)
          ? codec::to_f32(a[trans_a ? (long)k * M + r : (long)r * K + k])
          : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int ki = trans_b ? i % kBK : i / BN;
      const int ni = trans_b ? i / kBK : i % BN;
      const int k = k0 + ki, n = n0 + ni;
      rb[j] = (k < K && n < N)
          ? codec::to_f32(b[trans_b ? (long)n * K + k : (long)k * N + n])
          : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int i = threadIdx.x + j * kThreads;
      As[trans_a ? i % BM : i / kBK][trans_a ? i / BM : i % kBK] = ra[j];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = threadIdx.x + j * kThreads;
      Bs[trans_b ? i % kBK : i / BN][trans_b ? i / kBK : i % BN] = rb[j];
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

template <typename T, int BM, int BN, bool TA, bool TB>
void run(const T* a, const T* b, T* c, int M, int N, int K, int batch,
         cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tiled_mm_kernel<T, BM, BN, TA, TB><<<grid, kThreads, 0, s>>>(a, b, c, M, N,
                                                               K);
}

// The trans flags are template arguments, so the layout costs no index
// arithmetic at run time: at decode shapes (M = 8) a thread does as few
// FMAs a K step as it does loads.
template <typename T, int BM, int BN>
void run(const T* a, const T* b, T* c, int M, int N, int K, int batch,
         int ta, int tb, cudaStream_t s) {
  if (ta && tb) run<T, BM, BN, true, true>(a, b, c, M, N, K, batch, s);
  else if (ta) run<T, BM, BN, true, false>(a, b, c, M, N, K, batch, s);
  else if (tb) run<T, BM, BN, false, true>(a, b, c, M, N, K, batch, s);
  else run<T, BM, BN, false, false>(a, b, c, M, N, K, batch, s);
}

template <typename T, int BM, int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int batch, int ta, int tb, cudaStream_t s) {
  run<T, BM, BN>(static_cast<const T*>(a), static_cast<const T*>(b),
                 static_cast<T*>(c), M, N, K, batch, ta, tb, s);
  return (int)cudaGetLastError();
}

// kAKMaj: A' is K-major (A stored (M, K)); kBKMaj: B' is K-major (B
// stored (N, K), trans_b).  (BM, BN): the output tiling (gemm_sm90.cuh).
template <bool kAKMaj, bool kBKMaj, int BM, int BN>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    tiled_mm_tc_kernel(sm90::Operand a, sm90::Operand b,
                       __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  c += sm90::to_pair(a, b, M, N);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::mainloop<kAKMaj, kBKMaj, BM, BN>(acc, smem, a, b, m0, n0, K,
                                         [](uint8_t*, uint8_t*, int) {});
  sm90::store_tile<BM, BN>(acc, c, M, N, m0, n0);
}

template <bool kAKMaj, bool kBKMaj, int BM, int BN>
int run_tc(const sm90::Operand& a, const sm90::Operand& b, void* c, int M,
           int N, int K, int batch, cudaStream_t s) {
  auto* kern = tiled_mm_tc_kernel<kAKMaj, kBKMaj, BM, BN>;
  const cudaError_t attr = sm90::allow_smem<BM, BN>(kern);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kern<<<grid, sm90::kThreads, sm90::Tiling<BM, BN>::kSmemBytes, s>>>(
      a, b, static_cast<__nv_bfloat16*>(c), M, N, K);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_tc(const sm90::Operand& A, const sm90::Operand& B, void* c,
              int M, int N, int K, int batch, int ta, int tb,
              cudaStream_t s) {
  if (ta && tb) return run_tc<false, true, BM, BN>(A, B, c, M, N, K, batch, s);
  if (ta) return run_tc<false, false, BM, BN>(A, B, c, M, N, K, batch, s);
  if (tb) return run_tc<true, true, BM, BN>(A, B, c, M, N, K, batch, s);
  return run_tc<true, false, BM, BN>(A, B, c, M, N, K, batch, s);
}

// Every trans pair of every built tiling (sm90::tile_built).
int launch_tc(const void* a, const void* b, void* c, int M, int N, int K,
              int batch, int ta, int tb, int bm, int bn, cudaStream_t s) {
  const sm90::Operand A = sm90::make_operand(a, ta ? K : M, ta ? M : K);
  const sm90::Operand B = sm90::make_operand(b, tb ? N : K, tb ? K : N);
  if (bm == 256)
    return launch_tc<256, 128>(A, B, c, M, N, K, batch, ta, tb, s);
  if (bn == 256)
    return launch_tc<128, 256>(A, B, c, M, N, K, batch, ta, tb, s);
  return launch_tc<128, 128>(A, B, c, M, N, K, batch, ta, tb, s);
}

}  // namespace

extern "C" int tiled_mm_route(int dtype, int M) {
  return sm90::tensor_core_route(dtype, M);
}

// M, N, K are the effective (A' M x K, B' K x N) sizes of one pair;
// batch pairs are stored back to back (1: an unbatched call).  dtype: 0 =
// float32, 1 = bfloat16.  bm / bn: the output tiling of the tensor-core
// route, one of sm90::tile_built's (the FMA route keeps its own tiles
// and ignores them).  The route is tiled_mm_route(dtype, M).
extern "C" int tiled_mm_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int batch, int dtype,
                               int trans_a, int trans_b, int bm, int bn,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || batch > 65535 ||
      !sm90::tile_built(bm, bn))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (sm90::tensor_core_route(dtype, M))
    return launch_tc(a, b, c, M, N, K, batch, trans_a, trans_b, bm, bn, s);
  if (dtype == 0)
    return M <= 16 ? launch<float, 16, 32>(a, b, c, M, N, K, batch, trans_a,
                                           trans_b, s)
                   : launch<float, 64, 64>(a, b, c, M, N, K, batch, trans_a,
                                           trans_b, s);
  return launch<__nv_bfloat16, 16, 32>(a, b, c, M, N, K, batch, trans_a,
                                       trans_b, s);
}
