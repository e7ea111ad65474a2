// The tensor-core main loop that qmm_stream.cu and tiled_mm.cu share.
//
// One block owns one 128 x 128 output tile of y = A' . B' (A' M x K, B'
// K x N, bf16, f32 accumulators) and walks K in 128-wide steps, one quant
// group a step.  Two consumer warpgroups each own 64 output rows and
// issue, per K step, eight wgmma.mma_async m64n128k16 f32.bf16.bf16 with
// both operands read from shared memory through matrix descriptors; two
// more warpgroups only load and prepare stages (qmm_stream's QDQ is
// latency-bound on the CUDA cores, and 16 warps hide that latency better
// than 8).  A stage of the shared ring holds the step's A tile and B
// tile, each 128 stored rows x 128 contiguous elements as two 64-wide
// panels of 128-byte rows, 128-byte swizzled ([panel][row][64], 16-byte
// chunk index XOR row % 8).  Each operand is loaded in its stored layout:
// a K-major operand (A stored (M, K), or B stored (N, K) under trans_b)
// has the reduction axis along the rows, an MN-major one (A stored (K, M)
// under trans_a, B stored (K, N)) across them, and the descriptor's
// transpose bit tells wgmma which.  So no transposed copy of an operand
// reaches device memory.
//
// Loads are cp.async 16-byte chunks, zero-filled beyond the ragged M / N
// / K edges (a zero leaves every group's amax as the reference's zero
// padding does); an operand whose contiguous extent is not a multiple of
// 8 elements, or whose base is not 16-byte aligned, is loaded element by
// element in the same loop.  The ring has kStages stages and the loads
// run kStages - 1 steps ahead.  A step: wait for the stage, prep it
// (qmm_stream's in-place QDQ; nothing for tiled_mm), fence.proxy.async
// (the cp.async landing and prep's stores are generic-proxy writes that
// wgmma reads through the async proxy), barrier, issue and commit the
// step's products, wait for them, barrier, refill the stage they read.
// The loads of later steps stay in flight through it all.
//
// One summation order: every output element is summed over the K steps
// in increasing k by the same wgmma sequence, whatever M, the tile's
// place, the layouts or the kernel that runs the loop.  A row's result
// therefore does not depend on the other rows of the call, and the stream
// pipeline equals quantize pass + tiled_mm bit for bit: both run this
// loop on equal shared tiles.
#pragma once

#include "codec.cuh"

namespace sm90 {

constexpr int kTile = 128;                       // BM = BN = BK
constexpr int kStages = 3;
constexpr int kMmaThreads = 256;                 // two consumer warpgroups
constexpr int kThreads = 512;                    // + two that only prep
constexpr int kPanelBytes = kTile * 128;         // 128 rows x 128 bytes
constexpr int kOperandBytes = 2 * kPanelBytes;   // a 128 x 128 bf16 tile
constexpr int kStageBytes = 2 * kOperandBytes;   // A and B
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment
static_assert(kTile == codec::kGroup, "one K step is one quant group");

using bf16 = __nv_bfloat16;

// The route rule, of (dtype, M) alone: bf16 with M > 16 runs this loop;
// f32 (which tensor cores would take as TF32) and M <= 16 (decode: bytes-
// bound) keep the CUDA-core FMA kernels.  dtype: 0 = float32, 1 = bf16.
inline bool tensor_core_route(int dtype, int M) { return dtype == 1 && M > 16; }

// Byte offset of element (row, col) of a staged 128 x 128 operand tile.
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * kPanelBytes + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// One operand as stored: rows x cols row-major (cols contiguous);
// kmajor: the rows are the output's M (A) or N (B) axis and the
// reduction runs along the cols; otherwise the reverse.
struct Operand {
  const bf16* p;
  int rows, cols;
  bool vec;  // 16-byte chunks: cols % 8 == 0 and p 16-byte aligned
};

// The stored operand p (rows x cols) of a launch, on the host.
inline Operand make_operand(const void* p, int rows, int cols) {
  return Operand{static_cast<const bf16*>(p), rows, cols,
                 cols % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0};
}

// Point a block of a batched launch at its own pair (blockIdx.z): the
// pairs of a batch are stored back to back, a.rows x a.cols, b.rows x
// b.cols and an M x N output each.  Returns the output's offset.
__device__ __forceinline__ long to_pair(Operand& a, Operand& b, int M,
                                        int N) {
  a.p += blockIdx.z * (long)a.rows * a.cols;
  b.p += blockIdx.z * (long)b.rows * b.cols;
  return blockIdx.z * (long)M * N;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Load the 128 x 128 stored tile at (r0, c0) into the stage at dst,
// zero outside the operand.
__device__ __forceinline__ void load_tile(uint8_t* dst, const Operand& op,
                                          int r0, int c0) {
  if (op.vec) {
    const uint32_t base = smem_u32(dst);
    for (int i = threadIdx.x; i < kTile * 16; i += kThreads) {
      const int row = i >> 4, col = (i & 15) * 8;
      const int r = r0 + row, c = c0 + col;
      const bool in = r < op.rows && c < op.cols;
      const bf16* src = in ? op.p + (long)r * op.cols + c : op.p;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       base + swz(row, col)),
                   "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int row = i >> 7, col = i & 127;
      const int r = r0 + row, c = c0 + col;
      *reinterpret_cast<bf16*>(dst + swz(row, col)) =
          (r < op.rows && c < op.cols) ? op.p[(long)r * op.cols + c] : zero;
    }
  }
}

// The stage tile of operand op at output offset mn0 and K step k0.
template <bool kKMajor>
__device__ __forceinline__ void load_operand(uint8_t* dst,
                                             const Operand& op, int mn0,
                                             int k0) {
  if (kKMajor)
    load_tile(dst, op, mn0, k0);
  else
    load_tile(dst, op, k0, mn0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the accumulators in their registers across the asynchronous
// products (the compiler must not move them while a wgmma is in flight).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a 128-byte-swizzled operand: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (128B swizzle).
// K-major: SBO is the distance between 8-row groups (1024 bytes), LBO
// unused.  MN-major: SBO between 8-row groups along K (1024), LBO between
// 64-wide panels along M / N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d += A (64 x 16) . B (16 x 128); tnsp: the operand is MN-major.
template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTnspA), "n"(kTnspB)
      : "memory");
}

// The products of one K step of this warpgroup: its 64 rows of the A
// tile at a, the whole B tile at b, eight k16 slices in increasing k.
template <bool kAK, bool kBK>
__device__ __forceinline__ void step_products(float (&d)[64], uint32_t a,
                                              uint32_t b, int wg) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    // K-major: a k16 slice is 32 bytes along the row, in panel kk / 4;
    // MN-major: it is 16 rows (2048 bytes) down.
    const uint32_t ao = kAK ? (kk >> 2) * kPanelBytes + wg * 64 * 128 +
                                  (kk & 3) * 32
                            : wg * kPanelBytes + kk * 2048;
    const uint32_t bo = kBK ? (kk >> 2) * kPanelBytes + (kk & 3) * 32
                            : kk * 2048;
    wgmma_m64n128k16<kAK ? 0 : 1, kBK ? 0 : 1>(
        d, make_desc(a + ao, kPanelBytes, 1024),
        make_desc(b + bo, kPanelBytes, 1024));
  }
}

// The main loop: acc (this thread's 64 f32 of the tile, zeroed by the
// caller) += A'[m0:m0+128, :] . B'[:, n0:n0+128].  prep(a_tile, b_tile,
// k0) runs on every stage after it lands and before its products, with
// the whole block; it may rewrite the tiles in place (generic stores,
// element (row, col) at swz(row, col)).  A step waits for its own
// products before the barrier: products left in flight across the next
// step (its prep calls the IEEE division's slow path, and only two of the
// four warpgroups issue wgmma) made ptxas serialize every wgmma of the
// loop (C7515 / C7518).  smem: kSmemBytes of dynamic shared memory.
template <bool kAK, bool kBK, typename Prep>
__device__ __forceinline__ void mainloop(float (&acc)[64], uint8_t* smem_raw,
                                         const Operand& a, const Operand& b,
                                         int m0, int n0, int K, Prep prep) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg = threadIdx.x >> 7;
  const bool mma = threadIdx.x < kMmaThreads;  // warpgroup-uniform
  const int nk = (K + kTile - 1) / kTile;
  auto tile_a = [&](int s) { return smem + s * kStageBytes; };
  auto tile_b = [&](int s) { return smem + s * kStageBytes + kOperandBytes; };
  auto load = [&](int kt) {
    const int s = kt % kStages;
    load_operand<kAK>(tile_a(s), a, m0, kt * kTile);
    load_operand<kBK>(tile_b(s), b, n0, kt * kTile);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of step kt
    __syncthreads();               // everyone's
    prep(tile_a(s), tile_b(s), kt * kTile);
    fence_proxy_async();
    __syncthreads();
    if (mma) {
      fence_acc(acc);
      wgmma_fence();
      step_products<kAK, kBK>(acc, smem_u32(tile_a(s)), smem_u32(tile_b(s)),
                              wg);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<0>();
      fence_acc(acc);
    }
    __syncthreads();               // both warpgroups': its stage is free
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
  }
  if (mma) {
    wgmma_wait<0>();
    fence_acc(acc);
  }
}

// Store this thread's accumulators of the tile at (m0, n0) into the
// row-major (M, N) output, rounded to T (nearest even), masked at the
// ragged edges.  Fragment of m64nNk16: warp w of the warpgroup, lane l,
// holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1).
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           T* __restrict__ c, int M, int N,
                                           int m0, int n0) {
  if (threadIdx.x >= kMmaThreads) return;
  const int t = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int r0 = m0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = n0 + (t & 3) * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, n = c0 + 8 * j;
      if (r >= M) continue;
      T* out = c + (long)r * N + n;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N) {
        out[0] = codec::from_f32<T>(v0);
        out[1] = codec::from_f32<T>(v1);
      } else if (n < N) {
        out[0] = codec::from_f32<T>(v0);
      }
    }
}

// Let a kernel use kSmemBytes of dynamic shared memory; once per
// instantiation, before its first launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace sm90
