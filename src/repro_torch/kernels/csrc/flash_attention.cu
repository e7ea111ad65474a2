// flash_attention: causal online-softmax attention forward over (B*H, S, D)
// q and (B*KVH, S, D) k / v, output in q's dtype.
//
// Replaces repro/kernels/flash_attention.py::_fa_kernel (via
// flash_attention_fwd).  The TPU kernel walks the grid (B*H, S/bq, S/bk)
// with the KV axis innermost and sequential, carrying the running max m,
// the running sum l and the f32 accumulator in VMEM scratch across it.
// Hopper blocks run in no order, so here one block owns one (b*h, q tile)
// and runs the KV loop itself, with m, l and acc in registers.  Two
// routes, chosen by dtype alone (tensor_core_route): bf16 runs
// flash_fwd_tc_kernel on the tensor cores, f32 keeps flash_fwd_kernel on
// CUDA-core FMAs (its bar, f32 rtol 1e-5, is out of reach of bf16
// operands).  Both keep the reference's arithmetic: s = q.k in f32, times
// 1/sqrt(D); masked scores NEG_INF = -1e30; safe_m = 0 where the new max
// is still masked; corr = exp(m_prev - safe_m) zeroed where m_prev is
// masked; l floored at 1e-30 before one IEEE division at the end; IEEE
// expf (CUDA's documented maximum error 2 ulp; no fast math).  KV tiles
// wholly above the diagonal of every row of the block are not visited:
// for such a tile every p is 0 and corr is 1, so skipping (or masking)
// it changes no number.  GQA: q head h of batch b reads KV row
// (b*H + h) / rep = b*KVH + h / rep, the head jnp.repeat would give it,
// without repeating K / V in memory.
//
// flash_fwd_kernel (f32): one block per 64-row q tile; the q tile
// (pre-scaled: q cast to f32, then times 1/sqrt(D), as the reference) and
// each 64-key K / V tile in shared memory as f32; P through shared memory
// into the P.V product, kept f32 as the reference keeps p.  256 threads
// as 16 x 16: thread (ty, tx) owns the q rows ty + 16 i (i < 4), the key
// columns tx + 16 j of each score tile and the output columns tx + 16 c;
// a row's max and sum reduce over the 16 tx lanes of a half warp.
// Shared tiles are padded by one float a row against bank conflicts.
//
// flash_fwd_tc_kernel (bf16): one block per (b*h, 128-row q tile), two
// warpgroups of 64 q rows each; the grid runs the longest causal tiles
// (the last q tiles) first.  The q tile is staged once, the 64-key K and
// V tiles through a 2-stage cp.async ring; all tiles 128-byte swizzled
// in 64-wide panels of 128-byte rows (gemm_sm90.cuh's layout), D < 64
// staged zero-padded to 64 columns.  Per KV tile a warpgroup issues:
//   S = Q.K^T as wgmma m64n64k16 from shared memory, D / 16 of them (the
//     stored K tile is the K-major B operand).  bf16 x bf16 products are
//     exact in f32, so S differs from the exact dot only by the f32 sums.
//     S is then scaled in f32: for D = 16 and 64, 1/sqrt(D) is a power
//     of two and that equals the reference's pre-scaled q exactly; for
//     D = 32 and 128 it differs from f32(q * scale) . k by f32 rounding.
//     The plain version's bf16 scores are the exact dot rounded once to
//     f32, then scaled: at D = 128 with q, k, v ~ 3 N(0, 1) the
//     reference's own order (pre-scaled q, one f32 dot over 128 terms)
//     misses the card's gate (one bf16 ulp + 1e-5) against an f64
//     softmax on a few outputs near zero, where this kernel keeps within
//     it (chip_smoke.py's flash_precision reports both).
//   the online softmax on the accumulator fragment in registers (a row
//     lives in the 4 lanes of a quad: max and sum by two shuffles), the
//     mask only on tiles that cross the block's diagonal;
//   O += P.V as wgmma m64n{64,128}k16 with A = P from registers and B =
//     the stored V tile (MN-major: the transpose bit).  The reference
//     keeps p in f32; a bf16 P (relative error 2^-9) breaks the card's
//     absolute 1e-5 on outputs near zero after cancellation.  A two-term
//     split carries P to 2^-18, an output error up to 2^-18 max|v|: 5e-5
//     at the card tests' |v| <= ~13, on outputs whose bar is 1e-5.  So
//     P is split into three bf16 terms, P_hi = bf16(P), P_mid = bf16(P -
//     P_hi), P_lo = bf16(P - P_hi - P_mid) (each residual exact in f32),
//     whose products accumulate into the same f32 registers: P is
//     carried to 2^-27 relative.  l sums the f32 p, as the reference.
// Each batch of products is committed and waited for before the code
// that reads its registers; the two warpgroups (and two blocks an SM for
// D <= 64) overlap one another's softmax and products.
//
// Bound: gpt2-125m at batch 8 (96 x 1024 x 64 bf16): bytes, q, k, v read
// once and o written once (50 MB: 15 us at 3.35 TB/s); its causal
// operations (4 S^2 D / 2 per head, 12.9 GFLOP) take 13 us at the bf16
// tensor-core rate.  The tensor-core route does ~2.3x those operations
// (the split P triples P.V; masked halves of diagonal tiles) and ~56 M
// expf, which keep the CUDA cores about as busy as the tensor cores.
#include "gemm_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcBQ = 128, kTcBK = 64, kTcThreads = 256;

// The route rule, of dtype alone: 0 = float32 (FMA), 1 = bf16 (wgmma).
inline bool tensor_core_route(int dtype) { return dtype == 1; }

// Shared-memory plan of one head dimension: the staged width (D padded to
// a 64-wide panel), the q tile, one K or V tile, and the whole (q tile,
// two K / V stages, 1024 bytes of alignment slack).
template <int D>
struct TcPlan {
  static constexpr int kDp = D < 64 ? 64 : D;
  static constexpr int kQPanel = kTcBQ * 128, kKVPanel = kTcBK * 128;
  static constexpr int kQBytes = kDp / 64 * kQPanel;
  static constexpr int kKVBytes = kDp / 64 * kKVPanel;
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;
};

// Byte offset of the 16-byte chunk at (row, col) of a staged R-row tile.
template <int R>
__device__ __forceinline__ int tc_swz(int row, int col) {
  return (col >> 6) * (R * 128) + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

// Stage rows [r0, r0 + R) of a row-major (S, D) matrix at dst:
// cp.async 16-byte chunks, zero beyond S and in the padding columns.
template <int D, int R>
__device__ __forceinline__ void tc_load(uint8_t* dst,
                                        const bf16* __restrict__ g, int r0,
                                        int S) {
  constexpr int kChunks = TcPlan<D>::kDp / 8;
  const uint32_t base = sm90::smem_u32(dst);
  for (int i = threadIdx.x; i < R * kChunks; i += kTcThreads) {
    const int row = i / kChunks, col = (i % kChunks) * 8;
    const bool in = r0 + row < S && col < D;
    const bf16* src = in ? g + (long)(r0 + row) * D + col : g;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     base + tc_swz<R>(row, col)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Keep registers in place across asynchronous products.
template <int N>
__device__ __forceinline__ void fence_f32(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 16, shared, K-major) . B (16 x 64, shared, K-major).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d += A (64 x 16, registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1)
      : "memory");
}

// d += A (64 x 16, registers) . B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1)
      : "memory");
}

// O (64 x Dp) += P (64 x 16, registers) . V (16 x Dp, shared).
template <int N>
__device__ __forceinline__ void pv_product(float (&d)[N / 2],
                                           const uint32_t (&a)[16], int kk,
                                           uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_m64n64(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                    a[4 * kk + 3], db);
  else
    wgmma_rs_m64n128(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                     a[4 * kk + 3], db);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments (m64nNk16 accumulators): warp w of the warpgroup, lane l,
// holds rows 16 w + l / 4 (h = 0) and + 8 (h = 1), and of each 8-column
// chunk j the columns 8 j + 2 (l % 4) + {0, 1}: d[4 j + 2 h + {0, 1}].
// The A fragment of k16 slice kk is the same layout over the slice's 16
// keys, so P's slice kk is S's chunks 2 kk and 2 kk + 1, packed in pairs.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        int S, int rep, float scale, int causal) {
  using Plan = TcPlan<D>;
  constexpr int kAcc = Plan::kDp / 2;
  extern __shared__ uint8_t tc_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~uintptr_t(1023));
  auto k_tile = [&](int st) {
    return smem + Plan::kQBytes + st * 2 * Plan::kKVBytes;
  };
  auto v_tile = [&](int st) { return k_tile(st) + Plan::kKVBytes; };
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const bf16* qg = q + (long)bh * S * D;
  const bf16* kg = k + (long)(bh / rep) * S * D;
  const bf16* vg = v + (long)(bh / rep) * S * D;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int nt = (causal ? min(S, q0 + kTcBQ) : S) / kTcBK;

  tc_load<D, kTcBQ>(smem, qg, q0, S);
  tc_load<D, kTcBK>(k_tile(0), kg, 0, S);
  tc_load<D, kTcBK>(v_tile(0), vg, 0, S);
  sm90::cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const uint32_t q_base = sm90::smem_u32(smem) + wg * 64 * 128;

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1, k0 = it * kTcBK;
    sm90::cp_async_wait<0>();      // this thread's copies of tile it
    sm90::fence_proxy_async();     // visible to wgmma's async proxy
    __syncthreads();               // everyone's; tile it - 1 is done
    if (it + 1 < nt) {
      tc_load<D, kTcBK>(k_tile(st ^ 1), kg, k0 + kTcBK, S);
      tc_load<D, kTcBK>(v_tile(st ^ 1), vg, k0 + kTcBK, S);
    }
    sm90::cp_async_commit();

    // S = Q . K^T over the D / 16 real k16 slices
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_base = sm90::smem_u32(k_tile(st));
    fence_f32(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64(
          s,
          sm90::make_desc(q_base + (kk >> 2) * Plan::kQPanel + (kk & 3) * 32,
                          Plan::kQPanel, 1024),
          sm90::make_desc(k_base + (kk >> 2) * Plan::kKVPanel + (kk & 3) * 32,
                          Plan::kKVPanel, 1024));
    sm90::wgmma_commit();
    fence_f32(s);
    sm90::wgmma_wait<0>();
    fence_f32(s);

    // scale, and mask the tiles that cross this warpgroup's diagonal
    const bool diag = causal && k0 + kTcBK - 1 > q0 + wg * 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __fmul_rn(s[i], scale);
      const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
      if (diag && kpos > row0 + 8 * ((i >> 1) & 1)) s[i] = kNegInf;
    }
    // the online softmax of rows row0 (h = 0) and row0 + 8 (h = 1)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[h] = expf(m[h] - safe_m) * (m[h] > kNegInf / 2 ? 1.f : 0.f);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& p = s[4 * j + 2 * h + e];
          p = expf(p - safe_m);
          psum += p;
        }
      l[h] = l[h] * corr[h] + quad_sum(psum);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= corr[(i >> 1) & 1];
    // P = P_hi + P_mid + P_lo, each bf16, as A fragments (each residual
    // is exact in f32)
    uint32_t p_hi[16], p_mid[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      const float r0 = s[2 * i] - hf.x, r1 = s[2 * i + 1] - hf.y;
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const float2 mf = __bfloat1622float2(mid);
      p_hi[i] = bf16x2_bits(hi);
      p_mid[i] = bf16x2_bits(mid);
      p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
    }

    // O += P_hi . V + P_mid . V + P_lo . V, slice by slice in increasing
    // key order
    const uint32_t v_base = sm90::smem_u32(v_tile(st));
    fence_f32(acc);
    fence_u32(p_hi);
    fence_u32(p_mid);
    fence_u32(p_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t dv =
          sm90::make_desc(v_base + kk * 2048, Plan::kKVPanel, 1024);
      pv_product<Plan::kDp>(acc, p_hi, kk, dv);
      pv_product<Plan::kDp>(acc, p_mid, kk, dv);
      pv_product<Plan::kDp>(acc, p_lo, kk, dv);
    }
    sm90::wgmma_commit();
    fence_f32(acc);
    sm90::wgmma_wait<0>();
    fence_f32(acc);
    fence_u32(p_hi);
    fence_u32(p_mid);
    fence_u32(p_lo);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    const float li = fmaxf(l[h], 1e-30f);
    bf16* out = o + ((long)bh * S + row) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          __fdiv_rn(acc[4 * j + 2 * h], li),
          __fdiv_rn(acc[4 * j + 2 * h + 1], li));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int S, int rep, float scale, int causal, cudaStream_t s) {
  constexpr int bytes = TcPlan<D>::kSmem;
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (S + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, rep, scale,
      causal);
  return (int)cudaGetLastError();
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

int launch_tc_d(const void* q, const void* k, const void* v, void* o,
                int BH, int S, int D, int rep, float scale, int causal,
                cudaStream_t s) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 32: return launch_tc<32>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 64: return launch_tc<64>(q, k, v, o, BH, S, rep, scale, causal, s);
    case 128:
      return launch_tc<128>(q, k, v, o, BH, S, rep, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Whether a launch of dtype code dtype takes the tensor-core route.
extern "C" int flash_attention_route(int dtype) {
  return tensor_core_route(dtype);
}

// q, o: (BH, S, D); k, v: (BH / rep, S, D); all row-major contiguous (16-
// byte aligned on the tensor-core route).  S a multiple of 64, D in {16,
// 32, 64, 128}.  scale = f32(1 / sqrt(D)).  dtype: 0 = float32, 1 =
// bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int D, int rep, float scale,
                                      int causal, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (S % kBQ != 0 || rep <= 0) return (int)cudaErrorInvalidValue;
  if (tensor_core_route(dtype))
    return launch_tc_d(q, k, v, o, BH, S, D, rep, scale, causal, s);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, BH, S, D, rep, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
