// qmm_stream: y = Q(A') . Q(B') in one pass, the quantize fused into the
// matmul's K loop.  A' is (M, K), stored row-major as A (M, K), or as A
// (K, M) read transposed under trans_a; B' is (K, N), stored as B (K, N),
// or as B (N, K) under trans_b.  Modes per operand: pass, block (1x128
// groups along K) or tile (128x128).
//
// Replaces repro/kernels/fp4_matmul.py::_stream_kernel (via _stream_qmm;
// its QDQ is _qdq_stream_tile).  The TPU kernel walks (M/bm, N/bn, K/bk)
// in order, keeps the f32 accumulator in VMEM across the K grid axis and
// caches quantized panels in VMEM across revisits.  Hopper blocks run in
// no order, so one block owns one output tile, runs the K loop itself
// with the accumulator in registers, and re-quantizes the A and B tiles it
// reads; the codec is deterministic, so that gives the cached panel's
// bits.
//
// Route (gemm_sm90.cuh tensor_core_route, of dtype and M alone):
// - bf16, M > 16 (prefill, training): the tensor-core main loop of
//   gemm_sm90.cuh, which tiled_mm.cu runs too.  BM x BN output tiles
//   of the caller's choice (128 x 128, 128 x 256 or 256 x 128: the
//   reference's (bm, bn), resolved per call from the tuning table,
//   kernels/autotune.py), one 128-wide quant group a K step (bk = 128), a
//   cp.async ring in dynamic shared memory, wgmma m64n128k16 from
//   128-byte-swizzled tiles read in their stored layout (the trans flags
//   are the descriptors' transpose bits).  Between a stage's arrival and
//   its products the block QDQs the stage's A and B tiles in place: one
//   warp a quant row, lane l owning k = l + 32 j, with the unchanged
//   codec; a tile-mode group is 128 quant rows of the stage (two groups
//   in a 256-wide stage), so its amax is a block max over shared memory.
//   Bound: operations at every training shape, 2 M N K (8192 x 768 x
//   3072: 38.7 GFLOP, 39 us at 989 TFLOP/s bf16).  What holds it back is
//   the QDQ on the CUDA cores: each A tile is quantized N / BN times and
//   each B tile M / BM times (the TPU kernel's cache_a / cache_b has no
//   counterpart here yet), ~300 M QDQs of ~30 instructions at the FFN
//   shapes with 128 x 128 tiles; a 256-wide side halves the other
//   operand's share.  A pass x pass launch (the FFN dgrad) runs no QDQ
//   and is a plain GEMM.  The tiling never changes a value: the QDQ is
//   keyed by global coordinates and every output element is summed by
//   the same instructions in the same order.
// - f32 (tensor cores would take it as TF32), or M <= 16 (decode): CUDA-
//   core FMA with 16 x 32 tiles for M <= 16 and 32 x 32 otherwise (f32),
//   static shared memory; each K step loads the tiles (zero outside the
//   ragged edges), QDQs them in place and accumulates in k order.  Decode
//   is bytes-bound on the B panel (K x N bf16, 4.7 MB for the FFN up-
//   projection: 1.4 us at 3.35 TB/s) and its step is host-bound; reading
//   packed FP4 codes there is later work.
//
// Both routes sum each output element over k in increasing order and a
// row's result does not depend on M within a route, so the stream
// pipeline equals quantize_rows + tiled_mm (which follows the same rule)
// bit for bit.
//
// Stochastic rounding keys each element's noise by its global (row, col)
// in the operand's quant orientation, (m, k) for A and (n, k) for B (plus
// the operand's origin: a data-parallel rank's token rows are keyed where
// they lie in the global batch),
// never by the output tile the block owns: a tile that another block
// re-quantizes draws the same noise, as the reference's
// requantize-per-revisit branch does (fp4_matmul.py:786-819).  The stats
// epilogue folds each quantized element exactly once: only the blocks of
// the first output column (n0 == 0) write A's row partials and only those
// of the first output row (m0 == 0) write B's, one per (quant row,
// k-slab), computed from the shared tile before it is quantized in place;
// codec.cuh's two fold kernels fold them after the main kernel (into
// 128-row slabs, then the total), so the stats do not depend on the
// tiling either.
// Zero-filled ragged edges add nothing to any lane, and the count lane
// counts the columns inside K, which masks the padding as the reference's
// m_real / k_real do.  Each quant row is QDQ'd by one warp, so the
// epilogue's row partial is that warp's own reduction, the same as
// quantize_rows'.
//
// Batched launches (the MoE experts: the reference runs this kernel under
// jax.vmap, which adds the expert axis to its grid): batch operand pairs
// stored back to back, one launch with blockIdx.z as the pair.  A block
// offsets its base pointers to its pair and runs the unbatched code, so
// every pair equals the same kernel launched on that pair alone, bit for
// bit: a tile group's amax and a block group's never reach into another
// pair, and the SR noise is keyed by the in-pair coordinates, so every
// pair draws the same noise, as the vmapped TPU kernel does (its program
// ids are the unbatched grid's).  A batched launch has no stats epilogue
// (the reference's batched telemetry taps recompute their stats).
//
// Block amaxes passed in (a tensor-parallel rank holding part of a block /
// tile group: a row-parallel weight's K block, a column-parallel one's N
// block, smaller than the group edge).  The TPU kernel sees the whole
// group; a rank's tile holds part of it.  The entry then runs in two
// calls, as quantize_rows' shared amax does: amax_phase 1 writes each
// group's partial amax of the operands given a word buffer (uint32 f32
// bits, (groups along the quant rows, K groups), atomicMax into words the
// wrapper zeroed; one warp a quant row of a K group, group_amax_kernel),
// the caller reduces the words over the ranks each group spans, and
// amax_phase 2 runs the stream kernel taking each group's scale from its
// word instead of its staged tile.  The codec, the order of every sum and
// the noise are unchanged, so a rank's result is the slice of the whole
// group's.  Bound: bytes (one read of each operand for the amax pass).
// A batched call (the experts of an MoE layer whose d_ff is split inside
// every expert) takes one word buffer a pair, back to back: the amax
// kernel's blockIdx.z is the pair, as the product's, and each block reads
// its pair's words, so every pair is the unbatched entry on that pair.
#include "codec.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kBK = codec::kGroup;
constexpr int kPad = 2;        // shared-tile row pad (bank spread)
constexpr int kThreads = 256;  // 16 x 16

// One operand's quantization in a launch.
struct Operand {
  int mode;
  codec::Fmt f;
  codec::Sr sr;
  float* part;  // row partials (quant rows, n_ks, 8), or null: no stats
  // each group's amax as f32 bits ((rows or row groups, n_ks)) a pair,
  // or null: the group's amax comes from the staged tile
  const unsigned int* amax;
  long amax_pair;  // words a pair of a batch
};

// The scale of the group holding quant row grow at K step k0 from the
// passed-in words of this block's pair (block: a row's group; tile: its
// 128-row group).
__device__ __forceinline__ float passed_scale(const Operand& op, int grow,
                                              int k0, int n_ks) {
  const int g = op.mode == codec::kTile ? grow / codec::kGroup : grow;
  return codec::group_scale(
      __uint_as_float(op.amax[blockIdx.z * op.amax_pair + (long)g * n_ks +
                              k0 / kBK]),
      op.f);
}

// QDQ one quant row of a shared tile by one warp, in place: lane l owns
// the k = l + 32 j elements, at(j) their shared-memory slot.  The scale
// is the row's own (block mode) or the tile's (tile_s).  kExtra compiles
// in SR and the stats epilogue (a launch with neither runs the kernel
// without them); with stats, lane 0 writes the (grow, ks) row partial.
template <typename T, bool kExtra, typename At>
__device__ __forceinline__ void qdq_row(At at, const Operand& op,
                                        float tile_s, int grow, int k0,
                                        int K, int n_ks, bool stats) {
  float xv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) xv[j] = codec::to_f32(at(j));
  float s = tile_s;
  if (op.mode == codec::kBlock && op.amax) {
    s = passed_scale(op, grow, k0, n_ks);
  } else if (op.mode == codec::kBlock) {
    float m = fmaxf(fmaxf(fabsf(xv[0]), fabsf(xv[1])),
                    fmaxf(fabsf(xv[2]), fabsf(xv[3])));
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = codec::group_scale(m, op.f);
  }
  const T sc = codec::from_f32<T>(s);
  const int lane = threadIdx.x & 31;
  float qv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T q = codec::qdq(
        at(j), sc, op.f,
        kExtra ? codec::noise(op.sr, grow, k0 + lane + 32 * j) : -1.f);
    at(j) = q;
    qv[j] = codec::to_f32(q);
  }
  if constexpr (kExtra) {
    if (stats)
      codec::row_stats(
          xv, qv, s, op.f, min(kBK, K - k0),
          op.part + ((long)grow * n_ks + k0 / kBK) * codec::kStats);
  }
}

// QDQ the (BM x kBK) A tile in shared memory, groups along K; one warp a
// row.  A tile-mode group (128 rows) reaches past this block's BM rows:
// its amax comes from device memory (L2-resident after the first block
// reads it).
template <typename T, int BM, bool kExtra>
__device__ void qdq_a_tile(T (*As)[kBK + kPad], const T* __restrict__ a,
                           const Operand& op, int m0, int k0, int M, int K,
                           int trans_a, int n_ks, bool stats) {
  if (op.mode == codec::kPass) return;
  float tile_s = 0.f;
  if (op.mode == codec::kTile && op.amax) {
    tile_s = passed_scale(op, m0, k0, n_ks);
  } else if (op.mode == codec::kTile) {
    const int t0 = m0 - m0 % codec::kGroup, t1 = min(t0 + codec::kGroup, M);
    const int k1 = min(k0 + kBK, K);
    tile_s = codec::group_scale(
        trans_a ? codec::region_amax(a, M, k0, k1, t0, t1)
                : codec::region_amax(a, K, t0, t1, k0, k1), op.f);
  }
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BM; r += kThreads / 32)
    qdq_row<T, kExtra>([&](int j) -> T& { return As[r][lane + 32 * j]; }, op,
               tile_s, m0 + r, k0, K, n_ks, stats && m0 + r < M);
}

// QDQ the (kBK x BN) B tile in shared memory, groups along K (a quant row
// is a column of the tile); one warp a column.
template <typename T, int BN, bool kExtra>
__device__ void qdq_b_tile(T (*Bs)[BN + kPad], const T* __restrict__ b,
                           const Operand& op, int n0, int k0, int N, int K,
                           int trans_b, int n_ks, bool stats) {
  if (op.mode == codec::kPass) return;
  float tile_s = 0.f;
  if (op.mode == codec::kTile && op.amax) {
    tile_s = passed_scale(op, n0, k0, n_ks);
  } else if (op.mode == codec::kTile) {
    const int t0 = n0 - n0 % codec::kGroup, t1 = min(t0 + codec::kGroup, N);
    const int k1 = min(k0 + kBK, K);
    tile_s = codec::group_scale(
        trans_b ? codec::region_amax(b, K, t0, t1, k0, k1)
                : codec::region_amax(b, N, k0, k1, t0, t1), op.f);
  }
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < BN; c += kThreads / 32)
    qdq_row<T, kExtra>([&](int j) -> T& { return Bs[lane + 32 * j][c]; }, op,
               tile_s, n0 + c, k0, K, n_ks, stats && n0 + c < N);
}

// Held to 5 blocks an SM (at most 51 registers a thread): left free,
// nvcc gave some layouts 56-63 registers (4 blocks an SM), and the
// round-to-nearest FFN wgrad ran 5% slower than with 48 on an H100.
template <typename T, int BM, int BN, bool trans_a, bool trans_b,
          bool kExtra>
__global__ void __launch_bounds__(kThreads, 5)
    qmm_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int M, int N, int K, Operand oa,
                      Operand ob) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ T As[BM][kBK + kPad];
  __shared__ T Bs[kBK][BN + kPad];
  const int n_ks = (K + kBK - 1) / kBK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += blockIdx.z * (long)M * K;  // this block's pair of a batch
  b += blockIdx.z * (long)K * N;
  c += blockIdx.z * (long)M * N;
  // each quantized element's stats fold once (see the header)
  const bool stats_a = oa.part && n0 == 0;
  const bool stats_b = ob.part && m0 == 0;
  const T zero = codec::from_f32<T>(0.f);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
      const int ri = trans_a ? i % BM : i / kBK;
      const int ki = trans_a ? i / BM : i % kBK;
      const int r = m0 + ri, k = k0 + ki;
      As[ri][ki] = (r < M && k < K)
          ? a[trans_a ? (long)k * M + r : (long)r * K + k] : zero;
    }
    for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
      const int ki = trans_b ? i % kBK : i / BN;
      const int ni = trans_b ? i / kBK : i % BN;
      const int k = k0 + ki, n = n0 + ni;
      Bs[ki][ni] = (k < K && n < N)
          ? b[trans_b ? (long)n * K + k : (long)k * N + n] : zero;
    }
    __syncthreads();
    qdq_a_tile<T, BM, kExtra>(As, a, oa, m0, k0, M, K, trans_a, n_ks,
                              stats_a);
    qdq_b_tile<T, BN, kExtra>(Bs, b, ob, n0, k0, N, K, trans_b, n_ks,
                              stats_b);
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

// amax_phase 1: the partial amax of every group of one operand in quant
// orientation (rows, K), stored (rows, K) or, under trans, (K, rows): one
// warp a quant row of a 128-wide K group, lane l reading k = l + 32 j,
// atomicMax of the f32 bits into the group's word (tile: 128 rows share
// a word); blockIdx.z is the pair of a batch, per_pair its words.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_amax_kernel(const T* __restrict__ x, int rows, int K, int trans,
                      int tile, long per_pair,
                      unsigned int* __restrict__ words) {
  const int n_ks = (K + kBK - 1) / kBK;
  const int kg = blockIdx.x, lane = threadIdx.x & 31;
  const int r = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // a whole warp
  x += blockIdx.z * (long)rows * K;
  words += blockIdx.z * per_pair;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kg * kBK + lane + 32 * j;
    if (k < K)
      m = fmaxf(m, fabsf(codec::to_f32(
                       x[trans ? (long)k * rows + r : (long)r * K + k])));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0)
    atomicMax(words + (long)(tile ? r / codec::kGroup : r) * n_ks + kg,
              __float_as_uint(m));
}

// The words a pair of an operand of rows quant rows holds (groups along
// the rows, K groups).
long pair_words(int rows, int K, int mode) {
  const long groups =
      mode == codec::kTile ? (rows + codec::kGroup - 1) / codec::kGroup
                           : rows;
  return groups * ((K + kBK - 1) / kBK);
}

template <typename T>
int launch_amax(const void* x, int rows, int K, int batch, int trans,
                int mode, void* words, cudaStream_t s) {
  const dim3 grid((K + kBK - 1) / kBK,
                  (rows + kThreads / 32 - 1) / (kThreads / 32), batch);
  group_amax_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), rows, K, trans, mode == codec::kTile,
      pair_words(rows, K, mode), static_cast<unsigned int*>(words));
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, bool TA, bool TB>
void run(const void* a, const void* b, void* c, int M, int N, int K,
         int batch, const Operand& oa, const Operand& ob, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  auto* ap = static_cast<const T*>(a);
  auto* bp = static_cast<const T*>(b);
  if (oa.sr.on || ob.sr.on || oa.part || ob.part)
    qmm_stream_kernel<T, BM, BN, TA, TB, true><<<grid, kThreads, 0, s>>>(
        ap, bp, static_cast<T*>(c), M, N, K, oa, ob);
  else
    qmm_stream_kernel<T, BM, BN, TA, TB, false><<<grid, kThreads, 0, s>>>(
        ap, bp, static_cast<T*>(c), M, N, K, oa, ob);
}

// The trans flags are template arguments: the index arithmetic of a
// transposed load costs as much as the FMAs at decode shapes (M = 8), so
// each layout gets its own instantiation; so does a launch with SR or
// stats (run), keeping their code out of the round-to-nearest kernel.
template <typename T, int BM, int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           int batch, const Operand& oa, const Operand& ob, int ta, int tb,
           cudaStream_t s) {
  if (ta && tb)
    run<T, BM, BN, true, true>(a, b, c, M, N, K, batch, oa, ob, s);
  else if (ta)
    run<T, BM, BN, true, false>(a, b, c, M, N, K, batch, oa, ob, s);
  else if (tb)
    run<T, BM, BN, false, true>(a, b, c, M, N, K, batch, oa, ob, s);
  else
    run<T, BM, BN, false, false>(a, b, c, M, N, K, batch, oa, ob, s);
  return (int)cudaGetLastError();
}

// The tensor-core route: QDQ one staged operand tile in place: kExtent
// quant rows (A's M rows, B's N columns) of one 128-wide K step, in
// gemm_sm90.cuh's layout (kKMajor: quant rows are the stored rows).  A
// tile-mode group is 128 quant rows of the stage (one at extent 128, two
// at 256), zero outside the operand, so each group's amax is a block max
// over its part of the stage.  Quant rows past the operand (rows) are
// zero and stay zero: skipped.
template <bool kExtra, bool kKMajor, int kExtent>
__device__ __forceinline__ void qdq_stage(uint8_t* tile, const Operand& op,
                                          int mn0, int rows, int k0, int K,
                                          int n_ks, bool stats) {
  using bf16 = __nv_bfloat16;
  constexpr int kGroups = kExtent / codec::kGroup;
  constexpr int kStoredRows = kKMajor ? kExtent : sm90::kKStep;
  static_assert(kGroups == 1 || kGroups == 2, "a stage of 128 or 256 rows");
  if (op.mode == codec::kPass) return;
  float tile_s[kGroups] = {};
  if (op.mode == codec::kTile && op.amax) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      if (mn0 + codec::kGroup * j < rows)
        tile_s[j] = passed_scale(op, mn0 + codec::kGroup * j, k0, n_ks);
  } else if (op.mode == codec::kTile) {
    // Group g's bytes: K-major, rows 128 g .. 128 g + 127 of each 64-wide
    // panel of kExtent rows; MN-major, panels 2 g and 2 g + 1.
    const auto* w = reinterpret_cast<const __nv_bfloat162*>(tile);
    float m[kGroups] = {};
    for (int i = threadIdx.x; i < kExtent * sm90::kKStep / 2;
         i += sm90::kThreads) {
      const float2 v = __bfloat1622float2(w[i]);
      const float x = fmaxf(fabsf(v.x), fabsf(v.y));
      const int g = kGroups == 1 ? 0
                    : kKMajor    ? (i >> 12) & 1   // 4 i a byte, 16 KB
                                 : i >> 13;        // 32 KB a group
#pragma unroll
      for (int j = 0; j < kGroups; ++j)
        if (j == g) m[j] = fmaxf(m[j], x);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      tile_s[j] = codec::group_scale(codec::block_max(m[j]), op.f);
  }
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < kExtent && mn0 + q < rows;
       q += sm90::kThreads / 32)
    qdq_row<bf16, kExtra>(
        [&](int j) -> bf16& {
          const int k = lane + 32 * j;
          return *reinterpret_cast<bf16*>(
              tile + (kKMajor ? sm90::swz<kStoredRows>(q, k)
                              : sm90::swz<kStoredRows>(k, q)));
        },
        op, q < codec::kGroup ? tile_s[0] : tile_s[kGroups - 1], mn0 + q,
        k0, K, n_ks, stats);
}

// kAKMaj: A' is K-major (A stored (M, K)); kBKMaj: B' is K-major (B
// stored (N, K), trans_b).  (BM, BN): the output tiling (gemm_sm90.cuh).
template <bool kAKMaj, bool kBKMaj, bool kExtra, int BM, int BN>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    qmm_stream_tc_kernel(sm90::Operand a, sm90::Operand b,
                         __nv_bfloat16* __restrict__ c, int M, int N, int K,
                         Operand oa, Operand ob) {
  extern __shared__ uint8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  c += sm90::to_pair(a, b, M, N);
  const int n_ks = (K + kBK - 1) / kBK;
  // each quantized element's stats fold once (see the header)
  const bool stats_a = oa.part && n0 == 0;
  const bool stats_b = ob.part && m0 == 0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::mainloop<kAKMaj, kBKMaj, BM, BN>(
      acc, smem, a, b, m0, n0, K, [&](uint8_t* ta, uint8_t* tb, int k0) {
        qdq_stage<kExtra, kAKMaj, BM>(ta, oa, m0, M, k0, K, n_ks, stats_a);
        qdq_stage<kExtra, kBKMaj, BN>(tb, ob, n0, N, k0, K, n_ks, stats_b);
      });
  sm90::store_tile<BM, BN>(acc, c, M, N, m0, n0);
}

template <bool kAKMaj, bool kBKMaj, bool kExtra, int BM, int BN>
int run_tc(const sm90::Operand& a, const sm90::Operand& b, void* c, int M,
           int N, int K, int batch, const Operand& oa, const Operand& ob,
           cudaStream_t s) {
  auto* kern = qmm_stream_tc_kernel<kAKMaj, kBKMaj, kExtra, BM, BN>;
  const cudaError_t attr = sm90::allow_smem<BM, BN>(kern);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  kern<<<grid, sm90::kThreads, sm90::Tiling<BM, BN>::kSmemBytes, s>>>(
      a, b, static_cast<__nv_bfloat16*>(c), M, N, K, oa, ob);
  return (int)cudaGetLastError();
}

template <bool kExtra, int BM, int BN>
int launch_tc(const sm90::Operand& A, const sm90::Operand& B, void* c,
              int M, int N, int K, int batch, const Operand& oa,
              const Operand& ob, int ta, int tb, cudaStream_t s) {
  if (ta && tb)
    return run_tc<false, true, kExtra, BM, BN>(A, B, c, M, N, K, batch, oa,
                                               ob, s);
  if (ta)
    return run_tc<false, false, kExtra, BM, BN>(A, B, c, M, N, K, batch, oa,
                                                ob, s);
  if (tb)
    return run_tc<true, true, kExtra, BM, BN>(A, B, c, M, N, K, batch, oa,
                                              ob, s);
  return run_tc<true, false, kExtra, BM, BN>(A, B, c, M, N, K, batch, oa, ob,
                                             s);
}

// Every trans pair of every built tiling (sm90::tile_built).
template <bool kExtra>
int launch_tc(const void* a, const void* b, void* c, int M, int N, int K,
              int batch, const Operand& oa, const Operand& ob, int ta,
              int tb, int bm, int bn, cudaStream_t s) {
  const sm90::Operand A = sm90::make_operand(a, ta ? K : M, ta ? M : K);
  const sm90::Operand B = sm90::make_operand(b, tb ? N : K, tb ? K : N);
  if (bm == 256)
    return launch_tc<kExtra, 256, 128>(A, B, c, M, N, K, batch, oa, ob, ta,
                                       tb, s);
  if (bn == 256)
    return launch_tc<kExtra, 128, 256>(A, B, c, M, N, K, batch, oa, ob, ta,
                                       tb, s);
  return launch_tc<kExtra, 128, 128>(A, B, c, M, N, K, batch, oa, ob, ta, tb,
                                     s);
}

}  // namespace

extern "C" int qmm_stream_route(int dtype, int M) {
  return sm90::tensor_core_route(dtype, M);
}

// M, N, K are the effective (A' M x K, B' K x N) sizes of one pair;
// batch pairs are stored back to back (1: an unbatched call; a batched
// call takes no stats).  dtype: 0 = float32, 1 = bfloat16.  a_mode /
// b_mode: codec::kPass, kBlock or kTile.
// a_sr / a_seed (b_*): stochastic rounding of the operand; a_row0 /
// a_col0 (b_*): the operand's origin in quant orientation, added to each
// element's coordinates before its noise is drawn.  a_stats
// (b_stats): null, or three f32 device pointers (row partials (M, n_ks,
// 8), slab partials (ceil(M / 128), n_ks, 8), the (8,) result) for the
// stats epilogue and its fold, n_ks = ceil(K / 128); for B the quant rows
// are N.  bm / bn: the output tiling of the tensor-core route, one of
// sm90::tile_built's (the FMA route keeps its own tiles and ignores
// them).  The route is qmm_stream_route(dtype, M): the tensor-core kernel
// takes 193 KB of dynamic shared memory (3 stages of two 32 KB tiles at
// 128 x 128, 2 stages of 32 + 64 KB where one side is 256), the FMA
// kernels stay under the 48 KB static limit (f32 32x32 tiles, 34 KB with
// the pad; 16x32 for M <= 16).  a_amax / b_amax: null, or the operand's
// group words (block / tile, one buffer a pair; see the header): amax_phase 1
// fills them (zeroed by the caller) and launches nothing else, 2 runs the
// product reading them; 0 is the one-call entry (both null).
extern "C" int qmm_stream_launch(const void* a, const void* b, void* c,
                                 int M, int N, int K, int batch, int dtype,
                                 int a_mode,
                                 int b_mode, float a_qmax, int a_emin,
                                 int a_mbits, int a_pow2, float b_qmax,
                                 int b_emin, int b_mbits, int b_pow2,
                                 int trans_a, int trans_b, int a_sr,
                                 unsigned int a_seed, int b_sr,
                                 unsigned int b_seed, unsigned int a_row0,
                                 unsigned int a_col0, unsigned int b_row0,
                                 unsigned int b_col0, void** a_stats,
                                 void** b_stats, int bm, int bn,
                                 void* stream, void* a_amax, void* b_amax,
                                 int amax_phase) {
  const Operand oa{a_mode, codec::make_fmt(a_qmax, a_emin, a_mbits, a_pow2),
                   {a_sr, a_seed, a_row0, a_col0},
                   a_stats ? static_cast<float*>(a_stats[0]) : nullptr,
                   static_cast<const unsigned int*>(a_amax),
                   pair_words(M, K, a_mode)};
  const Operand ob{b_mode, codec::make_fmt(b_qmax, b_emin, b_mbits, b_pow2),
                   {b_sr, b_seed, b_row0, b_col0},
                   b_stats ? static_cast<float*>(b_stats[0]) : nullptr,
                   static_cast<const unsigned int*>(b_amax),
                   pair_words(N, K, b_mode)};
  auto s = static_cast<cudaStream_t>(stream);
  if (a_mode < codec::kPass || a_mode > codec::kTile ||
      b_mode < codec::kPass || b_mode > codec::kTile ||
      (dtype != 0 && dtype != 1) || batch > 65535 ||
      (batch > 1 && (a_stats || b_stats)) || !sm90::tile_built(bm, bn))
    return (int)cudaErrorInvalidValue;
  const bool words = a_amax || b_amax;
  if (amax_phase < 0 || amax_phase > 2 || (amax_phase == 0) == words ||
      (a_amax && a_mode == codec::kPass) ||
      (b_amax && b_mode == codec::kPass) ||
      (amax_phase == 1 && (a_stats || b_stats)))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (amax_phase == 1) {  // the operands' group amaxes alone
    // A's quant orientation is A' (M, K); B's is B'^T (N, K), stored
    // transposed unless trans_b
    int err = 0;
    if (a_amax)
      err = dtype ? launch_amax<__nv_bfloat16>(a, M, K, batch, trans_a,
                                               a_mode, a_amax, s)
                  : launch_amax<float>(a, M, K, batch, trans_a, a_mode,
                                       a_amax, s);
    if (!err && b_amax)
      err = dtype ? launch_amax<__nv_bfloat16>(b, N, K, batch, !trans_b,
                                               b_mode, b_amax, s)
                  : launch_amax<float>(b, N, K, batch, !trans_b, b_mode,
                                       b_amax, s);
    return err;
  }
  const bool extra = a_sr || b_sr || a_stats || b_stats;
  int err;
  if (sm90::tensor_core_route(dtype, M))
    err = extra ? launch_tc<true>(a, b, c, M, N, K, batch, oa, ob, trans_a,
                                  trans_b, bm, bn, s)
                : launch_tc<false>(a, b, c, M, N, K, batch, oa, ob, trans_a,
                                   trans_b, bm, bn, s);
  else if (dtype == 0)
    err = M <= 16 ? launch<float, 16, 32>(a, b, c, M, N, K, batch, oa, ob,
                                          trans_a, trans_b, s)
                  : launch<float, 32, 32>(a, b, c, M, N, K, batch, oa, ob,
                                          trans_a, trans_b, s);
  else
    err = launch<__nv_bfloat16, 16, 32>(a, b, c, M, N, K, batch, oa, ob,
                                        trans_a, trans_b, s);
  if (err || (!a_stats && !b_stats)) return err;
  const int n_ks = (K + kBK - 1) / kBK;
  codec::StatsJobs jobs{};
  int n = 0;
  auto add = [&](void** st, int rows) {
    if (st)
      jobs.job[n++] = {static_cast<const float*>(st[0]),
                       static_cast<float*>(st[1]), static_cast<float*>(st[2]),
                       rows, n_ks};
  };
  add(a_stats, M);
  add(b_stats, N);
  codec::fold_stats(jobs, n, s);
  return (int)cudaGetLastError();
}
