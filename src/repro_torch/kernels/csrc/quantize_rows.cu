// quantize_rows: QDQ of a (rows, cols) operand in quant orientation, each
// element exactly once, groups along the columns (the reduction axis).
//
// Replaces repro/kernels/fp4_matmul.py::_quant_kernel (via
// _quantize_operand), the two-pass pipeline's phase 1.  On the TPU, token
// and tensor scales need a two-sweep sequential grid (amax into scratch in
// sweep 0, quantize in sweep 1).  Hopper blocks run in no order, so a
// scale whose group spans blocks is reduced across blocks first, by a
// kernel of its own that takes each block's max with fmaxf from 0 (which
// drops NaN, as region_amax does) and combines the blocks with atomicMax
// on the f32 bits (non-negative floats order like unsigned ints) into a
// buffer the wrapper zeroes.  Max is exact and order-free, so the scale,
// and with it every QDQ value, is the same whichever block owns what.
//
// Three launch shapes, each spread over the whole card:
//   row-major token / tensor groups (quantize_tok_kernel): one warp per
//     quant row, 8 rows a block, 16-byte vector loads and stores; the
//     amax is a warp shuffle max (tensor mode reads the whole-tensor
//     amax instead) and the QDQ runs from the registers that loaded the
//     row (rows up to kCache * 32 vectors; a longer row's tail is read
//     again, from L1).
//   transposed block / token / tensor groups (quantize_cols_kernel): the
//     operand is stored (cols, rows), so a quant row is a stored column.
//     A block owns a strip of 32 neighbouring quant rows (a lane each, so
//     a warp load is 32 neighbouring elements of one stored row) by one
//     128-wide group of quant columns (128 stored rows, 16 a warp, held
//     in registers between the amax and the QDQ).  768 x 8192 runs 24 x
//     64 = 1536 blocks.  (A lane on a bf16x2 of two quant rows, a whole
//     128-byte line a warp load, halves the blocks and ran slower.)  A
//     block group is the block's own chunk (amax from shared memory); a
//     token group spans every chunk of the strip, so col_amax_kernel
//     reduces it across blocks first (the second read of the operand
//     hits L2 at the training shapes' 12.6 MB).
//   tile groups and row-major block groups (quantize_rows_kernel): one
//     block per group, as the first version.
// Under emit_trans the result is written (cols, rows); a transposed read
// with emit_trans keeps each warp store on one line, a transposed read
// without it (quantize_panels) writes element by element.
//
// A data-parallel rank holds a share of the token axis; a tensor group,
// or a token group along the tokens, must take its amax over every rank's
// share.  The entry then runs in two calls (amax_phase 1 and 2): the amax
// kernel into the zeroed words, then, once the caller has all-reduced
// those words (MAX, over the data group: the words are non-negative f32
// bits, which order as integers), the QDQ kernel reading them.  A
// tensor-parallel rank holds a block of a row-parallel operand's K: a
// row-major token group (one quant row) then spans the model group's
// ranks too, so the two calls take it as well (row_amax_kernel writes
// each row's amax into its word; the token kernel reads it).
//
// Stochastic rounding (sr) keys each element's noise by its (quant row,
// col) plus the operand's origin (row0, col0), whatever block owns it.
// The stats epilogue (collect_stats) writes one row partial per (quant
// row, k-slab) into a (rows, k-slabs, 8) buffer in codec::row_stats's
// lane layout (lane l holds columns k0 + l + 32 j); codec.cuh's fold
// kernels then fold the buffer in the canonical order.  The epilogue
// re-computes the QDQ, which is deterministic: row-major launches
// re-read their row from L1 (lanes on neighbouring columns), transposed
// launches stage their 128 x strip tile in shared memory, padded so that
// lanes walking down a quant row's columns hit 32 different banks.
//
// Bound: bytes.  Each input element is read once (twice for a transposed
// token group; the second read hits L2) and each output written once:
// 8192 x 768 bf16 moves 25.2 MB, 7.5 us at 3.35 TB/s.  A QDQ costs ~50
// instructions (two IEEE divisions), so the CUDA cores need about as long
// as the bytes at these shapes.
//
// Batched launches (the MoE experts' operands, quantized as the reference's
// jax.vmap quantizes them): batch operands of rows x cols stored back to
// back, every kernel of the launch with blockIdx.z as the operand.  A
// block offsets its pointers to its operand (and the cross-block amax
// buffers to its operand's slots), so a tensor group is one operand, a
// token or block group never leaves its operand, the SR noise is keyed by
// the in-operand coordinates, and every operand's result equals the same
// launch on that operand alone, bit for bit.  A batched launch has no
// stats epilogue.
#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;  // 16-byte vectors a lane keeps of its row
constexpr int kChunkRows = codec::kGroup / kWarps;  // a warp's stored rows

// V neighbouring elements, loaded and stored as one (16 bytes for V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The stats epilogue of quant row r, slab ks: a whole warp; x is read in
// the stored layout (transposed under trans).
template <typename T>
__device__ __forceinline__ void slab_stats(
    const T* __restrict__ x, int rows, int cols, int trans, int r, int ks,
    float s, const codec::Fmt& f, const codec::Sr& sr, int n_ks,
    float* __restrict__ part) {
  const int lane = threadIdx.x & 31, k0 = ks * codec::kGroup;
  const T sc = codec::from_f32<T>(s);
  float xv[4], qv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = k0 + lane + 32 * j;
    xv[j] = qv[j] = 0.f;
    if (c < cols) {
      const T xt = x[trans ? (long)c * rows + r : (long)r * cols + c];
      xv[j] = codec::to_f32(xt);
      qv[j] = codec::to_f32(codec::qdq(xt, sc, f, codec::noise(sr, r, c)));
    }
  }
  codec::row_stats(xv, qv, s, f, min(codec::kGroup, cols - k0),
                   part + ((long)r * n_ks + ks) * codec::kStats);
}

// Tile groups and row-major block groups: one block per gr x gc group.
// kExtra compiles in SR and the stats epilogue (a launch with neither
// runs the kernel without them).
template <typename T, bool kExtra>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                         int rows, int cols, int group_rows, int group_cols,
                         codec::Fmt f, int trans, int emit_trans,
                         codec::Sr sr, float* __restrict__ part, int n_ks) {
  const int r0 = blockIdx.x * group_rows, c0 = blockIdx.y * group_cols;
  const int r1 = min(r0 + group_rows, rows), c1 = min(c0 + group_cols, cols);
  x += blockIdx.z * (long)rows * cols;  // this block's operand of a batch
  y += blockIdx.z * (long)rows * cols;
  const float amax =
      trans ? codec::region_amax(x, rows, c0, c1, r0, r1)  // axes swapped
            : codec::region_amax(x, cols, r0, r1, c0, c1);
  const float s = codec::group_scale(amax, f);
  const T sc = codec::from_f32<T>(s);
  const int h = r1 - r0, w = c1 - c0, n = h * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // the stored layout's contiguous axis runs fastest
    const int r = trans ? r0 + i % h : r0 + i / w;
    const int c = trans ? c0 + i / h : c0 + i % w;
    const long rc = (long)r * cols + c, cr = (long)c * rows + r;
    y[emit_trans ? cr : rc] = codec::qdq(
        x[trans ? cr : rc], sc, f, kExtra ? codec::noise(sr, r, c) : -1.f);
  }
  if (kExtra && part) {  // groups start on 128-column boundaries
    const int ks0 = c0 / codec::kGroup;
    const int nsl = (c1 - c0 + codec::kGroup - 1) / codec::kGroup;
    for (int i = threadIdx.x >> 5; i < h * nsl; i += blockDim.x >> 5)
      slab_stats(x, rows, cols, trans, r0 + i / nsl, ks0 + i % nsl, s, f,
                 sr, n_ks, part);
  }
}

// QDQ of V neighbouring elements of quant row r from column c.
template <typename T, int V, bool kExtra>
__device__ __forceinline__ Vec<T, V> qdq_vec(const Vec<T, V>& a, T sc,
                                             const codec::Fmt& f,
                                             const codec::Sr& sr, int r,
                                             int c) {
  Vec<T, V> out;
#pragma unroll
  for (int e = 0; e < V; ++e)
    out.v[e] = codec::qdq(a.v[e], sc, f,
                          kExtra ? codec::noise(sr, r, c + e) : -1.f);
  return out;
}

// Row-major token and tensor groups: one warp per quant row, V elements
// (16 bytes, or 1 when the row is not 16-byte aligned) a lane load.
// amax: the whole-tensor amax (tensor mode), each row's given amax
// (per_row: a token group shared over ranks), or null: the row's own.
template <typename T, int V, bool kExtra>
__global__ void __launch_bounds__(kThreads)
    quantize_tok_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int rows, int cols, codec::Fmt f, int emit_trans,
                        const unsigned int* __restrict__ amax, int per_row,
                        codec::Sr sr, float* __restrict__ part, int n_ks) {
  using P = Vec<T, V>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave; no block barrier follows
  x += blockIdx.z * (long)rows * cols;
  y += blockIdx.z * (long)rows * cols;
  if (amax) amax += blockIdx.z * (per_row ? (long)rows : 1L);
  const P* xr = reinterpret_cast<const P*>(x + (long)r * cols);
  const int nv = cols / V;
  P cache[kCache];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kCache; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) {
      cache[j] = xr[i];
#pragma unroll
      for (int e = 0; e < V; ++e)
        m = fmaxf(m, fabsf(codec::to_f32(cache[j].v[e])));
    }
  }
  if (!amax) {
    for (int i = lane + 32 * kCache; i < nv; i += 32) {
      const P a = xr[i];
#pragma unroll
      for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(codec::to_f32(a.v[e])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  const float s = codec::group_scale(
      amax ? __uint_as_float(amax[per_row ? r : 0]) : m, f);
  const T sc = codec::from_f32<T>(s);
  auto put = [&](int i, const P& q) {
    if (emit_trans) {
#pragma unroll
      for (int e = 0; e < V; ++e) y[(long)(i * V + e) * rows + r] = q.v[e];
    } else {
      reinterpret_cast<P*>(y + (long)r * cols)[i] = q;
    }
  };
#pragma unroll
  for (int j = 0; j < kCache; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) put(i, qdq_vec<T, V, kExtra>(cache[j], sc, f, sr, r, i * V));
  }
  for (int i = lane + 32 * kCache; i < nv; i += 32)
    put(i, qdq_vec<T, V, kExtra>(xr[i], sc, f, sr, r, i * V));
  if (kExtra && part)  // lanes on neighbouring columns: L1 hits
    for (int ks = 0; ks < n_ks; ++ks)
      slab_stats(x, rows, cols, 0, r, ks, s, f, sr, n_ks, part);
}

// Element (quant row r, col c) of an operand stored (cols, rows); zero
// outside it.
template <typename T>
__device__ __forceinline__ T load_col(const T* __restrict__ x, int rows,
                                      int cols, int r, int c) {
  return r < rows && c < cols ? x[(long)c * rows + r]
                              : codec::from_f32<T>(0.f);
}

// The max of |x| of this lane's quant row over the block's chunk: over
// its warp's stored rows, then over the warps.  Ends with a barrier.
template <typename T>
__device__ __forceinline__ float strip_max(const T (&xv)[kChunkRows]) {
  __shared__ float part_max[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kChunkRows; ++i)
    m = fmaxf(m, fabsf(codec::to_f32(xv[i])));
  part_max[warp][lane] = m;
  __syncthreads();
  m = part_max[0][lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, part_max[w][lane]);
  __syncthreads();
  return m;
}

// The amax of each transposed token group (a whole stored column),
// reduced across the column's chunks: atomicMax into row_amax (zeroed).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    col_amax_kernel(const T* __restrict__ x, int rows, int cols,
                    unsigned int* __restrict__ row_amax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + lane, c0 = blockIdx.y * codec::kGroup;
  x += blockIdx.z * (long)rows * cols;
  row_amax += blockIdx.z * (long)rows;
  T xv[kChunkRows];
#pragma unroll
  for (int i = 0; i < kChunkRows; ++i)
    xv[i] = load_col(x, rows, cols, r, c0 + warp + kWarps * i);
  const float amax = strip_max(xv);
  if (warp == 0 && r < rows) atomicMax(row_amax + r, __float_as_uint(amax));
}

// Transposed block / token / tensor groups: a strip of 32 quant rows (a
// lane each) by the 128 columns [c0, c0 + 128) (stored rows; warp w
// holds w, w + 8, ...).  amax_in: null (block groups: the chunk's own
// amax), per quant row (token, per_row) or one value (tensor).
template <typename T, bool kExtra>
__global__ void __launch_bounds__(kThreads, 4)
    quantize_cols_kernel(const T* __restrict__ x, T* __restrict__ y,
                         int rows, int cols, codec::Fmt f, int emit_trans,
                         const unsigned int* __restrict__ amax_in,
                         int per_row, codec::Sr sr, float* __restrict__ part,
                         int n_ks) {
  // the stats epilogue's staged tile, [column][quant row]: a pitch of 33
  // puts the 32 columns a warp reads for one quant row in 32 banks
  __shared__ T tile[kExtra ? codec::kGroup : 1][kExtra ? 33 : 1];
  __shared__ float row_scale[kExtra ? 32 : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip0 = blockIdx.x * 32, r = strip0 + lane;
  const int c0 = blockIdx.y * codec::kGroup;
  x += blockIdx.z * (long)rows * cols;
  y += blockIdx.z * (long)rows * cols;
  if (amax_in) amax_in += blockIdx.z * (long)(per_row ? rows : 1);
  T xv[kChunkRows];
#pragma unroll
  for (int i = 0; i < kChunkRows; ++i)
    xv[i] = load_col(x, rows, cols, r, c0 + warp + kWarps * i);
  const float s = codec::group_scale(
      amax_in ? __uint_as_float(amax_in[per_row ? min(r, rows - 1) : 0])
              : strip_max(xv),
      f);
  const T sc = codec::from_f32<T>(s);
  if (r < rows)
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) {
      const int c = c0 + warp + kWarps * i;
      if (c < cols)
        y[emit_trans ? (long)c * rows + r : (long)r * cols + c] = codec::qdq(
            xv[i], sc, f, kExtra ? codec::noise(sr, r, c) : -1.f);
    }
  if (kExtra && part) {
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) tile[warp + kWarps * i][lane] = xv[i];
    row_scale[lane] = s;
    __syncthreads();
    const int ks = c0 / codec::kGroup;
    for (int ri = warp; ri < min(32, rows - strip0); ri += kWarps) {
      const int rr = strip0 + ri;
      const T scr = codec::from_f32<T>(row_scale[ri]);
      float xs[4], qs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = lane + 32 * j, c = c0 + cc;
        xs[j] = qs[j] = 0.f;
        if (c < cols) {
          const T xt = tile[cc][ri];
          xs[j] = codec::to_f32(xt);
          qs[j] = codec::to_f32(
              codec::qdq(xt, scr, f, codec::noise(sr, rr, c)));
        }
      }
      codec::row_stats(xs, qs, row_scale[ri], f,
                       min(codec::kGroup, cols - c0),
                       part + ((long)rr * n_ks + ks) * codec::kStats);
    }
  }
}

// Each row-major quant row's amax into its word (amax_phase 1 of a token
// group shared over ranks): one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_amax_kernel(const T* __restrict__ x, int rows, int cols,
                    unsigned int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  x += blockIdx.z * (long)rows * cols + (long)r * cols;
  float m = 0.f;
  for (int c = lane; c < cols; c += 32)
    m = fmaxf(m, fabsf(codec::to_f32(x[c])));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) out[blockIdx.z * (long)rows + r] = __float_as_uint(m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tensor_amax_kernel(const T* __restrict__ x, long n,
                       unsigned int* __restrict__ out) {
  x += blockIdx.z * n;
  out += blockIdx.z;
  float m = 0.f;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(codec::to_f32(x[i])));
  m = codec::block_max(m);
  if (threadIdx.x == 0) atomicMax(out, __float_as_uint(m));
}

template <typename T, int V>
void launch_tok(const T* x, T* y, int rows, int cols, int batch,
                const codec::Fmt& f, int emit_trans,
                const unsigned int* amax, int per_row, const codec::Sr& sr,
                float* part, int n_ks, cudaStream_t s) {
  auto* kern = (sr.on || part) ? quantize_tok_kernel<T, V, true>
                               : quantize_tok_kernel<T, V, false>;
  kern<<<dim3((rows + kWarps - 1) / kWarps, 1, batch), kThreads, 0, s>>>(
      x, y, rows, cols, f, emit_trans, amax, per_row, sr, part, n_ks);
}

// amax_phase: 0 runs the whole QDQ; 1 only reduces a cross-block amax
// into the scratch; 2 only runs the QDQ, reading the scratch as given.
template <typename T>
int launch(const void* xv, void* yv, int rows, int cols, int batch,
           int mode, codec::Fmt f, int trans, int emit_trans,
           unsigned int* scratch, int amax_phase, codec::Sr sr, float* part,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int n_ks = (cols + codec::kGroup - 1) / codec::kGroup;
  const bool extra = sr.on || part;
  if (mode != codec::kBlock && mode != codec::kTile &&
      mode != codec::kToken && mode != codec::kTensor)
    return (int)cudaErrorInvalidValue;
  if (mode == codec::kTensor && amax_phase != 2) {  // into scratch[0]
    const long n = (long)rows * cols;
    const long want = (n + kThreads - 1) / kThreads;
    tensor_amax_kernel<T>
        <<<dim3(want < 1024 ? (int)want : 1024, 1, batch), kThreads, 0, s>>>(
            x, n, scratch);
  }
  if (amax_phase == 1) {  // the token groups' amax alone
    if (mode == codec::kToken && trans)
      col_amax_kernel<T><<<dim3((rows + 31) / 32, n_ks, batch), kThreads, 0,
                           s>>>(x, rows, cols, scratch);
    else if (mode == codec::kToken)
      row_amax_kernel<T><<<dim3((rows + kWarps - 1) / kWarps, 1, batch),
                           kThreads, 0, s>>>(x, rows, cols, scratch);
    return (int)cudaGetLastError();
  }
  if (mode == codec::kTile || (mode == codec::kBlock && !trans)) {
    const int gr = mode == codec::kTile ? codec::kGroup : 1;
    const dim3 grid((rows + gr - 1) / gr,
                    (cols + codec::kGroup - 1) / codec::kGroup, batch);
    auto* kern = extra ? quantize_rows_kernel<T, true>
                       : quantize_rows_kernel<T, false>;
    kern<<<grid, gr * codec::kGroup >= kThreads ? kThreads : 128, 0, s>>>(
        x, y, rows, cols, gr, codec::kGroup, f, trans, emit_trans, sr, part,
        n_ks);
  } else if (trans) {  // block, token, tensor: read transposed
    const dim3 grid((rows + 31) / 32, n_ks, batch);
    if (mode == codec::kToken && amax_phase == 0)
      col_amax_kernel<T><<<grid, kThreads, 0, s>>>(x, rows, cols, scratch);
    auto* kern = extra ? quantize_cols_kernel<T, true>
                       : quantize_cols_kernel<T, false>;
    kern<<<grid, kThreads, 0, s>>>(
        x, y, rows, cols, f, emit_trans,
        mode == codec::kBlock ? nullptr : scratch, mode == codec::kToken, sr,
        part, n_ks);
  } else {  // token, tensor: row-major
    constexpr int V = 16 / sizeof(T);
    // a shared token group reads its row's word (amax_phase 2)
    const int per_row = mode == codec::kToken && amax_phase == 2;
    const unsigned int* amax =
        mode == codec::kTensor || per_row ? scratch : nullptr;
    if (cols % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(y) % 16 == 0)
      launch_tok<T, V>(x, y, rows, cols, batch, f, emit_trans, amax,
                       per_row, sr, part, n_ks, s);
    else
      launch_tok<T, 1>(x, y, rows, cols, batch, f, emit_trans, amax,
                       per_row, sr, part, n_ks, s);
  }
  return (int)cudaGetLastError();
}

// Whether a launch of (mode, trans) reduces its amax across blocks first
// (tensor mode, a transposed token launch): it then needs the scratch.
inline bool cross_block_amax(int mode, int trans) {
  return mode == codec::kTensor || (mode == codec::kToken && trans);
}

}  // namespace

// rows x cols is the quant orientation of one operand; batch operands are
// stored back to back (1: an unbatched call; a batched call takes no
// stats).  x is stored (cols, rows) under trans, y is written (cols, rows)
// under emit_trans.  dtype: 0 = float32, 1 = bfloat16.  mode: codec::Mode
// (not kPass).  scratch: zeroed uint32s on the device, one per operand for
// tensor mode and one per quant row of each operand for a transposed token
// launch or a shared token launch (null otherwise).  amax_phase (tensor
// and token groups only): 0 the whole pass; 1 the amax alone, reduced
// into the scratch, and nothing written to y; 2 the QDQ alone, from the
// scratch as the caller left it (a shared amax: the caller all-reduces
// the words, MAX, over the ranks between 1 and 2).  sr / seed: stochastic rounding; row0 / col0:
// the operand's origin in quant orientation, added to each element's
// coordinates before its noise is drawn.  stats: null, or (row partials
// (rows, ceil(cols / 128), 8), slab partials (ceil(rows / 128),
// ceil(cols / 128), 8), the (8,) result) as three f32 device pointers,
// for the stats epilogue and its fold.
extern "C" int quantize_rows_launch(const void* x, void* y, int rows,
                                    int cols, int batch, int dtype, int mode,
                                    float qmax, int emin, int mbits,
                                    int pow2, int trans, int emit_trans,
                                    void* scratch, int amax_phase, int sr,
                                    unsigned int seed, unsigned int row0,
                                    unsigned int col0, void* part,
                                    void* slab, void* stats, void* stream) {
  const codec::Fmt f = codec::make_fmt(qmax, emin, mbits, pow2);
  const codec::Sr r{sr, seed, row0, col0};
  auto* sc = static_cast<unsigned int*>(scratch);
  auto* p = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch > 65535 || (batch > 1 && p)) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || cols <= 0 || batch <= 0) return 0;
  if (amax_phase != 0 && mode != codec::kTensor && mode != codec::kToken)
    return (int)cudaErrorInvalidValue;
  if ((cross_block_amax(mode, trans) || amax_phase != 0) != (sc != nullptr))
    return (int)cudaErrorInvalidValue;
  if (amax_phase < 0 || amax_phase > 2 || (amax_phase == 1 && p))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == 0)
    err = launch<float>(x, y, rows, cols, batch, mode, f, trans, emit_trans,
                        sc, amax_phase, r, p, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, y, rows, cols, batch, mode, f, trans,
                                emit_trans, sc, amax_phase, r, p, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err || !p) return err;
  codec::StatsJobs jobs{};
  jobs.job[0] = {p, static_cast<float*>(slab), static_cast<float*>(stats),
                 rows, (cols + codec::kGroup - 1) / codec::kGroup};
  codec::fold_stats(jobs, 1, s);
  return (int)cudaGetLastError();
}
