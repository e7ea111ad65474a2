// quantize_rows: QDQ of a (rows, cols) operand in quant orientation, each
// element exactly once, groups along the columns (the reduction axis).
//
// Replaces repro/kernels/fp4_matmul.py::_quant_kernel (via
// _quantize_operand), the two-pass pipeline's phase 1.  On the TPU, token
// and tensor scales need a two-sweep sequential grid (amax into scratch in
// sweep 0, quantize in sweep 1).  Hopper blocks run in no order, so here a
// group is owned by one block that makes both sweeps itself: token mode is
// one block per row (amax loop, then QDQ loop), block / tile modes one
// block per 1x128 / 128x128 group.  Tensor mode, whose group is the whole
// operand, reduces its amax across blocks first (atomicMax on the f32 bits,
// which order like unsigned ints for non-negative values) and then runs
// the block-mode grid with that amax.
//
// trans / emit_trans (the reference's flags): under trans the operand is
// stored (cols, rows) and read transposed; under emit_trans the result is
// written (cols, rows).  The backward matmuls quantize along their own
// reduction axis, which for wgrad's x^T and for a (K, N) weight is a
// column of the stored array: a 1 x 128 group is 128 stored rows of one
// column, and a token group a whole column.  Reading one such group per
// block would make every warp load touch 32 rows; instead a transposed
// block / token / tensor launch gives each block 32 neighbouring quant
// rows (lane = quant row, the 8 warps stride down the stored rows), so a
// warp reads 32 neighbouring elements of one stored row.  Transposed tile
// groups (128 x 128) keep one block per group and walk it with the stored
// row fastest.  No transposed copy of an operand is ever made.
//
// Stochastic rounding (sr) keys each element's noise by its (quant row,
// col), and the stats epilogue (collect_stats) writes one row partial per
// (quant row, k-slab) into a (rows, k-slabs, 8) buffer; codec.cuh's
// fold kernels then fold the buffer in the canonical order.  The
// epilogue re-reads its group from device memory (an L1 / L2 hit) and
// re-computes the QDQ, which is deterministic, so a warp owns each row
// partial whatever layout the QDQ loop walked.
//
// Bound: bytes.  It reads each input element once or twice (the second
// read of a group hits L1/L2) and writes each once.  At the serving
// shapes (rows <= 512, cols = 768) it moves under 2 MB, so the launch and
// the per-row reduction latency dominate; at the training shapes (8192 x
// 768 bf16, 12.6 MB each way) the bound is ~7.5 us.  Design answer: one
// pass per group with no scratch in device memory; making it fast (vector
// loads, several rows per block) is later work.
#include "codec.cuh"

namespace {

constexpr int kStrip = 32;  // quant rows per block of a transposed launch

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

// Row-major groups (or any tile group): one block per gr x gc group.
// kExtra compiles in SR and the stats epilogue (a launch with neither
// runs the kernel without them).
template <typename T, bool kExtra>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                         int rows, int cols, int group_rows, int group_cols,
                         codec::Fmt f, int trans, int emit_trans,
                         const unsigned int* __restrict__ tensor_amax,
                         codec::Sr sr, float* __restrict__ part, int n_ks) {
  const int r0 = blockIdx.x * group_rows, c0 = blockIdx.y * group_cols;
  const int r1 = min(r0 + group_rows, rows), c1 = min(c0 + group_cols, cols);
  float amax;
  if (tensor_amax)
    amax = __uint_as_float(*tensor_amax);
  else if (trans)  // stored (cols, rows): the same region, axes swapped
    amax = codec::region_amax(x, rows, c0, c1, r0, r1);
  else
    amax = codec::region_amax(x, cols, r0, r1, c0, c1);
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

// Transposed read, groups of one quant row (block, token, tensor): a
// strip of kStrip quant rows by the columns [c0, c0 + group_cols).
template <typename T, bool kExtra>
__global__ void __launch_bounds__(256)
    quantize_cols_kernel(const T* __restrict__ x, T* __restrict__ y,
                         int rows, int cols, int group_cols, codec::Fmt f,
                         int emit_trans,
                         const unsigned int* __restrict__ tensor_amax,
                         codec::Sr sr, float* __restrict__ part, int n_ks) {
  __shared__ float part_max[8][kStrip];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip0 = blockIdx.x * kStrip, r = strip0 + lane;
  const int c0 = blockIdx.y * group_cols, c1 = min(c0 + group_cols, cols);
  const bool live = r < rows;
  float amax;
  if (tensor_amax) {
    amax = __uint_as_float(*tensor_amax);
  } else {
    float m = 0.f;
    if (live)
      for (int c = c0 + warp; c < c1; c += 8)
        m = fmaxf(m, fabsf(codec::to_f32(x[(long)c * rows + r])));
    part_max[warp][lane] = m;
    __syncthreads();
    amax = part_max[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) amax = fmaxf(amax, part_max[w][lane]);
  }
  const float s = codec::group_scale(amax, f);  // of quant row r (lane)
  const T sc = codec::from_f32<T>(s);
  if (live)
    for (int c = c0 + warp; c < c1; c += 8) {
      const long cr = (long)c * rows + r;
      y[emit_trans ? cr : (long)r * cols + c] = codec::qdq(
          x[cr], sc, f, kExtra ? codec::noise(sr, r, c) : -1.f);
    }
  if (kExtra && part) {
    const int ks0 = c0 / codec::kGroup;
    const int nsl = (c1 - c0 + codec::kGroup - 1) / codec::kGroup;
    const int nr = min(kStrip, rows - strip0);
    for (int i = warp; i < nr * nsl; i += 8) {
      const int ri = i / nsl;  // the row's scale lives in lane ri
      slab_stats(x, rows, cols, 1, strip0 + ri, ks0 + i % nsl,
                 __shfl_sync(0xffffffffu, s, ri), f, sr, n_ks, part);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    tensor_amax_kernel(const T* __restrict__ x, long n,
                       unsigned int* __restrict__ out) {
  float m = 0.f;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(codec::to_f32(x[i])));
  m = codec::block_max(m);
  if (threadIdx.x == 0) atomicMax(out, __float_as_uint(m));
}

template <typename T>
int launch(const void* x, void* y, int rows, int cols, int mode,
           codec::Fmt f, int trans, int emit_trans, unsigned int* scratch,
           codec::Sr sr, float* part, cudaStream_t s) {
  int gr, gc;
  const unsigned int* tensor_amax = nullptr;
  switch (mode) {
    case codec::kBlock: gr = 1; gc = codec::kGroup; break;
    case codec::kTile: gr = codec::kGroup; gc = codec::kGroup; break;
    case codec::kToken: gr = 1; gc = cols; break;
    case codec::kTensor: {
      const long n = (long)rows * cols;
      const long want = (n + 255) / 256;
      const int blocks = want < 1024 ? (int)want : 1024;
      tensor_amax_kernel<T><<<blocks, 256, 0, s>>>(
          static_cast<const T*>(x), n, scratch);
      tensor_amax = scratch;
      gr = 1; gc = codec::kGroup;
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int n_ks = (cols + codec::kGroup - 1) / codec::kGroup;
  const bool extra = sr.on || part;
  if (trans && gr == 1) {
    const dim3 grid((rows + kStrip - 1) / kStrip, (cols + gc - 1) / gc);
    auto* kern = extra ? quantize_cols_kernel<T, true>
                       : quantize_cols_kernel<T, false>;
    kern<<<grid, 256, 0, s>>>(xp, yp, rows, cols, gc, f, emit_trans,
                              tensor_amax, sr, part, n_ks);
  } else {
    const dim3 grid((rows + gr - 1) / gr, (cols + gc - 1) / gc);
    const int threads = gr * gc >= 256 ? 256 : 128;
    auto* kern = extra ? quantize_rows_kernel<T, true>
                       : quantize_rows_kernel<T, false>;
    kern<<<grid, threads, 0, s>>>(xp, yp, rows, cols, gr, gc, f, trans,
                                  emit_trans, tensor_amax, sr, part, n_ks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows x cols is the quant orientation; x is stored (cols, rows) under
// trans, y is written (cols, rows) under emit_trans.  dtype: 0 = float32,
// 1 = bfloat16.  mode: codec::Mode (not kPass).  scratch: one zeroed
// uint32 on the device, used by tensor mode only.  sr / seed: stochastic
// rounding.  stats: null, or (row partials (rows, ceil(cols / 128), 8),
// slab partials (ceil(rows / 128), ceil(cols / 128), 8), the (8,) result)
// as three f32 device pointers, for the stats epilogue and its fold.
extern "C" int quantize_rows_launch(const void* x, void* y, int rows,
                                    int cols, int dtype, int mode,
                                    float qmax, int emin, int mbits,
                                    int pow2, int trans, int emit_trans,
                                    void* scratch, int sr, unsigned int seed,
                                    void* part, void* slab, void* stats,
                                    void* stream) {
  const codec::Fmt f = codec::make_fmt(qmax, emin, mbits, pow2);
  const codec::Sr r{sr, seed};
  auto* sc = static_cast<unsigned int*>(scratch);
  auto* p = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return 0;
  int err;
  if (dtype == 0)
    err = launch<float>(x, y, rows, cols, mode, f, trans, emit_trans, sc, r,
                        p, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, y, rows, cols, mode, f, trans,
                                emit_trans, sc, r, p, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err || !p) return err;
  codec::StatsJobs jobs{};
  jobs.job[0] = {p, static_cast<float*>(slab), static_cast<float*>(stats),
                 rows, (cols + codec::kGroup - 1) / codec::kGroup};
  codec::fold_stats(jobs, 1, s);
  return (int)cudaGetLastError();
}
