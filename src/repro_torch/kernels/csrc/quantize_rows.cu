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
// Bound: bytes.  It reads each input element once or twice (the second
// read of a row hits L1/L2) and writes each once; at the slice's shapes
// (rows <= 512, cols = 768) it moves under 2 MB, so the launch and the
// per-row reduction latency dominate, not bandwidth.  Design answer: one
// pass per group with no scratch in device memory; making it fast (vector
// loads, several rows per block) is later work.
#include "codec.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                         int rows, int cols, int group_rows, int group_cols,
                         codec::Fmt f,
                         const unsigned int* __restrict__ tensor_amax) {
  const int r0 = blockIdx.x * group_rows, c0 = blockIdx.y * group_cols;
  const int r1 = min(r0 + group_rows, rows), c1 = min(c0 + group_cols, cols);
  const float amax = tensor_amax ? __uint_as_float(*tensor_amax)
                                 : codec::region_amax(x, cols, r0, r1, c0, c1);
  const T sc = codec::from_f32<T>(codec::group_scale(amax, f));
  const int w = c1 - c0, n = (r1 - r0) * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long idx = (long)(r0 + i / w) * cols + c0 + i % w;
    y[idx] = codec::qdq(x[idx], sc, f);
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
           codec::Fmt f, unsigned int* scratch, cudaStream_t s) {
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
  const dim3 grid((rows + gr - 1) / gr, (cols + gc - 1) / gc);
  const int threads = gr * gc >= 256 ? 256 : 128;
  quantize_rows_kernel<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols, gr, gc, f,
      tensor_amax);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: codec::Mode (not kPass).
// scratch: one zeroed uint32 on the device, used by tensor mode only.
extern "C" int quantize_rows_launch(const void* x, void* y, int rows,
                                    int cols, int dtype, int mode,
                                    float qmax, int emin, int mbits,
                                    int pow2, void* scratch, void* stream) {
  const codec::Fmt f{qmax, emin, mbits, pow2};
  auto* sc = static_cast<unsigned int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return 0;
  if (dtype == 0) return launch<float>(x, y, rows, cols, mode, f, sc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, rows, cols, mode, f, sc, s);
  return (int)cudaErrorInvalidValue;
}
