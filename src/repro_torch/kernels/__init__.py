"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  quantize_rows       the quantize pass      (csrc/quantize_rows.cu)
  qmm_stream          quantize fused into the K loop (csrc/qmm_stream.cu)
  tiled_mm            the matmul pass        (csrc/tiled_mm.cu)
  flash_attention     causal attention forward (csrc/flash_attention.cu)
  quantize            standalone blockwise QDQ (csrc/quantize_blockwise.cu)

The quantizing kernels share one rounding codec, ``csrc/codec.cuh``
(round to nearest, the counter-hash stochastic rounding, the stats
epilogue's fold), whose plain form is ``rounding.py`` / ``ref.py``.
``fp4_matmul.fused_qmm`` / ``ops.pallas_qmm`` orchestrate the matmul
kernels.  Kernels are built by ``build.py`` at first use; a wrapper given
a CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.
"""
