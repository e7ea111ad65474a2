"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  quantize_rows   the quantize pass      (csrc/quantize_rows.cu)
  qmm_stream      quantize fused into the matmul K loop (csrc/qmm_stream.cu)
  tiled_mm        the matmul pass        (csrc/tiled_mm.cu)

All three share one rounding codec, ``csrc/codec.cuh``, whose plain form
is ``rounding.py``.  ``fp4_matmul.fused_qmm`` / ``ops.pallas_qmm``
orchestrate them.  Kernels are built by ``build.py`` at first use; a
wrapper given a CPU tensor runs the plain version, a CUDA tensor launches
the kernel or raises.
"""
