"""Analysis of the port's steps (counterpart of ``repro.analysis``): the
roofline terms on the H100 (``roofline``), the walkers over the kernel
markers of a step and over a profiler trace (``trace``, in place of the
reference's HLO walker) and the qlint precision-flow auditor
(``qlint``)."""
from repro_torch.analysis.roofline import (HW, HW_H100, model_flops,
                                           roofline_terms)

__all__ = ["HW", "HW_H100", "roofline_terms", "model_flops"]
