"""Quantization telemetry (counterpart of ``repro.telemetry``):
``collect`` (the taps, probes and metrics), ``writer`` (the JSONL log),
``profiler`` (step timing, phase spans, MFU) and ``controller`` (the
adaptive precision controller and plan searcher that act on the rows)."""
from repro_torch.telemetry.controller import PlanSearcher, PrecisionController

__all__ = ["PlanSearcher", "PrecisionController"]
