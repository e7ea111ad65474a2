"""Quantization telemetry (counterpart of ``repro.telemetry``):
``collect`` (the taps, probes and metrics), ``writer`` (the JSONL log)
and ``profiler`` (step timing, phase spans, MFU).  The adaptive
precision controller is not ported yet."""
