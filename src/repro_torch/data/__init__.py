"""Deterministic LM data (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import ByteCorpus, SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "ByteCorpus", "make_pipeline"]
