"""Deterministic LM batches (counterpart of ``repro.data.pipeline``,
numpy only, batches bitwise equal to the reference's).

A batch is a pure function of the step index, so resuming needs only the
step counter.  ``SyntheticLM``: each sequence repeats a pattern drawn
from a fixed bank, with occasional noise tokens (learnable next-token
structure, no data files).  ``ByteCorpus``: byte-level windows of a text
blob (a built-in sample; nothing is downloaded).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["SyntheticLM", "ByteCorpus", "make_pipeline"]


def _per_host(global_batch: int, num_hosts: int) -> int:
    if global_batch % num_hosts:
        raise ValueError(f"global_batch {global_batch} does not split over "
                         f"{num_hosts} hosts")
    return global_batch // num_hosts


def _step_rng(seed: int, step: int, host_id: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=[seed * 2654435761 + step, host_id + 1]))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Periodic-pattern language over ``vocab_size`` tokens."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 512
    noise: float = 0.02

    def _bank(self) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(self.seed))
        return rng.integers(2, self.vocab_size, size=(self.n_patterns, 8),
                            dtype=np.int64)

    def batch(self, step: int, host_id: int = 0,
              num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """``{"tokens", "targets"}``, int32 (per_host, seq_len), targets
        the tokens shifted by one."""
        n = _per_host(self.global_batch, num_hosts)
        rng = _step_rng(self.seed, step, host_id)
        bank = self._bank()
        maxp = bank.shape[1]
        pat_idx = rng.integers(0, self.n_patterns, size=n)
        periods = 3 + (pat_idx % (maxp - 3))
        offs = rng.integers(0, maxp, size=n)
        pos = np.arange(self.seq_len + 1)[None, :]
        idx = (pos + offs[:, None]) % periods[:, None]
        toks = bank[pat_idx[:, None], idx]
        if self.noise > 0:
            mask = rng.random(toks.shape) < self.noise
            toks = np.where(mask, rng.integers(2, self.vocab_size,
                                               size=toks.shape), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


# The reference's built-in sample (the paper's abstract, repeated).
_SAMPLE_TEXT = (
    "The burgeoning computational demands for training large language "
    "models necessitate efficient methods, including quantized training, "
    "which leverages low-bit arithmetic operations to reduce costs. "
    "While FP8 precision has shown potential, leveraging FP4 remains "
    "challenging due to inherent quantization errors and limited "
    "representation capability. Mixed-precision quantization strategies "
    "tailored for different modules and training stages allow the "
    "precision level suitable to distinct components within the model. "
) * 64


@dataclasses.dataclass(frozen=True)
class ByteCorpus:
    """Byte-level LM over a text blob (default: the built-in sample);
    windows drawn per (seed, step) with the same Philox stream as
    ``SyntheticLM``."""

    seq_len: int
    global_batch: int
    seed: int = 0
    text: Optional[str] = None
    vocab_size: int = 256

    def _data(self) -> np.ndarray:
        return np.frombuffer((self.text or _SAMPLE_TEXT).encode("utf-8"),
                             dtype=np.uint8)

    def batch(self, step: int, host_id: int = 0,
              num_hosts: int = 1) -> Dict[str, np.ndarray]:
        n = _per_host(self.global_batch, num_hosts)
        data = self._data()
        rng = _step_rng(self.seed, step, host_id)
        starts = rng.integers(0, len(data) - self.seq_len - 1, size=n)
        win = np.stack([data[s:s + self.seq_len + 1] for s in starts])
        return {"tokens": win[:, :-1].astype(np.int32),
                "targets": win[:, 1:].astype(np.int32)}


def make_pipeline(kind: str, vocab_size: int, seq_len: int,
                  global_batch: int, seed: int = 0):
    """``"synthetic"`` (``SyntheticLM``) or ``"bytes"`` (``ByteCorpus``,
    256 tokens whatever ``vocab_size`` says, as the reference's)."""
    if kind == "synthetic":
        return SyntheticLM(vocab_size, seq_len, global_batch, seed)
    if kind == "bytes":
        return ByteCorpus(seq_len, global_batch, seed)
    raise ValueError(f"unknown pipeline {kind!r}")
