"""Deterministic synthetic LM batches (counterpart of
``repro.data.pipeline.SyntheticLM``, numpy only, batches bitwise equal
to the reference's).

A batch is a pure function of the step index, so resuming needs only the
step counter.  Each sequence repeats a pattern drawn from a fixed bank,
with occasional noise tokens: learnable next-token structure, no data
files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM"]


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
        if self.global_batch % num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {num_hosts} hosts")
        n = self.global_batch // num_hosts
        rng = np.random.Generator(
            np.random.Philox(key=[self.seed * 2654435761 + step,
                                  host_id + 1]))
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
