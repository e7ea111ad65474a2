"""Measured step time, phase spans and MFU (counterpart of
``repro.telemetry.profiler``).

* :func:`phase_span` names a region of the train loop in a
  ``torch.profiler`` trace (``record_function``, which also emits an NVTX
  range when NVTX capture is on); it costs a few microseconds of host
  time and nothing on the device.
* :class:`StepTimer` keeps post-warm-up step times (the caller times a
  step to a device synchronization, as ``Trainer`` does) and summarizes
  p50/p95/p99, tokens/s and MFU; a record over ``spike_factor`` x the
  running median is kept apart as a spike.
* :func:`train_step_flops` and :func:`device_peak_flops` give MFU's
  numerator (3 x forward matmul flops, no recompute) and denominator.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["phase_span", "percentiles", "StepTimer", "train_step_flops",
           "device_peak_flops"]


@contextlib.contextmanager
def phase_span(name: str):
    """Host-side span of a region of the train loop, by name in a
    ``torch.profiler`` trace."""
    with torch.profiler.record_function(name):
        yield


def percentiles(xs: Sequence[float],
                qs: Sequence[float] = (50.0, 95.0, 99.0)) -> Dict[str, float]:
    """Nearest-rank percentiles of ``xs`` as ``{"p50": ..., ...}``;
    empty input gives NaNs."""
    out: Dict[str, float] = {}
    s = sorted(xs)
    for q in qs:
        key = f"p{int(q) if float(q).is_integer() else q}"
        if not s:
            out[key] = float("nan")
            continue
        rank = max(1, -(-len(s) * q // 100))  # ceil(n*q/100), 1-based
        out[key] = float(s[int(rank) - 1])
    return out


class StepTimer:
    """Rolling wall-clock step statistics with warm-up exclusion.

    The first ``warmup`` records are counted (``n_total``) but left out of
    the statistics; kept times live in a window of ``window`` entries; a
    post-warm-up record above ``spike_factor`` x the window median (once
    3 are kept) is counted as a spike instead (``spike_factor=None``
    keeps everything)."""

    def __init__(self, warmup: int = 2, window: int = 1024,
                 spike_factor: Optional[float] = 20.0):
        self.warmup = warmup
        self.window = window
        self.spike_factor = spike_factor
        self.n_total = 0
        self.n_spikes = 0
        self._times: collections.deque = collections.deque(maxlen=window)
        self._spike_times: collections.deque = collections.deque(maxlen=16)

    def record(self, seconds: float) -> None:
        self.n_total += 1
        if self.n_total <= self.warmup:
            return
        t = float(seconds)
        if self.spike_factor is not None and len(self._times) >= 3:
            med = percentiles(self._times, qs=(50.0,))["p50"]
            if t > self.spike_factor * med:
                self.n_spikes += 1
                self._spike_times.append(t)
                return
        self._times.append(t)

    @property
    def times(self) -> List[float]:
        """Post-warm-up step times (seconds), oldest first."""
        return list(self._times)

    def summary(self, tokens_per_step: Optional[float] = None,
                flops_per_step: Optional[float] = None,
                peak_flops: Optional[float] = None) -> Dict[str, float]:
        """``steps``, ``warmup``, ``spikes`` (and ``spike_max_ms``),
        ``mean_ms`` / ``p50_ms`` / ``p95_ms`` / ``p99_ms``, and with the
        model's numbers ``tokens_per_sec``, ``flops_per_sec`` and ``mfu``
        at the p50 step."""
        ts = self.times
        out: Dict[str, float] = {"steps": len(ts), "warmup": self.warmup,
                                 "spikes": self.n_spikes}
        if self.n_spikes:
            out["spike_max_ms"] = max(self._spike_times) * 1e3
        if not ts:
            return out
        pct = percentiles(ts)
        out["mean_ms"] = sum(ts) / len(ts) * 1e3
        for k, v in pct.items():
            out[f"{k}_ms"] = v * 1e3
        p50 = pct["p50"]
        if tokens_per_step is not None and p50 > 0:
            out["tokens_per_sec"] = tokens_per_step / p50
        if flops_per_step is not None and p50 > 0:
            out["flops_per_sec"] = flops_per_step / p50
            if peak_flops is None:
                peak_flops = device_peak_flops()
            out["mfu"] = flops_per_step / p50 / peak_flops
        return out


def train_step_flops(dims, tokens_per_step: float) -> float:
    """Training matmul flops of one step from ``core.cost_model.ModelDims``:
    fwd + dgrad + wgrad = 3 x the forward's (recompute not counted)."""
    return 3.0 * dims.total_fwd_flops * tokens_per_step


# Dense bf16 peak (flops/s) by device name, from the data sheets: the
# H100 SXM's 989 TFLOP/s at its 700 W limit.  The CPU figure is a nominal
# one-core number, a trend anchor only.
_PEAK_FLOPS = {"NVIDIA H100": 989e12, "cpu": 1e11}


def device_peak_flops(device=None) -> float:
    """Peak flops/s of ``device`` (default: CUDA device 0 when there is
    one): the table above by device name, else the CPU figure."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", 0)
    if device is not None and torch.device(device).type == "cuda":
        name = torch.cuda.get_device_name(device)
        for prefix, peak in _PEAK_FLOPS.items():
            if name.startswith(prefix):
                return peak
    return _PEAK_FLOPS["cpu"]
