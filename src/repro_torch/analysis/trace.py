"""Walkers over what a step ran (counterpart of ``repro.analysis.hlo``).

The reference walks the compiled HLO text; the port has no HLO, so its
evidence is what ran: the kernel markers of a marking routing capture
(``core.routing.KernelCall``: kernel name, role in scope, operand dtypes
and shapes, kernels launched) and the CUDA kernels of a
``torch.profiler`` trace.  ``kernel_census`` and ``wide_operands`` read
the first; ``trace_role_ops`` matches the two, call by call.

The collective census (``parse_collectives`` / ``collective_bytes``,
the reference's names and ``COLLECTIVE_FACTORS``) reads the records the
port's collectives keep of every call (``distributed.comms.recording``:
op, dtype, per-rank payload bytes, group size, what it carries) where
the reference reads the compiled HLO.  The payload dtypes are the wire's
own: no backend legalizes them, so the reference's ``_wire`` adjustments
(f32 for bf16, f16 for fp8 on XLA:CPU) do not apply.
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["DTYPE_BYTES", "PORT_KERNELS", "COLLECTIVE_FACTORS",
           "shape_bytes", "kernel_census", "wide_operands",
           "device_kernels", "trace_role_ops", "kernel_name",
           "parse_collectives", "collective_bytes"]

# Bytes per element of the torch dtypes (``str(dtype)`` without the
# ``torch.`` prefix, as ``KernelCall.operands`` names them).
DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
}
# The device functions of the port's CUDA kernels (``kernels/csrc``), by
# the wrapper that launches them (``KernelCall.name``).
PORT_KERNELS = {
    "qmm_stream": ("qmm_stream_kernel", "qmm_stream_tc_kernel",
                   "stats_slab_kernel", "stats_total_kernel"),
    "quantize_rows": ("quantize_rows_kernel", "quantize_tok_kernel",
                      "quantize_cols_kernel", "col_amax_kernel",
                      "tensor_amax_kernel", "stats_slab_kernel",
                      "stats_total_kernel"),
    "tiled_mm": ("tiled_mm_kernel", "tiled_mm_tc_kernel"),
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_tc_kernel"),
    "quantize_blockwise": ("quantize_blockwise_kernel",),
}
_PORT_FUNCTIONS = {k for ks in PORT_KERNELS.values() for k in ks}
_FLOAT_BITS = {"float8_e4m3fn": 8, "float8_e5m2": 8, "float16": 16,
               "bfloat16": 16, "float32": 32, "float64": 64}


def shape_bytes(dtype: str, shape: Sequence[int]) -> int:
    """Bytes of one ``dtype`` tensor of ``shape`` (0 for an unknown
    dtype)."""
    nb = DTYPE_BYTES.get(dtype)
    if nb is None:
        return 0
    return math.prod(shape) * nb


# Ring-model bytes a rank moves per payload byte, the reference's.
COLLECTIVE_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def parse_collectives(records: Iterable) -> List[Tuple[str, str, int]]:
    """[(op kind, "dtype[dims]", per-rank bytes)] for every recorded
    collective (``comms.CollectiveRecord``s, in issue order)."""
    return [(r.op, f"{r.dtype}[{','.join(map(str, r.shape))}]", r.nbytes)
            for r in records if r.op in COLLECTIVE_FACTORS]


def collective_bytes(records: Iterable) -> Dict[str, float]:
    """Per-op-kind raw and ring-model effective per-rank bytes, the
    reference's keys: ``raw_<kind>``, ``raw_<kind>_<dtype>``,
    ``raw_total``, ``effective_total`` (``COLLECTIVE_FACTORS`` applied;
    ``effective_total_wire`` the same figure: the dtypes are the
    wire's), ``n_ops``."""
    ops = parse_collectives(records)
    raw: Dict[str, float] = defaultdict(float)
    by_dtype: Dict[Tuple[str, str], float] = defaultdict(float)
    for kind, shape, b in ops:
        raw[kind] += b
        by_dtype[(kind, shape.split("[", 1)[0])] += b
    out = {f"raw_{k}": v for k, v in raw.items()}
    out.update({f"raw_{k}_{d}": v for (k, d), v in by_dtype.items()})
    out["raw_total"] = sum(raw.values())
    out["effective_total"] = sum(COLLECTIVE_FACTORS[k] * v
                                 for k, v in raw.items())
    out["effective_total_wire"] = out["effective_total"]
    out["n_ops"] = len(ops)
    return out


def kernel_census(calls: Iterable) -> Dict[str, int]:
    """Kernel calls per role (``"-"`` outside a matmul role: flash
    attention, the serving codecs), the counterpart of the reference's
    ``pallas_call`` equations per ``qrole_*`` scope."""
    return dict(Counter(c.role or "-" for c in calls))


def wide_operands(calls: Iterable, compute_dtype: str) -> List[str]:
    """Matrix operands (rank >= 2) of a floating dtype wider than
    ``compute_dtype`` that reached a kernel, one line each (the "no f32
    upcast into a kernel-routed matmul" check)."""
    bits = _FLOAT_BITS[compute_dtype]
    out = []
    for c in calls:
        for dtype, shape in c.operands:
            if len(shape) >= 2 and _FLOAT_BITS.get(dtype, 0) > bits:
                out.append(f"qrole_{c.role or '?'}: {dtype} operand "
                           f"{shape} of {c.name}")
    return out


def device_kernels(prof) -> List[str]:
    """The port's CUDA kernels (``PORT_KERNELS``' functions) of a
    ``torch.profiler`` trace, by name, in the order they ran on the
    card."""
    ran = sorted((e.time_range.start, kernel_name(e.name))
                 for e in prof.events() if _on_device(e))
    return [name for _, name in ran if name in _PORT_FUNCTIONS]


def trace_role_ops(prof, calls, window: int = 8
                   ) -> Tuple[Dict[str, Dict[str, int]], int, int]:
    """``({role: {CUDA kernel: launches}}, calls not found, kernels left
    over)``: the kernels of a profiler trace under each role (``"-"``
    outside one), the counterpart of the reference's ``hlo_role_ops``
    (the kernels that survive into the device trace).  One stream runs
    the step's kernels in launch order, so each card call of the markers
    (``calls``, in launch order) takes the next ``call.launches`` port
    kernels of the trace, all of its wrapper's (``PORT_KERNELS``).  A
    trace can lose events (seen at the start of a session in a long
    process): a call whose kernels are not next is looked for within the
    next ``window`` kernels, and counted as not found when they are not
    there.  By order, not by the profiler's launch links: a kernel
    launched through ``ctypes`` has no host op to hang on."""
    ran = device_kernels(prof)
    out: Dict[str, Dict[str, int]] = {}
    missed = skipped = i = 0
    for c in calls:
        if c.device != "cuda" or not c.launches:
            continue
        want = PORT_KERNELS[c.name]
        for j in range(i, min(i + window, len(ran)) + 1):
            got = ran[j:j + c.launches]
            if len(got) == c.launches and all(n in want for n in got):
                skipped += j - i
                i = j + c.launches
                per = out.setdefault(c.role or "-", {})
                for n in got:
                    per[n] = per.get(n, 0) + 1
                break
        else:
            missed += 1
    return out, missed, skipped + len(ran) - i


def _on_device(ev) -> bool:
    """Whether a profiler event ran on the card (a kernel, a copy)."""
    return "CUDA" in str(getattr(ev, "device_type", ""))


_FUNC_RE = re.compile(r"(?:^|::)([A-Za-z_]\w*)(?=[<(])")


def kernel_name(name: str) -> str:
    """A CUDA kernel's function name from its demangled signature
    (``void (anonymous namespace)::quantize_tok_kernel<...>(...)`` ->
    ``quantize_tok_kernel``); other names (copies, memsets) cut to 60
    characters."""
    m = _FUNC_RE.search(name)
    return m.group(1) if m else name[:60]
