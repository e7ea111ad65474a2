"""Build and load the CUDA kernels of ``csrc/`` (nvcc into shared
libraries with a plain C interface, bound with ``ctypes``).

Each ``*.cu`` source becomes one library, named by a hash of its text, of
every header of ``csrc/`` (``*.cuh``) and of the flags, in
``build/repro_torch_kernels/`` at the root of the checkout; a library
whose source, headers and flags are unchanged is not rebuilt.
``build_all`` starts one ``nvcc`` per source at once.  Nothing is built or
loaded when this module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.core import routing

__all__ = ["SOURCES", "build_all", "load", "sass", "BUILD_DIR",
           "NVCC_FLAGS", "CudaKernel", "cuda_operands", "effective_dims",
           "stream_ptr", "stats_buffers", "batch_of", "recomputing",
           "recomputing_now", "KERNELS", "launch_counts",
           "add_launch_counts", "TILINGS", "check_tiling"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("quantize_rows", "qmm_stream", "tiled_mm", "flash_attention",
           "quantize_blockwise")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The (bm, bn, bk) output tilings the GEMM kernels' tensor-core route is
# built for (csrc/gemm_sm90.cuh ``Tiling``; bk is one quant group).
TILINGS = ((128, 128, 128), (128, 256, 128), (256, 128, 128))

_LIBS: Dict[str, ctypes.CDLL] = {}
# Every CudaKernel made (one per wrapper module), for launch_counts
KERNELS: List["CudaKernel"] = []
# > 0 while a rematerialized forward runs (``recomputing``); a global,
# not a thread-local: autograd runs a CUDA backward on its own thread
_RECOMPUTE = [0]


@contextlib.contextmanager
def recomputing():
    """Count the launches inside as a recompute (``recompute_launches``):
    ``models.stack`` wraps the re-run of a checkpointed layer in it."""
    _RECOMPUTE[0] += 1
    try:
        yield
    finally:
        _RECOMPUTE[0] -= 1


def recomputing_now() -> bool:
    """Whether a rematerialized forward is running (``recomputing``)."""
    return _RECOMPUTE[0] > 0


def check_tiling(bm: int, bn: int, bk: int = 128) -> None:
    """Raise ``ValueError`` unless the kernels are built for (bm, bn,
    bk): an explicit tiling is a request, so none is replaced."""
    if (bm, bn, bk) not in TILINGS:
        raise ValueError(f"no kernel is built for tiles (bm, bn, bk) = "
                         f"{(bm, bn, bk)}; built: {TILINGS}")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return path


def _target(name: str) -> Path:
    """The library of source ``name``: its path names a hash of the
    source, of every header of ``CSRC`` (by name and text) and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Tuple[float, Dict[str, str]]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Returns (seconds, the
    compiler's ``-Xptxas -v`` report per source, kept beside each library
    for a later call).  Raises with the compiler's output if any build
    fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs, failed = {}, {}, []
    for name in names:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n"
                          f"{logs[name]}")
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s library (``cuobjdump -sass``), built
    first if needed."""
    build_all((name,))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


class CudaKernel:
    """One kernel of ``csrc/``: its C entry point, bound on first launch,
    and the count of its launches.

    ``launches`` goes up by the number of kernels a successful call of
    the entry point launched (``kernels``, one unless the wrapper says
    otherwise) and nowhere else, so a run can show that its path went
    through the kernel; ``trans_launches`` counts the part of them that
    read or wrote an operand transposed (``trans``: the backward
    matmuls' layouts), ``sr_launches`` the part that rounded
    stochastically and ``stats_launches`` the part that collected the
    stats epilogue (its fold included) and ``tc_launches`` the part that
    ran on the tensor-core route (a GEMM kernel's bf16 calls with M > 16,
    flash attention's bf16 calls: ``tensor_core``) and
    ``batched_launches`` the part that ran a batch of operand pairs in
    one launch (``batched``: the MoE experts).  ``tile_launches`` counts
    a GEMM kernel's eager tensor-core calls by their ``(bm, bn)`` tiling
    (``tiles``; not part of ``counts()``).  A CUDA graph's
    replay launches what its capture recorded without calling the entry
    point: ``graphs.GraphedStage`` adds the capture's counts on every
    replay (``add_launch_counts``) and takes them back from the capture,
    which launched nothing.  Wrappers do not call
    the entry point for an empty output.  The entry point returns
    ``cudaGetLastError()``; a non-zero code raises.
    """

    def __init__(self, name: str, argtypes):
        self.name = name
        self.argtypes = list(argtypes)
        self.reset()
        self._fn = self._route = None
        KERNELS.append(self)

    def reset(self) -> None:
        self.launches = self.trans_launches = 0
        self.sr_launches = self.stats_launches = self.tc_launches = 0
        self.recompute_launches = self.batched_launches = 0
        self.tile_launches: Dict[Tuple[int, int], int] = {}

    def counts(self) -> Dict[str, int]:
        return {"launches": self.launches, "trans": self.trans_launches,
                "sr": self.sr_launches, "stats": self.stats_launches,
                "tc": self.tc_launches,
                "recompute": self.recompute_launches,
                "batched": self.batched_launches}

    def add(self, counts: Dict[str, int]) -> None:
        """Add ``counts`` (the keys of ``counts()``) to this kernel's."""
        self.launches += counts["launches"]
        self.trans_launches += counts["trans"]
        self.sr_launches += counts["sr"]
        self.stats_launches += counts["stats"]
        self.tc_launches += counts["tc"]
        self.recompute_launches += counts["recompute"]
        self.batched_launches += counts["batched"]

    def _bind(self, suffix: str, argtypes):
        fn = getattr(load(self.name), f"{self.name}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def tensor_core(self, *args: int) -> bool:
        """Whether a launch takes the tensor-core route: the library's own
        rule (its ``*_route`` entry point) of the launch's int arguments,
        (dtype code, M) for the GEMM kernels (``gemm_sm90.cuh``
        ``tensor_core_route``), the dtype code for flash attention."""
        if self._route is None:
            self._route = self._bind("route", [ctypes.c_int] * len(args))
        return bool(self._route(*args))

    def launch(self, *args, operands=(), kernels: int = 1,
               trans: bool = False, sr: bool = False, stats: bool = False,
               tc: bool = False, batched: bool = False,
               tiles=None) -> None:
        """Call the entry point on ``args``; ``operands`` (the call's
        input tensors) go to a qlint capture's kernel markers
        (``core.routing.mark_kernel``), as a wrapper's CPU branch sends
        them."""
        if self._fn is None:
            self._fn = self._bind("launch", self.argtypes)
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        routing.mark_kernel(self.name, operands, kernels)
        self.launches += kernels
        self.trans_launches += kernels * trans
        self.sr_launches += kernels * sr
        self.stats_launches += kernels * stats
        self.tc_launches += kernels * tc
        self.recompute_launches += kernels * recomputing_now()
        self.batched_launches += kernels * batched
        if tc and tiles is not None:
            self.tile_launches[tiles] = self.tile_launches.get(tiles, 0) + 1


def launch_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel's ``counts()``, by kernel name."""
    return {k.name: k.counts() for k in KERNELS}


def add_launch_counts(delta: Dict[str, Dict[str, int]], times: int = 1
                      ) -> None:
    """Add ``times`` x ``delta`` (by kernel name, as ``launch_counts``)."""
    for k in KERNELS:
        d = delta.get(k.name)
        if d is not None and times:
            k.add({key: n * times for key, n in d.items()})


_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def cuda_operands(*ts):
    """Check the operands of a launch (CUDA, one device, float32 or
    bfloat16, row-major contiguous, all 2-D or all 3-D with one batch
    size: a batched launch) and return the kernels' dtype code.  Raises
    on anything a kernel does not take."""
    dev, dt = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not {dev}")
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError("operands must share one device and dtype; got "
                             f"{[(x.device, x.dtype) for x in ts]}")
        if t.dim() not in (2, 3) or t.dim() != ts[0].dim() or \
                t.shape[:-2] != ts[0].shape[:-2] or not t.is_contiguous():
            raise ValueError("kernels take 2-D (or 3-D, one batch size) "
                             "row-major contiguous operands; got shapes "
                             f"{[tuple(x.shape) for x in ts]}")
    code = _DTYPE_CODES.get(str(dt))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, not {dt}")
    return code


def effective_dims(a, b, trans_a: bool, trans_b: bool):
    """(M, K, N) of ``A' @ B'`` with ``A' = a.T`` under ``trans_a`` (same
    for B'), of one pair of a batch for 3-D operands (the last two dims);
    raises if the inner dims differ."""
    m, k = a.shape[-2:][::-1] if trans_a else a.shape[-2:]
    kb, n = b.shape[-2:][::-1] if trans_b else b.shape[-2:]
    if k != kb:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (trans_a={trans_a}, "
                         f"trans_b={trans_b})")
    return m, k, n


def stats_buffers(rows: int, cols: int, device):
    """The stats epilogue's buffers for a (rows, cols) quant-orientation
    operand: row partials (rows, k-slabs, 8), slab partials (block-rows,
    k-slabs, 8) and the (8,) result, f32, every element written by the
    kernels."""
    import torch
    ks, rb = -(-cols // 128), -(-rows // 128)
    return tuple(torch.empty(n, dtype=torch.float32, device=device)
                 for n in (rows * ks * 8, rb * ks * 8, 8))


def batch_of(t) -> int:
    """The batch size of a launch's operand: its leading dim when 3-D,
    else 1."""
    return t.shape[0] if t.dim() == 3 else 1


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
