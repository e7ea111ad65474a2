"""Build and load the CUDA kernels of ``csrc/`` (nvcc into shared
libraries with a plain C interface, bound with ``ctypes``).

Each ``*.cu`` source becomes one library, named by a hash of its text, of
``codec.cuh`` and of the flags, in ``build/repro_torch_kernels/`` at the
root of the checkout; an unchanged source is not rebuilt.  ``build_all``
starts one ``nvcc`` per source at once.  Nothing is built or loaded when
this module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["SOURCES", "build_all", "load", "BUILD_DIR", "NVCC_FLAGS",
           "CudaKernel"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("quantize_rows", "qmm_stream", "tiled_mm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 (CSRC / "codec.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Tuple[float, Dict[str, str]]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together.  Returns (seconds, the
    compiler's ``-Xptxas -v`` report per source).  Raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n"
                          f"{logs[name]}")
        else:
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


class CudaKernel:
    """One kernel of ``csrc/``: its C entry point, bound on first launch,
    and the count of its launches.

    ``launches`` goes up by the number of kernels a successful call of
    the entry point launched (``kernels``, one unless the wrapper says
    otherwise) and nowhere else, so a run can show that its path went
    through the kernel.  Wrappers do not call the entry point for an
    empty output.  The entry point returns ``cudaGetLastError()``; a
    non-zero code raises.
    """

    def __init__(self, name: str, argtypes):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def launch(self, *args, kernels: int = 1) -> None:
        if self._fn is None:
            fn = getattr(load(self.name), f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += kernels


_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def cuda_operands(*ts):
    """Check the operands of a launch (CUDA, one device, float32 or
    bfloat16, 2-D, row-major contiguous) and return the kernels' dtype
    code.  Raises on anything a kernel does not take."""
    dev, dt = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, not {dev}")
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError("operands must share one device and dtype; got "
                             f"{[(x.device, x.dtype) for x in ts]}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError("kernels take 2-D row-major contiguous "
                             f"operands; got shape {tuple(t.shape)}")
    code = _DTYPE_CODES.get(str(dt))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, not {dt}")
    return code


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
