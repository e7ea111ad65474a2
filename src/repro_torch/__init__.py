"""PyTorch / CUDA port of the FP4 pre-training reproduction, for one
NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``core``, ``kernels``, ``nn``, ``models``, ``train``)
so each module's counterpart is easy to find.  It imports ``torch`` and
never ``jax`` or ``repro``.  The serving path (packed-FP4 weights, FP8 KV
cache, ``DecodeEngine`` / ``ContinuousBatcher``) runs through the
hand-written CUDA kernels under ``kernels/csrc``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise.
"""
import functools

import torch

__all__ = ["resolve_device", "constant"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared: callers must not write to it.  A
    CUDA graph cannot capture the host-to-device copy that makes a tensor
    from Python numbers, so the serving path takes its constants from here
    (the warm-up before a capture makes them)."""
    return torch.tensor(values, dtype=dtype, device=device)
