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
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
