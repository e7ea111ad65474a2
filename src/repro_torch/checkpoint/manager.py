"""Atomic, retained, optionally asynchronous checkpoints (counterpart of
``repro.checkpoint.manager``, numpy files only).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, the
reference's.  A tree (nested dicts, lists and NamedTuples of tensors and
ints) flattens to the reference's key strings: dict keys and list
indices as they are, NamedTuple fields as ``.field`` (JAX's attribute
path), joined by ``/``; so either package restores the other's files.
Writes go to a temporary directory and then ``os.replace``: a crash in a
save never corrupts the newest checkpoint, and a directory without a
manifest is skipped.  Retention keeps the newest ``keep``.

The port's optimizers update their state in place, so ``save`` copies
every tensor to host memory before it returns; only the file writing
runs in the background under ``async_save``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "load_manifest"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (never a view of a tensor the caller keeps
    updating); bf16 goes to f32, exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    items = _items(tree)
    if items is None:
        return {prefix: _host(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def save_pytree(tree, directory: str, extra: Optional[dict] = None) -> None:
    """Atomic save of a tree with json-able ``extra`` metadata."""
    _write(_flatten(tree), directory, extra)


def _write(flat: Dict[str, np.ndarray], directory: str,
           extra: Optional[dict]) -> None:
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, ".tmp_" + os.path.basename(directory)
                       + f"_{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"keys": sorted(flat), "time": time.time(),
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def _rebuild(like, flat, prefix: str, device):
    items = _items(like)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing {prefix!r}")
        arr = flat[prefix]
        if isinstance(like, torch.Tensor):
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{prefix}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            dev = like.device if device is None else device
            return torch.from_numpy(np.array(arr)).to(dev, like.dtype)
        return type(like)(arr)             # a Python scalar (a step count)
    kids = [_rebuild(v, flat, f"{prefix}/{k}" if prefix else k, device)
            for k, v in items]
    if isinstance(like, dict):
        return dict(zip(like.keys(), kids))
    if _is_namedtuple(like):
        return type(like)(*kids)
    return type(like)(kids)


def load_pytree(directory: str, like, device=None):
    """Restore a tree saved by ``save_pytree`` (by either package) against
    the structure of ``like``: every leaf's key must be present with its
    shape; tensors take ``like``'s dtype and device (or ``device``; a
    ``like`` on the meta device needs one), Python scalars their type."""
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _rebuild(like, flat, "", device)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """Step-indexed checkpoints with retention and optional async save."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_"):
                continue
            full = os.path.join(self.dir, name)
            if not os.path.exists(os.path.join(full, "manifest.json")):
                continue  # incomplete / corrupt: ignored
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, extra: Optional[dict] = None) -> None:
        """Copy ``tree`` to host memory now, then write it (in a thread
        under ``async_save``, after the previous save has finished)."""
        flat = _flatten(tree)
        extra = dict(extra or {}, step=step)

        def do_save():
            _write(flat, self._step_dir(step), extra)
            self._retain()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=do_save, daemon=True)
            self._thread.start()
        else:
            do_save()

    def wait(self) -> None:
        """Block until any in-flight async save finishes."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like, step: Optional[int] = None, device=None):
        """(tree, the manifest's ``extra``) of ``step`` (default: the
        newest complete one)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        return load_pytree(d, like, device), load_manifest(d)["extra"]

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
