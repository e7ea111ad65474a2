"""Serving runtime: quantize-once weight panels, the batched decode
engine and continuous batching (counterpart of
``repro.train.serving_runtime``).

* ``quantize_weights_for_serving`` packs every linear weight exactly once
  into a ``PackedTensor`` (uint8 codes + per-128x128 f32 scales).
* ``DecodeEngine`` holds one per-slot KV cache for all slots: prefill per
  request (bucket-padded to powers of two), ``insert`` into a slot, and
  one batched ``generate_step`` for every slot at its own position.
* ``ContinuousBatcher`` keeps a request queue over the engine and refills
  finished slots at once.

PyTorch runs eagerly, so the engine updates its cache in place instead of
donating buffers to a compiled step.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import formats as F
from repro_torch.core.packed import PackedTensor, pack_tensor, packed_nbytes
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.recipe import RECIPES, PrecisionRecipe
from repro_torch.models.model import Model, build_model, tree_map

__all__ = ["quantize_weights_for_serving", "serving_memory_report",
           "DecodeEngine", "ContinuousBatcher"]

# Matrix-shaped params that no linear consumes: pos_embed is indexed per
# position, so it stays dense.
_NOT_LINEAR_CONSUMED = {"pos_embed"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_weights_for_serving(model: Model, params,
                                 fmt: str = "fp4_e2m1", block: int = 128,
                                 device=None):
    """Pack every linear weight once into a ``PackedTensor`` on ``device``
    (``cuda`` unless given).  Norms, embeddings / LM head (vocab axis) and
    pos_embed stay dense.  Decoded values are bitwise the tile QDQ."""
    dev = resolve_device(device)
    spec = QuantSpec(fmt, "tile", block)

    def walk(p, s, name):
        if isinstance(s, dict):
            return {k: walk(p[k], s[k], k) for k in s}
        if isinstance(s, list):
            return [walk(pi, si, name) for pi, si in zip(p, s)]
        p = p.to(dev)
        axes = list(s.axes)
        rank = len(s.shape) - (1 if axes and axes[0] == "layers" else 0)
        if (s.dtype is not None or rank < 2 or "vocab" in axes
                or name in _NOT_LINEAR_CONSUMED):
            return p
        return pack_tensor(p, spec)

    return walk(params, model.param_specs(), None)


def serving_memory_report(params) -> Dict[str, float]:
    """Measured storage of a (possibly packed) param tree."""
    leaves = list(_leaves(params))
    packed_bytes, packed_params = packed_nbytes(leaves)
    dense = [x for x in leaves if not isinstance(x, PackedTensor)]
    dense_bytes = sum(x.numel() * x.element_size() for x in dense)
    bpp = packed_bytes / max(packed_params, 1)
    return {
        "packed_bytes": int(packed_bytes),
        "packed_params": int(packed_params),
        "dense_bytes": int(dense_bytes),
        "dense_params": int(sum(x.numel() for x in dense)),
        "total_bytes": int(packed_bytes + dense_bytes),
        "bytes_per_packed_param": float(bpp),
        "vs_bf16": float(bpp / 2.0),
    }


class DecodeEngine:
    """Slot-indexed batched decode over one per-slot KV cache.

    ``prefill(prompt)`` runs one prompt, right-padded to a power-of-two
    bucket (``min_bucket`` .. ``max_len``), into a fresh one-slot cache;
    ``insert`` copies it into a slot; ``generate_step`` decodes every
    slot in one batched forward, each at its own position.  Dead slots
    decode too; their lengths stay frozen.  A live slot whose cache is
    full (``max_len`` tokens) is not decoded: ``generate_step`` raises.
    ``kv_format`` (an 8-bit format name) stores K/V as uint8 codes +
    per-(token, head) scales.  Runs on ``cuda`` unless ``device`` says
    otherwise.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 512,
                 recipe: Optional[PrecisionRecipe] = None,
                 kv_format: Optional[str] = None, min_bucket: int = 16,
                 device=None):
        dev = resolve_device(device)
        cfg = model.cfg
        if kv_format is not None:
            if F.FORMATS[kv_format].bits != 8:
                raise ValueError(
                    f"kv_format must be an 8-bit format, got {kv_format}")
            cfg = cfg.replace(kv_cache_format=kv_format)
        if cfg.sliding_window:
            raise NotImplementedError("ring-window caches are not ported")
        self.model = build_model(cfg, dev)
        self.device = dev
        self.params = self.model.cast_params(
            tree_map(lambda p: p.to(dev), params))
        self.recipe = recipe or RECIPES["bf16"]
        self.n_slots = n_slots
        self.max_len = max_len
        self.min_bucket = min_bucket
        self.cache_dtype = torch.bfloat16   # the reference's default
        self.cache = self.model.init_cache(n_slots, max_len,
                                           self.cache_dtype, per_slot=True)
        self.live = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int64)
        self.lengths = np.zeros(n_slots, np.int64)   # host copy, live slots

    def bucket(self, n: int) -> int:
        """The padded length a prompt of ``n`` tokens runs at."""
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def prefill(self, prompt) -> Tuple[int, Any]:
        """Run one prompt; returns (first generated token, slot cache)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = int(prompt.size)
        if not 0 < n <= self.max_len:
            raise ValueError(f"prompt length {n} not in [1, {self.max_len}]")
        padded = np.zeros((1, self.bucket(n)), np.int64)
        padded[0, :n] = prompt
        cache = self.model.init_cache(1, self.max_len, self.cache_dtype,
                                      per_slot=True)
        logits, cache = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device), cache,
            self.recipe, true_length=n)
        tok = int(torch.argmax(logits[0, -1].to(torch.float32)))
        return tok, cache

    def insert(self, c1, first_tok: int, slot: int) -> None:
        """Copy a prefilled one-slot cache into ``slot``."""
        if not 0 <= slot < self.n_slots or self.live[slot]:
            raise ValueError(f"slot {slot} is not a free slot")

        def put(dst, src):
            dst[slot:slot + 1].copy_(src)

        for dst, src in zip(self.cache["stack"]["layers"],
                            c1["stack"]["layers"]):
            for key in dst["self"]:
                put(dst["self"][key], src["self"][key])
        put(self.cache["length"], c1["length"])
        self.lengths[slot] = int(c1["length"][0])
        self.live[slot] = True
        self.last_tok[slot] = first_tok

    def release(self, slot: int) -> None:
        self.live[slot] = False

    @torch.no_grad()
    def generate_step(self) -> np.ndarray:
        """One batched decode step; returns the next token per slot
        (entries of dead slots are garbage).  Raises if a live slot's
        cache is full: its token would have nowhere to go."""
        full = np.flatnonzero(self.live & (self.lengths >= self.max_len))
        if full.size:
            raise RuntimeError(f"slots {full.tolist()} hold max_len = "
                               f"{self.max_len} tokens; release them")
        toks = torch.from_numpy(self.last_tok[:, None]).to(self.device)
        live = torch.from_numpy(self.live).to(self.device)
        before = self.cache["length"]
        logits, self.cache = self.model.decode_step(self.params, toks,
                                                    self.cache, self.recipe)
        self.cache["length"] = torch.where(live, self.cache["length"],
                                           before)
        nxt = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
        nxt = nxt.cpu().numpy()
        self.last_tok = np.where(self.live, nxt, self.last_tok)
        self.lengths += self.live
        return nxt


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    remaining: int = 0
    generated: Optional[List[int]] = None


class ContinuousBatcher:
    """Static-shape continuous batching over a fixed slot count: requests
    (prompt, max_new_tokens) are prefilled one by one into free slots and
    all live slots decode together; finished slots refill from the queue
    at once."""

    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 512,
                 recipe: Optional[PrecisionRecipe] = None,
                 kv_format: Optional[str] = None, device=None):
        self.engine = DecodeEngine(model, params, n_slots=n_slots,
                                   max_len=max_len, recipe=recipe,
                                   kv_format=kv_format, device=device)
        self.n_slots = n_slots
        self.queue: Deque[Tuple[int, np.ndarray, int]] = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.finished: Dict[int, List[int]] = {}
        self._next_id = 0

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; raises if its prompt and the K/V of all but
        the last new token do not fit in ``max_len``."""
        need = len(prompt) + max_new_tokens - 1
        if need > self.engine.max_len:
            raise ValueError(f"request needs {need} cache positions, "
                             f"max_len is {self.engine.max_len}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, np.asarray(prompt), max_new_tokens))
        return rid

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until queue and slots drain; returns {request_id: tokens}."""
        steps = 0
        while self.queue or any(s.request_id is not None
                                for s in self.slots):
            self._refill()
            self._decode_step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("batcher did not drain")
        return self.finished

    def _refill(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request_id is not None or not self.queue:
                continue
            rid, prompt, max_new = self.queue.popleft()
            tok, c1 = self.engine.prefill(prompt)
            self.slots[i] = _Slot(rid, max_new - 1, [tok])
            if max_new - 1 <= 0:
                self._finish(i)
            else:
                self.engine.insert(c1, tok, i)

    def _decode_step(self) -> None:
        live = [i for i, s in enumerate(self.slots)
                if s.request_id is not None]
        if not live:
            return
        nxt = self.engine.generate_step()
        for i in live:
            slot = self.slots[i]
            slot.generated.append(int(nxt[i]))
            slot.remaining -= 1
            if slot.remaining <= 0:
                self._finish(i)

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        self.finished[slot.request_id] = slot.generated
        self.slots[i] = _Slot()
        self.engine.release(i)
