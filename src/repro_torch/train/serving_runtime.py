"""Serving runtime: quantize-once weight panels, the batched decode
engine, continuous batching and streaming prefill (counterpart of
``repro.train.serving_runtime``).

* ``quantize_weights_for_serving`` packs every linear weight exactly once
  into a ``PackedTensor`` (uint8 codes + per-128x128 f32 scales), or,
  with ``packed=False``, stores the tile QDQ's dequantized values.
* ``DecodeEngine`` holds one per-slot KV cache for all slots: prefill per
  request (bucket-padded to powers of two), ``insert`` into a slot, and one batched ``generate_step`` for
  every slot at its own position (exact length under a sliding window or
  with mamba mixers).  Under ``jit=True`` (the default, as
  the reference's) each stage on CUDA is a captured CUDA graph
  (``train.graphs.GraphedStage``), the counterpart of the reference's
  ``jax.jit``.
* ``ContinuousBatcher`` keeps a request queue over the engine and refills
  finished slots at once.
* ``streaming_prefill`` prefills a long prompt in fixed segments.

The engine updates its cache in place instead of donating buffers to a
compiled step.
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
from repro_torch.core.quantize import QuantSpec, qdq
from repro_torch.core.recipe import RECIPES, PrecisionRecipe
from repro_torch.models.model import Model, build_model, tree_map
from repro_torch.train.graphs import GraphedStage, GraphPool

__all__ = ["quantize_weights_for_serving", "serving_memory_report",
           "DecodeEngine", "ContinuousBatcher", "streaming_prefill"]

# Matrix-shaped params that no linear consumes: pos_embed is indexed per
# position and the mamba short-conv weights are used elementwise, so they
# stay dense.
_NOT_LINEAR_CONSUMED = {"pos_embed", "conv_wx", "conv_wb", "conv_wc"}


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
                                 packed: bool = True, device=None):
    """Weight-only quantization of the linear weights for serving, on
    ``device`` (``cuda`` unless given).

    ``packed=True``: pack every linear weight once into a ``PackedTensor``;
    norms, embeddings / LM head (vocab axis), pos_embed, the mamba conv
    weights and the f32 leaves (router, ``dt_bias``, ``a_log``,
    ``d_skip``) stay dense.
    Decoded values are bitwise the tile QDQ.

    ``packed=False``: the reference's simulated path, a tile QDQ that
    stores the dequantized values in the weight's dtype (no memory
    saved).  It quantizes what the reference's does: every leaf of rank
    >= 2 with no vocab axis (pos_embed and a scan-stacked (layers, d) norm
    scale included), a stacked leaf layer by layer."""
    dev = resolve_device(device)
    spec = QuantSpec(fmt, "tile", block)

    def walk(p, s, name):
        if isinstance(s, dict):
            return {k: walk(p[k], s[k], k) for k in s}
        if isinstance(s, list):
            return [walk(pi, si, name) for pi, si in zip(p, s)]
        p = p.to(dev)
        axes = list(s.axes)
        if s.dtype is not None or len(s.shape) < 2 or "vocab" in axes:
            return p
        if not packed:
            k, n = s.shape[-2:]
            return torch.stack([qdq(m, spec, 1) for m in
                                p.reshape(-1, k, n)]).reshape(p.shape)
        rank = len(s.shape) - (1 if axes and axes[0] == "layers" else 0)
        if rank < 2 or name in _NOT_LINEAR_CONSUMED:
            return p
        return pack_tensor(p, spec)

    return walk(params, model.param_specs(), None)


def streaming_prefill(model: Model, params, tokens: torch.Tensor, cache,
                      recipe: Optional[PrecisionRecipe] = None,
                      segment: int = 2048,
                      extras: Optional[Dict[str, torch.Tensor]] = None):
    """Prefill a long prompt in fixed segments into ``cache`` (in place);
    returns (logits of the last position, cache).  Activation memory is
    O(segment) instead of O(prompt); the KV cache carries across
    segments and the final partial segment runs at its natural length.
    Under a sliding window every segment is checked against the ring
    (``Model.check_ring_prefill``): one that would evict keys its own
    queries need raises ``ValueError``.  ``extras`` (a vlm's ``vision``,
    an audio model's ``frames``) go with every segment, which projects
    them into the cross cache again, as the reference's does."""
    recipe = recipe or RECIPES["bf16"]
    logits = None
    for start in range(0, tokens.shape[1], segment):
        logits, cache = model.prefill(params,
                                      tokens[:, start:start + segment],
                                      cache, recipe, extras=extras)
    return logits, cache


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
    bucket (``min_bucket`` .. ``max_len``), into the engine's one-slot
    cache; ``insert`` copies it into a slot; ``generate_step`` decodes
    every slot in one batched forward, each at its own position.  Dead
    slots decode too; their lengths stay frozen.  A live slot whose cache
    is full (``max_len`` tokens) is not decoded: ``generate_step`` raises.
    ``kv_format`` (an 8-bit format name) stores K/V as uint8 codes +
    per-(token, head) scales.  Runs on ``cuda`` unless ``device`` says
    otherwise.

    A sliding-window config keeps a ring of ``min(max_len, window)``
    positions per layer: decode past the window wraps it, and prefill
    runs at the prompt's exact length (a padded tail would overwrite ring
    slots), refusing a prompt longer than the ring
    (``Model.check_ring_prefill``).  A config with mamba mixers keeps
    each mamba layer's conv history and f32 state per slot (their size
    does not depend on ``max_len``) and prefills at the exact length too
    (the state would take in a padded tail); the insert and the decode
    step update them in place, so their graphs replay over fixed
    addresses.

    ``jit=True`` (the default): on CUDA each stage is a CUDA graph
    (``train.graphs.GraphedStage``), captured on first use and replayed:
    one prefill graph per bucket (the prompt's true length is a device
    input, the one-slot cache is reset inside the graph), one insert graph
    (the slot index is a device input, as the reference traces it: one
    replay in place of a copy launch per cache tensor, five a layer) and
    one for the batched step (the last tokens and the live mask are
    device inputs).  An exact-length prefill runs eagerly: each prompt
    length would need its own graph, used once.  On CPU tensors the stages run
    eagerly.  ``jit=False`` runs them eagerly on CUDA too.

    The vlm and audio families raise ``NotImplementedError``: a request
    would need its vision or frame states, and the engine's prefill
    takes tokens alone, as the reference's does.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 512,
                 recipe: Optional[PrecisionRecipe] = None,
                 kv_format: Optional[str] = None, min_bucket: int = 16,
                 jit: bool = True, device=None):
        dev = resolve_device(device)
        cfg = model.cfg
        if cfg.family in ("vlm", "audio"):
            # The reference's engine prefills with the tokens alone, so
            # it cannot serve a cross family either; ``train.serve.
            # generate(extras=...)`` does
            raise NotImplementedError(
                f"DecodeEngine serves no {cfg.family} model: its requests "
                "carry vision / frame states that the engine's prefill "
                "does not take; use train.serve.generate(..., extras=...)")
        if kv_format is not None:
            if F.FORMATS[kv_format].bits != 8:
                raise ValueError(
                    f"kv_format must be an 8-bit format, got {kv_format}")
            cfg = cfg.replace(kv_cache_format=kv_format)
        self.model = build_model(cfg, dev)
        self.device = dev
        self.params = self.model.cast_params(
            tree_map(lambda p: p.to(dev), params))
        self.recipe = recipe or RECIPES["bf16"]
        self.n_slots = n_slots
        self.max_len = max_len
        self.min_bucket = min_bucket
        # Bucket-padded prefill relies on padded K/V staying masked; a
        # ring-window cache would wrap the pad over live slots and an SSM
        # state would take it in.
        self._can_bucket = not self.model.exact_prefill
        self.cache_dtype = torch.bfloat16   # the reference's default
        self.cache = self.model.init_cache(n_slots, max_len,
                                           self.cache_dtype, per_slot=True)
        # The one-slot cache every prefill fills (reset first)
        self.c1 = self.model.init_cache(1, max_len, self.cache_dtype,
                                        per_slot=True)
        self._c1_issued = None      # what the last prefill returned
        self.live = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int64)
        self.lengths = np.zeros(n_slots, np.int64)   # host copy, live slots
        self.last_logits = None

        pool = GraphPool()

        def stage(fn, name):
            return GraphedStage(fn, name, pool) if jit else fn
        self._prefill = stage(self._prefill_impl, "prefill")
        self._insert = stage(self._insert_impl, "insert")
        self._generate = stage(self._generate_impl, "generate")

    # -- stage bodies: fn(weights, state, *inputs) ----------------------

    def _prefill_impl(self, params, c1, toks, true_len):
        self.model.reset_cache(c1)
        logits, _ = self.model.prefill(params, toks, c1, self.recipe,
                                       true_length=true_len)
        return torch.argmax(logits[0, -1].to(torch.float32))

    def _insert_impl(self, c1, cache, slot):
        for dst, src in zip(cache["stack"]["layers"],
                            c1["stack"]["layers"]):
            for key, t in dst["self"].items():
                t.index_copy_(0, slot, src["self"][key])
        cache["length"].index_copy_(0, slot, c1["length"])

    def _generate_impl(self, params, cache, toks, live):
        # Dead slots decode too but must not advance.
        logits, _ = self.model.decode_step(params, toks, cache, self.recipe,
                                           live=live)
        return torch.argmax(logits[:, -1].to(torch.float32), dim=-1), logits

    def qlint_report(self, *, trace: Optional[bool] = None):
        """Precision-flow audit (``analysis.qlint``) of one batched decode
        step: packed-panel routes, activation-quant kernel presence,
        zero-fallback serving, the captures per stage.  The step runs
        eagerly on a scratch copy of the cache (``trace``, default on
        CUDA: under a profiler trace): the engine's cache, slots and last
        logits are untouched."""
        from repro_torch.analysis import qlint
        return qlint.audit_decode_engine(self, trace=trace)

    # -- public stages ---------------------------------------------------

    @property
    def stages(self) -> Dict[str, Any]:
        return {"prefill": self._prefill, "insert": self._insert,
                "generate": self._generate}

    def bucket(self, n: int) -> int:
        """The padded length a prompt of ``n`` tokens runs at."""
        if not self._can_bucket:
            return n
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    @torch.no_grad()
    def prefill(self, prompt) -> Tuple[int, Any]:
        """Run one prompt; returns (first generated token, the one-slot
        cache).  The cache holds the engine's own buffers (``self.c1``),
        valid until the next ``prefill``: ``insert`` it before that, or
        ``insert`` raises."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        n = int(prompt.size)
        if not 0 < n <= self.max_len:
            raise ValueError(f"prompt length {n} not in [1, {self.max_len}]")
        padded = np.zeros((1, self.bucket(n)), np.int64)
        padded[0, :n] = prompt
        toks = torch.from_numpy(padded).to(self.device)
        true_len = torch.tensor(n, dtype=torch.int32).to(self.device)
        prefill = self._prefill if self._can_bucket else self._prefill_impl
        tok = prefill(self.params, self.c1, toks, true_len)
        # A new dict over the same buffers: insert tells this prefill's
        # cache from an earlier one's, whose buffers now hold this one.
        self._c1_issued = dict(self.c1)
        return int(tok), self._c1_issued

    @torch.no_grad()
    def insert(self, c1, first_tok: int, slot: int) -> None:
        """Copy a prefilled one-slot cache into ``slot``.  Raises if
        ``c1`` came from a ``prefill`` before the last: a later one has
        overwritten its buffers."""
        if not 0 <= slot < self.n_slots or self.live[slot]:
            raise ValueError(f"slot {slot} is not a free slot")
        if c1["length"] is self.c1["length"] and c1 is not self._c1_issued:
            raise ValueError("this one-slot cache was overwritten by a "
                             "later prefill: insert each prefill's cache "
                             "before the next prefill")
        self._insert(c1, self.cache,
                     torch.tensor([slot]).to(self.device))
        self.lengths[slot] = int(c1["length"][0])
        self.live[slot] = True
        self.last_tok[slot] = first_tok

    def release(self, slot: int) -> None:
        self.live[slot] = False

    @torch.no_grad()
    def generate_step(self) -> np.ndarray:
        """One batched decode step; returns the next token per slot
        (entries of dead slots are garbage) and keeps the step's logits
        (n_slots, 1, V) in ``last_logits`` until the next stage call.
        Raises if a live slot's cache is full: its token would have
        nowhere to go."""
        full = np.flatnonzero(self.live & (self.lengths >= self.max_len))
        if full.size:
            raise RuntimeError(f"slots {full.tolist()} hold max_len = "
                               f"{self.max_len} tokens; release them")
        toks = torch.from_numpy(self.last_tok[:, None]).to(self.device)
        live = torch.from_numpy(self.live).to(self.device)
        nxt, self.last_logits = self._generate(self.params, self.cache,
                                               toks, live)
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
    at once.  Raises for the vlm and audio families, as ``DecodeEngine``
    does."""

    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 512,
                 recipe: Optional[PrecisionRecipe] = None,
                 kv_format: Optional[str] = None, jit: bool = True,
                 device=None):
        self.engine = DecodeEngine(model, params, n_slots=n_slots,
                                   max_len=max_len, recipe=recipe,
                                   kv_format=kv_format, jit=jit,
                                   device=device)
        self.n_slots = n_slots
        self.queue: Deque[Tuple[int, np.ndarray, int]] = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.finished: Dict[int, List[int]] = {}
        self._next_id = 0

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; raises if its prompt and the K/V of all but
        the last new token do not fit in ``max_len``, or if its prompt
        overflows a windowed cache's ring (``Model.check_ring_prefill``)."""
        need = len(prompt) + max_new_tokens - 1
        if need > self.engine.max_len:
            raise ValueError(f"request needs {need} cache positions, "
                             f"max_len is {self.engine.max_len}")
        self.engine.model.check_ring_prefill(self.engine.c1, len(prompt),
                                             cached=0)
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
