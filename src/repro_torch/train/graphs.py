"""CUDA graphs for the serving stages: the port's counterpart of the
reference's ``jax.jit`` over prefill, insert and the batched decode step
(``jit=True`` in ``DecodeEngine``, ``ContinuousBatcher``,
``train.serve.make_prefill_fn`` / ``make_decode_fn`` and ``generate``).

``GraphedStage(fn, name)`` calls ``fn(weights, state, *inputs)``:

* ``weights`` (a tree of tensors / ``PackedTensor``s) is read in place:
  the graph reads the same addresses on every replay, so their data
  pointers are part of the graph's key and the stage keeps them alive;
* ``state`` (a tree, e.g. a KV cache) is updated in place by the graph,
  and keyed and kept the same way;
* ``inputs`` are copied into the graph's static buffers before each
  replay (a copy is skipped where the caller passes the static buffer
  itself); their shapes, dtypes and structure key the graph.

One graph is captured per key (at most ``max_graphs`` are kept: past
that the least recently replayed one is dropped, with what it holds):
the first call warms ``fn`` up on a side
stream, on clones of ``state`` and ``inputs`` (so the warm-up changes
nothing the caller holds), captures it into the stage's ``GraphPool``
(one ``torch.cuda.graph_pool_handle()``, shared by the stages of one
owner: an engine's three, a model's prefill and decode fns), then
replays it.  Later calls with the same key only copy their
inputs and replay.  While the capture runs, ``torch.cuda`` raises on any
host synchronisation (``set_sync_debug_mode("error")``): a stage that
reads a device value on the host cannot be captured.  On CUDA a capture
or a replay that fails raises; nothing falls back to the eager call.
Tensors on the CPU run ``fn`` eagerly: that is the caller asking for the
CPU.

The returned tensors are the graph's outputs, allocated in the shared
pool: they hold until the next replay of any stage of the pool (later
captures may reuse the pool's memory of earlier graphs' temporaries),
so a caller reads or copies them before its next stage call.

Launch counts: a replay launches the captured kernels without calling
their wrappers, so each graph keeps the counts its capture recorded
(``kernels.build.launch_counts``), takes them back from the capture
(which launched nothing) and adds them on every replay.  The routing
census works the same way: a capture's ``RouteEvent``s go into the
active ``routing`` log on every replay.  Telemetry taps record on the
host, so a stage refuses to capture under a telemetry collector.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import routing
from repro_torch.core.packed import PackedTensor
from repro_torch.kernels.build import add_launch_counts, launch_counts
from repro_torch.telemetry import collect as telemetry

__all__ = ["GraphedStage", "GraphPool"]


class GraphPool:
    """One CUDA graph memory pool, made at its first capture and shared
    by the stages given it.  A pool lives as long as its graphs: the
    caching allocator releases it when the last of them goes, so a handle
    is never reused past its graphs (it would fail an internal assert);
    the pool belongs to the owner of its stages."""

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


def _flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of a tree of dicts, lists and tuples; a
    ``PackedTensor`` gives its payload and scale."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (i,))]
    if isinstance(tree, PackedTensor):
        return [(path + ("payload",), tree.payload),
                (path + ("scale",), tree.scale)]
    return [(path, tree)]


def _by_address(tree) -> tuple:
    """Key of a tree read or written in place: each tensor's address."""
    return tuple((p, x.data_ptr(), tuple(x.shape), x.dtype)
                 if isinstance(x, torch.Tensor) else (p, x)
                 for p, x in _flatten(tree))


def _by_value(tree) -> tuple:
    """Key of a tree copied into static buffers: shapes and dtypes."""
    return tuple((p, tuple(x.shape), x.dtype)
                 if isinstance(x, torch.Tensor) else (p, x)
                 for p, x in _flatten(tree))


def _clone(tree):
    """A tree of the same structure with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _counts_delta(after, before) -> Dict[str, Dict[str, int]]:
    return {name: {k: n - before.get(name, {}).get(k, 0)
                   for k, n in counts.items()}
            for name, counts in after.items()}


@dataclasses.dataclass
class _Graph:
    graph: Any
    keep: tuple                 # weights and state: their addresses
    inputs: tuple               # static input buffers
    outputs: Any
    launches: Dict[str, Dict[str, int]]
    events: List[routing.RouteEvent]


class GraphedStage:
    """``fn(weights, state, *inputs)``, captured once per key into a CUDA
    graph in ``pool`` (its own unless given) and replayed, keeping at most
    ``max_graphs`` graphs (all when None; module docstring).
    ``captures`` and ``replays`` count what it did."""

    def __init__(self, fn, name: str, pool: GraphPool = None,
                 max_graphs: Optional[int] = None):
        self.fn = fn
        self.name = name
        self.pool = pool or GraphPool()
        self.max_graphs = max_graphs
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = self.replays = 0

    def __call__(self, weights, state, *inputs):
        fixed = [x for _, x in _flatten((weights, state))
                 if isinstance(x, torch.Tensor)]
        tensors = fixed + [x for _, x in _flatten(inputs)
                           if isinstance(x, torch.Tensor)]
        if not tensors or tensors[0].device.type != "cuda":
            return self.fn(weights, state, *inputs)
        device = tensors[0].device
        if any(t.device != device for t in tensors):
            raise ValueError(f"stage {self.name}: every tensor must be on "
                             f"{device}; got "
                             f"{sorted({str(t.device) for t in tensors})}")
        if telemetry.active() is not None:
            raise NotImplementedError(
                f"stage {self.name}: telemetry taps record on the host and "
                "cannot be replayed from a CUDA graph; run it with jit=False")
        key = (_by_address(weights), _by_address(state), _by_value(inputs))
        entry = self.graphs.get(key)
        if entry is None:
            if self.max_graphs is not None:
                while len(self.graphs) >= self.max_graphs:
                    self.graphs.popitem(last=False)
            entry = self.graphs[key] = self._capture(weights, state, inputs,
                                                     device)
        self.graphs.move_to_end(key)
        for dst, src in zip(_flatten(entry.inputs), _flatten(inputs)):
            dst, src = dst[1], src[1]
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)
        entry.graph.replay()
        self.replays += 1
        add_launch_counts(entry.launches)
        log = routing.active()
        if log is not None:
            for ev in entry.events:
                log.add(ev)
        return entry.outputs

    def _capture(self, weights, state, inputs, device) -> _Graph:
        static = _clone(inputs)
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), routing.capture():
                self.fn(weights, _clone(state), *_clone(static))
            torch.cuda.current_stream().wait_stream(side)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            with routing.capture() as log:
                with torch.cuda.graph(graph, pool=self.pool.get()):
                    mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        outputs = self.fn(weights, state, *static)
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
        delta = _counts_delta(launch_counts(), before)
        add_launch_counts(delta, -1)     # the capture launched nothing
        self.captures += 1
        return _Graph(graph, (weights, state), static, outputs, delta,
                      list(log.events))
