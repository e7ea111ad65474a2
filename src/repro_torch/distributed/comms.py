"""The port's collectives: thin wrappers over ``torch.distributed`` that
keep a record of every collective a step issues.

The reference reads its collectives off the compiled HLO
(``repro.analysis.hlo.parse_collectives``); the port's steps are eager,
so the wrappers here note each call as a :class:`CollectiveRecord` (the
reference's op kind, the payload dtype and its per-rank shape and bytes,
the group's size, and what the payload carries) into every open
:func:`recording`.  ``analysis.trace.collective_bytes`` and
``analysis.qlint.audit_comms`` read those records.

Every wrapper takes a process group (None: the default group).  NCCL
takes CUDA tensors for every op.  PyTorch's ``gloo`` takes CUDA tensors
for ``all_reduce`` and ``broadcast`` only; an ``all_gather`` or a
``reduce_scatter`` of a CUDA tensor over ``gloo`` raises unless the
caller opened :func:`host_staging`, which runs those two through host
memory (a choice of the caller's backend, stated where it is made: the
wrappers never stage on their own).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist

__all__ = ["CollectiveRecord", "recording", "host_staging", "all_reduce",
           "all_gather", "reduce_scatter"]

_RECORDS: List[List["CollectiveRecord"]] = []
_STAGING = [False]


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as issued on this rank.  ``op`` is the reference's
    HLO kind (``all-reduce`` | ``all-gather`` | ``reduce-scatter``);
    ``shape`` / ``nbytes`` the payload one rank puts on the wire (its
    input); ``tag`` what it carries (``grad``, ``grad_codes``, ``scale``,
    ``param``, ``norm``, ``metric``, ``amax`` / ``amax_model`` (a quant
    group's shared amax words over the data / the model group),
    ``tp_fwd`` / ``tp_bwd`` (a row-parallel output's sum / a
    column-parallel input's cotangent sum over the model group),
    ``tp_norm`` (a norm's statistic over columns split over the model
    group, summed in the forward and its cotangent in the backward),
    ``ep_fwd`` / ``ep_bwd`` (an expert-parallel rank's expert outputs /
    its experts' input cotangents, all-gathered over the model group));
    ``layer`` the model layer that issued it (``"L3"``; "" outside
    one)."""

    op: str
    dtype: str
    shape: tuple
    nbytes: int
    group_size: int
    tag: str = ""
    reduce_op: str = ""
    layer: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@contextlib.contextmanager
def recording() -> Iterator[List[CollectiveRecord]]:
    """Collect the records of every wrapper call made inside the block
    (on this rank), in issue order."""
    log: List[CollectiveRecord] = []
    _RECORDS.append(log)
    try:
        yield log
    finally:
        _RECORDS.remove(log)


@contextlib.contextmanager
def host_staging(on: bool = True):
    """Run ``all_gather`` / ``reduce_scatter`` of CUDA tensors over a
    ``gloo`` group through host memory inside the block."""
    prev = _STAGING[0]
    _STAGING[0] = on
    try:
        yield
    finally:
        _STAGING[0] = prev


def _note(op: str, t: torch.Tensor, group, tag: str,
          reduce_op: str = "", layer: Optional[str] = None) -> None:
    if not _RECORDS:
        return
    rec = CollectiveRecord(
        op=op, dtype=str(t.dtype).replace("torch.", ""),
        shape=tuple(t.shape), nbytes=t.numel() * t.element_size(),
        group_size=dist.get_world_size(group), tag=tag, reduce_op=reduce_op,
        layer=layer or "")
    for log in _RECORDS:
        log.append(rec)


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` must go through host memory for a gather-type op
    on ``group``; raises when that is needed and not asked for."""
    if t.device.type != "cuda" or dist.get_backend(group) != "gloo":
        return False
    if not _STAGING[0]:
        raise RuntimeError(
            "the gloo backend cannot all_gather / reduce_scatter CUDA "
            "tensors: use NCCL, or open comms.host_staging() to run them "
            "through host memory")
    return True


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None, *,
               tag: str = "", layer: Optional[str] = None) -> torch.Tensor:
    """In-place all-reduce (``op``: sum | max) of ``t``; returns ``t``."""
    _note("all-reduce", t, group, tag, op, layer)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None, *, tag: str = "",
               layer: Optional[str] = None) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` stacked in group-rank order."""
    _note("all-gather", t, group, tag, layer=layer)
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    out = torch.stack(outs)
    return out.to(t.device) if staged else out


def reduce_scatter(t: torch.Tensor, group=None, *, tag: str = ""
                   ) -> torch.Tensor:
    """Sum over ranks of ``t``, scattered: rank i gets chunk i of dim 0
    (dim 0 must divide by the group's size)."""
    _note("reduce-scatter", t, group, tag, "sum")
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter(out, list(src.chunk(n)), group=group)
    return out.to(t.device) if staged else out
