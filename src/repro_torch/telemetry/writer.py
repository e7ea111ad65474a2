"""JSONL metrics writers for telemetry rows + controller events (a copy
of ``repro.telemetry.writer``).

One JSON object per line.  Step rows are the trainer's history rows
(``{"step": int, "recipe": str, "loss": float, "tel/...": float, ...}``);
controller events carry ``{"event": "switch"|"demote"|"rollback"|
"straggler"|..., ...}``.  ``benchmarks/telemetry_report.py`` consumes this
format.

Two writers:

  * :class:`JsonlWriter` — synchronous append + flush per row.  Fine for
    reports and tests; on the training hot path every ``write`` is a
    blocking ``fsync``-adjacent syscall in step time.
  * :class:`AsyncJsonlWriter` — the host-offloaded pipeline the trainer
    uses: ``write`` enqueues onto a bounded queue and returns immediately;
    a daemon thread drains rows to disk off the critical path.  A full
    queue **drops** the row (counted in :attr:`AsyncJsonlWriter.dropped`)
    rather than ever blocking the step; ``close()`` flushes everything
    enqueued so far and appends a ``{"event": "telemetry_writer_drops"}``
    row when anything was lost, so the log is self-describing.

All rows pass through :func:`_jsonable` first: numpy and torch scalars
become Python scalars, arrays become (nested) lists, and non-finite
floats become ``null`` — ``json.dumps`` would otherwise emit bare
``NaN``/``Infinity`` tokens, which are not valid JSON and break strict
parsers downstream.
"""
from __future__ import annotations

import json
import math
import os
import queue
import threading
from typing import Any, Dict, List

__all__ = ["JsonlWriter", "AsyncJsonlWriter", "read_jsonl"]


def _jsonable(v):
    """Coerce one value to strict-JSON form.

    numpy and torch scalars -> Python scalars, arrays -> nested lists,
    dicts and sequences recursed, NaN/Inf -> ``None`` (strict JSON has no
    non-finite literals; a null metric reads as "not measured", which is
    the honest rendering of an overflowed stat).
    """
    if hasattr(v, "shape") and hasattr(v, "tolist"):
        # ndarray-like (numpy, or a torch tensor); 0-d gives a scalar
        v = v.tolist()
    elif hasattr(v, "item"):
        v = v.item()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def _dumps(row: Dict[str, Any]) -> str:
    # allow_nan=False makes any sanitizer gap a loud error here, not a
    # corrupt line discovered by a downstream parser.
    return json.dumps(_jsonable(dict(row)), allow_nan=False)


class JsonlWriter:
    """Synchronous JSONL writer (append + flush per row)."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def write(self, row: Dict[str, Any]) -> None:
        self._f.write(_dumps(row) + "\n")
        self._f.flush()

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_CLOSE = object()   # queue sentinel


class AsyncJsonlWriter:
    """Bounded-queue background-thread JSONL writer (never blocks a step).

    * ``write(row)`` copies the row, enqueues, returns.  When the queue is
      full the row is dropped and counted — backpressure from a slow disk
      must never stall the train step.
    * ``flush()`` blocks until every row enqueued so far is on disk (the
      trainer calls it at the end of ``train()`` so readers see a complete
      log without closing the writer).
    * ``close()`` drains the queue, appends the drop-count event if any
      rows were lost, and closes the file.  Clean close therefore loses
      nothing that was accepted into the queue.

    The drain thread is a daemon: an un-closed writer never prevents
    interpreter exit (rows still queued at hard exit are lost, like any
    buffered writer).
    """

    def __init__(self, path: str, append: bool = True,
                 queue_size: int = 4096):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a" if append else "w")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_size))
        self.dropped = 0
        self._closed = False
        self._thread = threading.Thread(target=self._drain,
                                        name="telemetry-jsonl-writer",
                                        daemon=True)
        self._thread.start()

    def write(self, row: Dict[str, Any]) -> None:
        if self._closed:
            self.dropped += 1
            return
        try:
            self._q.put_nowait(dict(row))
        except queue.Full:
            self.dropped += 1

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _CLOSE:
                    return
                self._write_row(item)
            finally:
                self._q.task_done()

    def _write_row(self, row: Dict[str, Any]) -> None:
        """Runs on the writer thread — the injectable sink (tests wrap it
        with an artificially slow version)."""
        self._f.write(_dumps(row) + "\n")
        self._f.flush()

    def flush(self) -> None:
        """Block until everything currently enqueued has hit the sink."""
        self._q.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(_CLOSE)   # blocking put: always delivered
        self._thread.join()
        if self.dropped:
            self._f.write(_dumps({"event": "telemetry_writer_drops",
                                  "dropped": self.dropped}) + "\n")
        self._f.close()

    def __enter__(self) -> "AsyncJsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
