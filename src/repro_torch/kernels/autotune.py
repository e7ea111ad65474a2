"""Persistent ``(bm, bn, bk)`` autotuning for the fused quantized matmul
(counterpart of ``repro.kernels.autotune``).

The tensor-core route of ``qmm_stream`` and ``tiled_mm`` takes its
output tiling from the caller, and the best one depends on the problem:
each staged A tile is quantized N / bn times and each B tile M / bm
times.  This module owns the tuning table that maps a **problem key** to
a measured-best tiling:

    m8192_n8192_k3072/bfloat16xbfloat16/block:tile/nn/b128 -> (bm, bn, bk)

Key fields, in order: effective GEMM dims (M, N, K) rounded up to
multiples of the quant block (the reference pads to the block before it
consults its table; the port's kernels mask the ragged edge instead, so
the same call gets the same key in both packages), operand dtype names
(``bfloat16``, ``float32``), quant granularity pair, trans pair (``n`` /
``t`` for each operand), quant block size.  SR, stats and formats of
equal width are left out, as in the reference.  Keys and files are the
reference's letter for letter, so either package reads the other's
table.

Three layers, as in the reference:

* **Committed JSON** (``tuning_table.json`` next to this file, schema
  ``qmm_tuning_table.v1``), written on the card by ``python -m
  repro_torch.kernels.autotune --autotune PATH`` and validated by
  ``--validate``.  The port never reads the reference's table: its times
  are CPU interpret-mode times.
* **In-process table** (``get_table`` / ``set_table``), lazily loaded
  from the JSON once per process.
* **LRU resolution cache** (``resolve_tiles``): the per-call lookup
  ``fused_qmm`` makes when no tiles are passed.  ``None`` on a miss; an
  entry whose tiles do not divide the key's dims, as in the reference,
  or that the port's kernels are not built for
  (``build.TILINGS``: (128, 128), (128, 256), (256, 128), bk 128) counts
  as a miss, so a stale table, or the reference's, can only fail to
  speed things up.  That is the one difference from the reference: a
  tile of 384 or 512 is a hit there and a miss here.

On a miss ``fused_qmm`` keeps 128 x 128 (the reference's ``_pick_tile``
is a heuristic for a TPU's VMEM; the card's evidence is the table).
Tiles never change a value: every output element is summed by the same
instructions in the same order at every tiling, and quantization is
keyed by global coordinates, so a hit is bitwise equal to a miss.

The sweep (``autotune_qmm``) times the candidates the port builds on
the card with CUDA events, best of ``reps`` after a warm-up, and records
the winner under the key ``fused_qmm`` will look up.  ``main
--autotune PATH`` sweeps every distinct key that one paper_fp4 training
step of gpt2-125m (8 x 1024) and one of llama3.2-3b (4 x 2048) issue
through the kernels, as ``fused_qmm`` records them (``recording``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import shlex
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels.build import TILINGS

__all__ = ["SCHEMA", "DEFAULT_TABLE_PATH", "tuning_key", "TuningTable",
           "get_table", "set_table", "COUNTERS", "resolve_tiles",
           "candidate_tiles", "autotune_qmm", "validate_table",
           "recording", "recording_now", "note_call", "training_jobs", "TRAIN_JOBS", "main"]

SCHEMA = "qmm_tuning_table.v1"
DEFAULT_TABLE_PATH = Path(__file__).with_name("tuning_table.json")

_KEY_RE = re.compile(
    r"^m(\d+)_n(\d+)_k(\d+)/[\w.]+x[\w.]+/\w+:\w+/[nt][nt]/b(\d+)$")


def tuning_key(m: int, n: int, k: int, dtypes: Tuple[str, str],
               modes: Tuple[str, str], trans: Tuple[bool, bool],
               block: int = 128) -> str:
    """Canonical problem key (see module docstring for the field layout)."""
    return "/".join((
        f"m{m}_n{n}_k{k}",
        "x".join(dtypes),
        ":".join(modes),
        ("t" if trans[0] else "n") + ("t" if trans[1] else "n"),
        f"b{block}",
    ))


@dataclass
class TuningTable:
    """In-memory tuning table; ``entries[key] = {bm, bn, bk, us}``."""

    entries: Dict[str, dict] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "TuningTable":
        data = json.loads(Path(path).read_text())
        assert data.get("schema") == SCHEMA, data.get("schema")
        return cls(entries=dict(data.get("entries", {})),
                   meta=dict(data.get("meta", {})))

    def save(self, path) -> None:
        payload = {"schema": SCHEMA, "meta": self.meta,
                   "entries": {k: self.entries[k]
                               for k in sorted(self.entries)}}
        Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                              + "\n")

    def lookup(self, key: str) -> Optional[Tuple[int, int, int]]:
        ent = self.entries.get(key)
        if ent is None:
            return None
        return int(ent["bm"]), int(ent["bn"]), int(ent["bk"])

    def record(self, key: str, bm: int, bn: int, bk: int,
               us: float) -> None:
        self.entries[key] = {"bm": int(bm), "bn": int(bn), "bk": int(bk),
                             "us": round(float(us), 2)}


# --------------------------------------------------------------------------
# Process-wide table + LRU resolution (what fused_qmm consults)
# --------------------------------------------------------------------------

_table: Optional[TuningTable] = None

# Distinct-resolution counters (resolve_tiles is LRU-cached, so repeats of
# the same problem don't re-count).
COUNTERS = {"hit": 0, "miss": 0}


def get_table() -> TuningTable:
    """The process-wide table, lazily loaded from the committed JSON."""
    global _table
    if _table is None:
        if DEFAULT_TABLE_PATH.exists():
            _table = TuningTable.load(DEFAULT_TABLE_PATH)
        else:
            _table = TuningTable()
    return _table


def set_table(table: Optional[TuningTable]) -> None:
    """Swap the process-wide table (None re-arms the lazy JSON load) and
    drop the resolution cache so stale tiles can't be served."""
    global _table
    _table = table
    resolve_tiles.cache_clear()


@functools.lru_cache(maxsize=4096)
def resolve_tiles(m: int, n: int, k: int, *, dtypes: Tuple[str, str],
                  modes: Tuple[str, str], trans: Tuple[bool, bool],
                  block: int = 128) -> Optional[Tuple[int, int, int]]:
    """Table lookup for one problem; None on a miss, on an entry whose
    tiles do not divide the dims (the reference's rule) and on one the
    kernels are not built for (the port's)."""
    tiles = get_table().lookup(tuning_key(m, n, k, dtypes, modes, trans,
                                          block))
    if tiles is not None:
        bm, bn, bk = tiles
        ok = all(t > 0 and t % block == 0 for t in tiles)
        if ok and m % bm == 0 and n % bn == 0 and k % bk == 0 \
                and tiles in TILINGS:
            COUNTERS["hit"] += 1
            return tiles
    COUNTERS["miss"] += 1
    return None


# --------------------------------------------------------------------------
# The record of the calls (what --autotune sweeps)
# --------------------------------------------------------------------------

_RECORDS: List[Dict[str, dict]] = []


@contextlib.contextmanager
def recording():
    """Collect, inside, the first call of every distinct key that
    ``fused_qmm`` resolves (yielded: key -> the call's arguments, as
    ``autotune_qmm`` takes them)."""
    jobs: Dict[str, dict] = {}
    _RECORDS.append(jobs)
    try:
        yield jobs
    finally:
        _RECORDS.remove(jobs)


def recording_now() -> bool:
    """Whether a ``recording`` is open."""
    return bool(_RECORDS)


def note_call(key: str, **job) -> None:
    """``fused_qmm``'s record of one call (a no-op outside ``recording``)."""
    for jobs in _RECORDS:
        jobs.setdefault(key, job)


# --------------------------------------------------------------------------
# The measurement sweep (--autotune drives this)
# --------------------------------------------------------------------------

def candidate_tiles(dim: int, block: int = 128,
                    max_mult: int = 4) -> List[int]:
    """Tile candidates for one dim: multiples of ``block`` that divide it."""
    return [c * block for c in range(1, max_mult + 1)
            if dim % (c * block) == 0]


def _round_up(x: int, block: int) -> int:
    return -(-x // block) * block


def _best_time_us(torch, fn, reps: int) -> float:
    """Best of ``reps`` CUDA-event times of ``fn`` after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return min(times)


def autotune_qmm(m: int, n: int, k: int, *,
                 a_mode: str = "block", b_mode: str = "tile",
                 a_fmt: str = "fp4_e2m1", b_fmt: str = "fp4_e2m1",
                 a_pow2: bool = False, b_pow2: bool = False,
                 dtype: str = "bfloat16",
                 trans_a: bool = False, trans_b: bool = False,
                 a_sr: bool = False, b_sr: bool = False,
                 seed_a: Optional[int] = None, seed_b: Optional[int] = None,
                 collect_stats: bool = False, batch: int = 0,
                 block: int = 128, pipeline: str = "stream",
                 reps: int = 5, table: Optional[TuningTable] = None,
                 times: Optional[dict] = None,
                 ) -> Tuple[Tuple[int, int, int], float]:
    """Sweep the ``(bm, bn, bk)`` candidates the kernels are built for
    (the reference's ``candidate_tiles`` of each rounded-up dim, kept to
    ``build.TILINGS``) for one problem on the card, with operands drawn
    from a seeded ``torch.Generator`` (``batch`` > 0: that many pairs, as
    the MoE experts run; SR seeds ``seed_a`` / ``seed_b``, or fixed
    ones), and record the winner into ``table`` (default:
    the process-wide table) under the key ``fused_qmm`` will look up.
    ``times`` (a dict) receives each candidate's time.  Returns
    ``(tiles, best_us)``."""
    import torch

    from repro_torch.kernels.fp4_matmul import fused_qmm

    dt = getattr(torch, dtype)
    km, kn, kk = (_round_up(d, block) for d in (m, n, k))
    g = torch.Generator(device="cuda").manual_seed(0)
    lead = (batch,) if batch else ()

    def operand(shape):
        return torch.randn(*lead, *shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dt)
    a = operand((k, m) if trans_a else (m, k))
    b = operand((n, k) if trans_b else (k, n))
    seeds = dict(seed_a=(1 if seed_a is None else seed_a) if a_sr else None,
                 seed_b=(2 if seed_b is None else seed_b) if b_sr else None)
    best_tiles, best_us = None, float("inf")
    for tiles in TILINGS:
        bm, bn, bk = tiles
        if bm not in candidate_tiles(km, block) or \
                bn not in candidate_tiles(kn, block) or \
                bk not in candidate_tiles(kk, block):
            continue
        us = _best_time_us(torch, lambda: fused_qmm(
            a, b, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt, b_fmt=b_fmt,
            a_pow2=a_pow2, b_pow2=b_pow2, a_sr=a_sr, b_sr=b_sr,
            trans_a=trans_a, trans_b=trans_b, pipeline=pipeline,
            collect_stats=collect_stats, bm=bm, bn=bn, bk=bk, **seeds),
            reps)
        if times is not None:
            times[tiles] = us
        if us < best_us:
            best_tiles, best_us = tiles, us
    assert best_tiles is not None, (m, n, k, block)
    key = tuning_key(km, kn, kk, (dtype, dtype), (a_mode, b_mode),
                     (trans_a, trans_b), block)
    tab = table if table is not None else get_table()
    tab.record(key, *best_tiles, best_us)
    resolve_tiles.cache_clear()
    return best_tiles, best_us


# The training steps whose keys --autotune sweeps: the launch/train.py
# argv of each (paper_fp4, both impls on the kernels), and the depth it
# runs at (a layer issues the same keys at any depth, so one of each kind
# of layer is enough: the keys depend on the widths and the tokens).
TRAIN_JOBS = (
    (("--arch", "gpt2-125m", "--recipe", "paper_fp4", "--linear-impl",
      "pallas", "--attention-impl", "pallas", "--batch", "8", "--seq",
      "1024"), 1),
    (("--arch", "llama3.2-3b", "--recipe", "paper_fp4", "--linear-impl",
      "pallas", "--attention-impl", "pallas", "--batch", "4", "--seq",
      "2048"), 1),
)


def training_jobs(argv, n_layers: Optional[int] = None,
                  device: str = "cuda") -> Dict[str, dict]:
    """The distinct keys (and the first call of each) of one training
    step of the ``launch/train.py`` configuration ``argv`` (its model and
    ``TrainConfig``, one step, cut to ``n_layers``), as ``fused_qmm``
    records them: the forward, the backward's dgrad and wgrad and the
    rematerialized forward, on both routes."""
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    from repro_torch.data import make_pipeline
    from repro_torch.train.trainer import Trainer

    args = cli.parse_args([*argv, "--steps", "1", "--device", device])
    cfg = cli.model_config(args)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg, device)
    trainer = Trainer(model, cli.train_config(args),
                      make_pipeline(args.data, cfg.vocab_size, args.seq,
                                    args.batch))
    state = trainer.init_state(on_device=device == "cuda")
    with recording() as jobs:
        trainer.train(state, num_steps=1)
    return jobs


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def autotune_training(path, reps: int = 5, log=print) -> TuningTable:
    """Sweep every key of ``TRAIN_JOBS`` on the card into a new table
    saved at ``path`` (its meta names the card, its power limit and the
    command); returns the table."""
    import torch
    jobs: Dict[str, dict] = {}
    for argv, n_layers in TRAIN_JOBS:
        for key, job in training_jobs(argv, n_layers).items():
            jobs.setdefault(key, job)
        torch.cuda.empty_cache()
    table = TuningTable(meta={
        "backend": "cuda", "device": torch.cuda.get_device_name(0),
        "card": _card_line(),
        "command": "python -m repro_torch.kernels.autotune --autotune "
                   + shlex.quote(str(path)),
        "jobs": [" ".join(argv) + f" (depth {n})"
                 for argv, n in TRAIN_JOBS],
        "note": "best of CUDA-event times after a warm-up, L2 warm"})
    for key in sorted(jobs):
        times: dict = {}
        tiles, us = autotune_qmm(**jobs[key], reps=reps, table=table,
                                 times=times)
        log(f"{key}: " + " ".join(f"{bm}x{bn}={t:.1f}us"
                                  for (bm, bn, _), t in times.items())
            + f" -> {tiles[0]}x{tiles[1]}")
    table.save(path)
    return table


# --------------------------------------------------------------------------
# Validation (the committed table's gate)
# --------------------------------------------------------------------------

def validate_table(path) -> List[str]:
    """Return a list of problems with the table file at ``path`` (empty =
    valid): schema tag, key syntax, tiles that are positive multiples of
    the key's block and divide the key's dims, and a lookup round-trip.
    The reference's checks, error for error."""
    errors: List[str] = []
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable table: {e}"]
    if data.get("schema") != SCHEMA:
        errors.append(f"schema {data.get('schema')!r} != {SCHEMA!r}")
        return errors
    entries = data.get("entries")
    if not isinstance(entries, dict) or not entries:
        errors.append("entries missing or empty")
        return errors
    table = TuningTable(entries=entries)
    for key, ent in entries.items():
        mobj = _KEY_RE.match(key)
        if not mobj:
            errors.append(f"{key}: malformed key")
            continue
        m, n, k, block = (int(g) for g in mobj.groups())
        try:
            bm, bn, bk = (int(ent[f]) for f in ("bm", "bn", "bk"))
            us = float(ent["us"])
        except (KeyError, TypeError, ValueError) as e:
            errors.append(f"{key}: malformed entry ({e})")
            continue
        for name, tile, dim in (("bm", bm, m), ("bn", bn, n),
                                ("bk", bk, k)):
            if tile <= 0 or tile % block != 0:
                errors.append(f"{key}: {name}={tile} not a positive "
                              f"multiple of block {block}")
            elif dim % tile != 0:
                errors.append(f"{key}: {name}={tile} does not divide {dim}")
        if not us > 0:
            errors.append(f"{key}: non-positive us {us}")
        if table.lookup(key) != (bm, bn, bk):
            errors.append(f"{key}: lookup round-trip failed")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validate", metavar="PATH",
                    default=str(DEFAULT_TABLE_PATH),
                    help="tuning-table JSON to validate")
    ap.add_argument("--autotune", metavar="PATH", default=None,
                    help="sweep the training steps' keys on the card and "
                         "write the table to PATH")
    args = ap.parse_args(argv)
    if args.autotune is not None:
        autotune_training(args.autotune)
        args.validate = args.autotune
    errors = validate_table(args.validate)
    if errors:
        for e in errors:
            print(f"FAIL {e}")
        return 1
    n = len(TuningTable.load(args.validate).entries)
    print(f"OK {args.validate}: {n} entries valid")
    return 0


if __name__ == "__main__":
    # ``python -m`` runs a second copy of this module as __main__; fused_qmm
    # records into and resolves from the package's copy, so run that one
    from repro_torch.kernels import autotune as _package_module
    sys.exit(_package_module.main())
