"""Rank bodies for the port's multi-process tests (torch only: a spawned
rank imports this module, not a test module that imports JAX).

``run_ranks(name, world, tmp_path, *args)`` spawns ``world`` processes
that join a ``gloo`` group through a ``FileStore`` under ``tmp_path``
(never a fixed TCP port: test workers run side by side), call
``name(rank, world, *args)`` and return its results in rank order.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, out_dir, name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(name: str, world: int, tmp_path, *args) -> list:
    out_dir = os.path.join(str(tmp_path), f"{name}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    mp.spawn(_entry, args=(world, store, out_dir, name, args), nprocs=world,
             join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def psum_tree(rank, world, grads, residuals):
    """``compressed_psum_grads`` of this rank's slice of stacked trees,
    with the census of the collectives it issued."""
    from repro_torch.distributed import comms
    from repro_torch.optim import compressed_psum_grads
    g = {k: torch.from_numpy(np.asarray(v[rank])) for k, v in grads.items()}
    r = {k: torch.from_numpy(np.asarray(v[rank]))
         for k, v in residuals.items()}
    with comms.recording() as log:
        out, res = compressed_psum_grads(g, r)
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in res.items()},
            [rec.to_dict() for rec in log])


def psum_sum(rank, world, x):
    """``compressed_psum(mean=False)`` of this rank's row."""
    from repro_torch.optim import compressed_psum
    t = torch.from_numpy(np.asarray(x[rank]))
    out, _ = compressed_psum(t, torch.zeros_like(t), mean=False)
    return out.numpy()


def _tiny_trainer(over: dict, ckpt_dir: str = "", steps: int = 3):
    """A ``Trainer`` of ``tiny`` in f32 (the reference's test sizes:
    global batch 4 x 32), ``over`` its ``TrainConfig`` fields."""
    import importlib
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    cfg = importlib.import_module("repro_torch.configs.tiny").CONFIG
    cfg = cfg.replace(dtype="float32")
    kw = dict(recipe="bf16", total_steps=steps, global_batch=4, seq_len=32,
              log_every=0)
    if ckpt_dir:
        kw.update(checkpoint_every=2, checkpoint_dir=ckpt_dir)
    kw.update(over)
    model = build_model(cfg, "cpu")
    pipe = SyntheticLM(cfg.vocab_size, kw["seq_len"], kw["global_batch"])
    return Trainer(model, TrainConfig(**kw), pipe)


def _rows(tr) -> list:
    return [{k: v for k, v in row.items()
             if isinstance(v, (int, float, str))} for row in tr.history]


def _full(tr, state):
    """(params, AdamW mu, residuals) as full trees (a checkpoint's)."""
    if tr.dp is None:
        return state.params, state.opt_state.mu, state.comp_state
    comp = tr._gather_comp(state.comp_state) if tr._spmd else \
        state.comp_state
    return (tr.dp.full(state.params), tr.dp.full(state.opt_state.mu),
            comp)


def _np_leaves(tree) -> list:
    from repro_torch.tree import tree_leaves
    if not isinstance(tree, (dict, list)):
        return []
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def train_mesh(rank, world, over, steps, ckpt_dir="", params=None):
    """``_tiny_trainer`` on a (world, 1) mesh for ``steps`` steps (from
    the reference's ``params``, a numpy tree, when given): its history,
    its full params / moments / residuals and the census of its last
    step."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comms
    from repro_torch.tree import tree_leaves
    tr = _tiny_trainer(dict(over, mesh_shape=(world, 1)), ckpt_dir, steps)
    state = tr.init_state(params=None if params is None else
                          params_from_jax(params, tr.model.cfg))
    if steps > 1:
        state = tr.train(state, num_steps=steps - 1)
    with comms.recording() as log:
        state = tr.train(state, num_steps=1)
    params, mu, comp = _full(tr, state)
    return {"history": _rows(tr), "params": _np_leaves(params),
            "mu": _np_leaves(mu), "comp": _np_leaves(comp),
            "census": log, "local_shapes": [
                tuple(t.shape) for t in tree_leaves(state.params)]}


def reduced_vs_local(rank, world):
    """One fp8 step's pieces on a (world, 1) mesh: this rank's local
    gradients and residuals before the reduction, and the reduced
    gradients and new residuals after it."""
    from repro_torch.optim import compressed_psum_grads
    from repro_torch.train.train_step import _grads
    tr = _tiny_trainer(dict(mesh_shape=(world, 1), fsdp=False,
                            grad_compression="fp8"))
    from repro_torch.tree import tree_map
    state = tr.init_state()
    # a nonzero residual: what a later step carries
    gen = torch.Generator().manual_seed(rank)
    res = tree_map(lambda r: torch.randn(r.shape[1:], generator=gen) * 1e-4,
                   state.comp_state)
    batch = tr.dp.rows(tr._batch(tr.pipeline, 0))
    _, _, grads, _ = _grads(tr.model, tr.plan, state.params, batch)
    red, new = compressed_psum_grads(grads, res, tr.dp.group)
    return {"local": _np_leaves(grads), "res": _np_leaves(res),
            "reduced": _np_leaves(red), "new": _np_leaves(new)}


def qlint_mesh(rank, world):
    """qlint's CLI with ``--mesh world,1`` on ``tiny`` (every rank)."""
    from repro_torch.analysis import qlint
    reports = qlint.build_reports("tiny", "fine_grained_fp4", impl="pallas",
                                  mesh=(world, 1), device="cpu")
    return [r.to_dict() for r in reports]


def resume_mesh(rank, world, ckpt_dir, steps):
    """A fresh (world, 1) ``Trainer`` (fsdp) resumed from ``ckpt_dir``
    and trained to ``steps``: where it started, its rows, its full
    params."""
    tr = _tiny_trainer(dict(mesh_shape=(world, 1)), ckpt_dir, steps)
    state = tr.resume()
    start = state.step
    state = tr.train(state)
    return {"start": start, "history": _rows(tr),
            "params": _np_leaves(_full(tr, state)[0])}
