"""Rank bodies for the port's multi-process tests (torch only: a spawned
rank imports this module, not a test module that imports JAX).

``run_ranks(name, world, tmp_path, *args)`` spawns ``world`` processes
that join a ``gloo`` group through a ``FileStore`` under ``tmp_path``
(never a fixed TCP port: test workers run side by side), call
``name(rank, world, *args)`` and return its results in rank order;
``start_ranks`` spawns them and returns the call that waits for them, so
that a test can run other work (another group, a one-process run) while
they run.  ``torch_threads`` is the test modules' fixture of PyTorch's
intra-op threads.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """A test module that imports this fixture runs on one PyTorch
    intra-op thread, restored after it: the suite runs several worker
    processes side by side, and a pool of a thread a core in each
    oversubscribes the cores (a 2-step ``tiny`` run took 20.9 s on 8
    threads beside seven busy processes, 3.4 s on one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _entry(rank, world, store, out_dir, name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(name: str, world: int, tmp_path, *args):
    """Spawn ``run_ranks``'s processes and return a call that waits for
    them and returns their results in rank order."""
    out_dir = os.path.join(str(tmp_path), f"{name}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_entry, args=(world, store, out_dir, name,
                                           args),
                             nprocs=world, join=False, start_method="spawn")

    def results() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    return results


def run_ranks(name: str, world: int, tmp_path, *args) -> list:
    return start_ranks(name, world, tmp_path, *args)()


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
    global batch 4 x 32), ``over`` its ``TrainConfig`` fields, and under
    ``"model"`` the config's fields to replace (``"experts"``: an MoE
    config's expert count); ``"arch"`` another config's ``REDUCED`` size
    instead of ``tiny``; ``"embed_axes"`` builds the rules of the mesh
    ``mesh_shape`` x ``mesh_axes`` with the embed leaves over those data
    axes alone, ``"whole_heads"`` the mesh's rules with the attention's
    heads kept whole on every model rank, ``"whole"`` with those logical
    axes whole (as ``"whole_heads"`` does with the heads)."""
    import dataclasses
    import importlib
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    over = dict(over)
    arch = over.pop("arch", "tiny")
    mod = importlib.import_module("repro_torch.configs."
                                  + arch.replace("-", "_"))
    cfg = mod.CONFIG if arch == "tiny" else mod.REDUCED
    model_over = dict(over.pop("model", {}))
    if "experts" in model_over:
        model_over["moe"] = dataclasses.replace(
            cfg.moe, num_experts=model_over.pop("experts"))
    cfg = cfg.replace(**{"dtype": "float32", **model_over})
    embed_axes = over.pop("embed_axes", None)
    whole = tuple(over.pop("whole", ())) + (
        ("heads", "kv_heads") if over.pop("whole_heads", False) else ())
    kw = dict(recipe="bf16", total_steps=steps, global_batch=4, seq_len=32,
              log_every=0)
    if ckpt_dir:
        kw.update(checkpoint_every=2, checkpoint_dir=ckpt_dir)
    kw.update(over)
    rules = None
    if embed_axes is not None or whole:
        from repro_torch.distributed.mesh import make_mesh
        from repro_torch.distributed.sharding import default_rules
        shape = kw.pop("mesh_shape")
        axes = kw.pop("mesh_axes", None) or ("data", "model")
        whole = dict.fromkeys(whole)
        rules = default_rules(make_mesh(shape, axes), cfg,
                              overrides=dict(whole, **(
                                  {} if embed_axes is None
                                  else {"embed": embed_axes})),
                              act_overrides=whole)
    model = build_model(cfg, "cpu")
    pipe = SyntheticLM(cfg.vocab_size, kw["seq_len"], kw["global_batch"])
    return Trainer(model, TrainConfig(**kw), pipe, rules=rules)


def _rows(tr) -> list:
    return [{k: v for k, v in row.items()
             if isinstance(v, (int, float, str))} for row in tr.history]


def _full(tr, state):
    """(params, AdamW mu or adafactor's [vr, vc], residuals) as full trees
    (a checkpoint's)."""
    opt = (state.opt_state if tr.dp is None
           else tr.dp.full_opt_state(state.opt_state))
    mu = opt.mu if hasattr(opt, "mu") else [opt.vr, opt.vc]
    if tr.dp is None:
        return state.params, mu, state.comp_state
    comp = tr._gather_comp(state.comp_state) if tr._spmd else \
        state.comp_state
    return tr.dp.full(state.params), mu, comp


def _np_leaves(tree) -> list:
    from repro_torch.tree import tree_leaves
    if not isinstance(tree, (dict, list)):
        return []
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def train_mesh(rank, world, over, steps, ckpt_dir="", params=None):
    """``_tiny_trainer`` on a (world, 1) mesh (unless ``over`` names one)
    for ``steps`` steps (from the reference's ``params``, a numpy tree,
    when given): its history, its full params / moments (AdamW's mu, or
    adafactor's row and column factors) / residuals and the census of its
    last step."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comms
    from repro_torch.tree import tree_leaves
    tr = _tiny_trainer(dict(dict(mesh_shape=(world, 1)), **over), ckpt_dir,
                       steps)
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


def train_cases(rank, world, cases, params=None):
    """``train_mesh`` of each ``(name, over, steps)`` of ``cases`` in
    turn, in this one process group: {name: its result}."""
    return {name: train_mesh(rank, world, over, steps, "", params)
            for name, over, steps in cases}


def _linear_case(impl, recipe, x, w, c, split):
    """One quantized linear ``y = x @ w`` under ``impl`` with the
    cotangent ``c`` (``split``: this rank's token split, or None): the
    wgrad role's quantized operands as captured (x's QDQ in x's (M, K)
    layout, g's in (M, N)), and dw."""
    from repro_torch.core import qlinear as ql
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.nn import layers
    seen = []

    def capture(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.append(out[0] if isinstance(out, tuple) else out)
            return out
        return wrapped
    orig = (ql.qdq, fm.quantize_rows)
    ql.qdq, fm.quantize_rows = capture(ql.qdq), capture(fm.quantize_rows)
    try:
        xr = x.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        with layers.sharding_context(None, split), \
                fm.use_pipeline("two_pass"):
            y = ql.qlinear(xr, wr, recipe, impl=impl)
            (y * c).sum().backward()
    finally:
        ql.qdq, fm.quantize_rows = orig
    qa, qb = seen[-2:]        # the wgrad role quantizes last: A', B'
    if impl == "qdq":         # A' = x^T, quantized in (K, M)
        qa = qa.T
    return [qa.detach().clone(), qb.detach().clone(), wr.grad.clone()]


def _moe_split(rank, world, split, recipe):
    """olmoe-1b-7b ``REDUCED`` (f32, 4 x 64 tokens: two router groups a
    rank) under ``recipe``: this rank's loss, metrics and gradients under
    the token split, and one process's on the whole batch."""
    import importlib
    from repro_torch.core.recipe import RECIPES, as_plan
    from repro_torch.models import build_model
    from repro_torch.nn import layers
    from repro_torch.train.train_step import _grads
    cfg = importlib.import_module("repro_torch.configs.olmoe_1b_7b")
    cfg = cfg.REDUCED.replace(dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(0)
    plan = as_plan(RECIPES[recipe], cfg.n_layers)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    n = 4 // world
    rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}

    def run(b, sp):
        with layers.sharding_context(None, sp):
            loss, metrics, grads, _ = _grads(model, plan, params, b)
        from repro_torch.tree import tree_leaves
        return {"loss": float(loss),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": [g.numpy() for g in tree_leaves(grads)]}
    return {"split": run(rows, split), "whole": run(batch, None)}


def wgrad_operands(rank, world, cases, moe_recipe=None):
    """Each case ``(name, impl, recipe, m)``: one linear of (m, 128) x
    (128, 192) from a seeded draw, on this rank's rows under the token
    split, on the same rows with no split (the control: local amax, SR
    keyed from 0), and on all m rows in this process (one process):
    {name: {"split", "local", "whole"} operand lists, or "error": the
    ``ValueError`` it raised}; with ``moe_recipe`` also a MoE model's
    loss and gradients (``"moe"``, ``_moe_split``)."""
    from repro_torch.core.quantize import TokenSplit
    split = TokenSplit(dist.group.WORLD, rank, world)
    out = {}
    if moe_recipe is not None:
        out["moe"] = _moe_split(rank, world, split, moe_recipe)
    for name, impl, recipe, m in cases:
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal((m, 128),
                                                 dtype=np.float32) * 3)
        w = torch.from_numpy(rng.standard_normal((128, 192),
                                                 dtype=np.float32) * 0.1)
        c = torch.from_numpy(rng.standard_normal((m, 192),
                                                 dtype=np.float32))
        n = m // world
        rows = slice(rank * n, (rank + 1) * n)
        try:
            got = _linear_case(impl, recipe, x[rows], w, c[rows], split)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        out[name] = {
            "split": [t.numpy() for t in got],
            "local": [t.numpy() for t in _linear_case(
                impl, recipe, x[rows], w, c[rows], None)],
            "whole": [t[rows].numpy() if i < 2 else t.numpy() for i, t in
                      enumerate(_linear_case(impl, recipe, x, w, c,
                                             None))]}
    return out


# ---------------------------------------------------------------------------
# tensor parallelism (the model axis)
# ---------------------------------------------------------------------------

_ROLES = ("fwd", "dgrad", "wgrad")


def _model_linear(impl, recipe, tp, x, w, c, msplit):
    """One linear ``y = x @ w`` (``tp``: col | row, ``x`` / ``w`` / ``c``
    this rank's blocks) with the cotangent ``c`` under the model split
    ``msplit`` (None: none): the QDQ'd operands of its three roles as
    captured, each ``(role, side, effective operand)`` (A' / B' of the
    role), and ``[y, dx, dw]``."""
    from repro_torch.core import qlinear as ql
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.nn import layers
    seen, current = [], [None]

    def track(fn):                  # the role of each matmul
        def wrapped(*a, **k):
            current[0] = k.get("role")
            return fn(*a, **k)
        return wrapped

    def capture_qdq(fn):            # "qdq": A' then B', every role
        def wrapped(x2d, spec, *a, **k):
            out = fn(x2d, spec, *a, **k)
            i = len(seen)
            seen.append((_ROLES[i // 2], "ab"[i % 2], out))
            return out
        return wrapped

    def capture_grid(fn):           # kernels: quant orientation, no pass
        def wrapped(x2d, spec, *a, **k):
            out = fn(x2d, spec, *a, **k)
            if not spec.is_passthrough:
                role = current[0]
                specs = {"fwd": (recipe.fwd_x, recipe.fwd_w),
                         "dgrad": (recipe.dgrad_g, recipe.dgrad_w),
                         "wgrad": (recipe.wgrad_x, recipe.wgrad_g)}[role]
                done = sum(r == role for r, _, _ in seen)
                side = "b" if done or specs[0].is_passthrough else "a"
                seen.append((role, side, out.T if side == "b" else out))
            return out
        return wrapped
    orig = (ql.qdq, qs.qdq_grid_ref, qr.qdq_grid_ref, ql._role)
    ql._role = track(ql._role)
    if impl == "qdq":
        ql.qdq = capture_qdq(ql.qdq)
    else:
        qs.qdq_grid_ref = capture_grid(qs.qdq_grid_ref)
        qr.qdq_grid_ref = capture_grid(qr.qdq_grid_ref)
    try:
        xr = x.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        with layers.sharding_context(None, None, msplit):
            y = ql.qlinear(xr, wr, recipe, impl=impl, tp=tp)
            (y * c).sum().backward()
    finally:
        ql.qdq, qs.qdq_grid_ref, qr.qdq_grid_ref, ql._role = orig
    return ([(r, s, t.detach().clone()) for r, s, t in seen],
            [y.detach().clone(), xr.grad.clone(), wr.grad.clone()])


def model_operands(rank, world, cases):
    """Each case ``(name, impl, recipe, tp, (m, k, n))``: one linear of
    (m, k) x (k, n) from a seeded draw, its weight (and the activation
    or cotangent that meets the split) cut to this rank's block of the
    model axis: {name: {"split": operands under the model split, "local":
    the same blocks with no split (the control: each rank's own amax, SR
    keyed from 0), "whole": one process's operands on the whole tensors
    cut to this rank's block along each operand's split axis, "outs" /
    "outs_whole": [y, dx, dw]}}, or {"error": the ``ValueError``}."""
    from repro_torch.core.qlinear import ROLE_MODEL
    from repro_torch.core.quantize import ModelSplit
    from repro_torch.core.recipe import RECIPES, MatmulRecipe
    msplit = ModelSplit(dist.group.WORLD, rank, world)
    out = {}
    for name, impl, recipe, tp, (m, k, n) in cases:
        if not isinstance(recipe, MatmulRecipe):
            recipe = getattr(RECIPES[recipe[0]], recipe[1])
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                             * 3)
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                             * 0.1)
        c = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))

        def blk(t, dim):
            size = t.shape[dim] // world
            return t.narrow(dim, rank * size, size)
        if tp == "col":
            xs, ws, cs = x, blk(w, 1), blk(c, 1)
        else:
            xs, ws, cs = blk(x, 1), blk(w, 0), c
        try:
            ops, outs = _model_linear(impl, recipe, tp, xs, ws, cs, msplit)
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        local, _ = _model_linear(impl, recipe, tp, xs, ws, cs, None)
        whole, outs_whole = _model_linear(impl, recipe, tp, x, w, c, None)
        cut = []
        for role, side, t in whole:
            axis = ROLE_MODEL[tp][role]["ab".index(side)]
            cut.append(t if axis is None else blk(t, axis))
        out[name] = {
            "split": [(r, s, t.numpy()) for r, s, t in ops],
            "local": [t.numpy() for _, _, t in local],
            "whole": [t.contiguous().numpy() for t in cut],
            "outs": [t.numpy() for t in outs],
            "outs_whole": [t.numpy() for t in outs_whole]}
    return out


# ---------------------------------------------------------------------------
# MoE on the model axis (expert parallelism, d_ff inside every expert)
# ---------------------------------------------------------------------------

def _moe_sublayer(cfg, recipe, ffn, x, c, msplit, partial=False):
    """The MoE sublayer of ``ffn`` (layer params, the rank's blocks) on
    ``x`` with the output cotangent ``c`` under the model split
    ``msplit`` (None: whole experts): [y, dx, and each leaf's gradient in
    ``ffn``'s sorted key order].  ``partial``: the control, each rank's
    combine over its own experts alone (``moe.partial_combine``)."""
    import contextlib
    from repro_torch.models import moe as moe_lib
    from repro_torch.nn import layers
    xr = x.clone().requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in ffn.items()}
    with moe_lib.partial_combine() if partial else \
            contextlib.nullcontext(), \
            layers.sharding_context(None, None, msplit):
        y, _ = moe_lib.moe(leaves, cfg, xr, recipe)
        (y.to(torch.float32) * c).sum().backward()
    # f32 holds every bf16 value exactly
    return [t.float().cpu().numpy() for t in [y.detach(), xr.grad] + [
        leaves[k].grad for k in sorted(leaves)]]


def expert_sublayer(rank, world, cases):
    """Each case ``(name, arch, over, recipe, impl)``: layer 0's MoE
    sublayer of ``arch``'s ``REDUCED`` config (``over``: its fields to
    replace) from ``init(0)``, on a seeded (2, 128, D) input and output
    cotangent, on this rank's experts under the model split ("split"),
    the control ("partial"), and in one process on whole experts
    ("whole"): {name: each one's [y, dx, leaf gradients (sorted keys)]
    and "keys"}."""
    import dataclasses
    import importlib
    from repro_torch.core.quantize import ModelSplit
    from repro_torch.core.recipe import RECIPES
    from repro_torch.distributed import comms
    from repro_torch.models import build_model
    msplit = ModelSplit(dist.group.WORLD, rank, world)
    out = {}
    for name, arch, over, recipe, impl in cases:
        cfg = importlib.import_module(
            "repro_torch.configs." + arch.replace("-", "_")).REDUCED
        over = dict(over)
        if "experts" in over:
            over["moe"] = dataclasses.replace(
                cfg.moe, num_experts=over.pop("experts"))
        cfg = cfg.replace(linear_impl=impl, **over)
        model = build_model(cfg, "cpu")
        # layer 0 of the scanned stack (its leaves lead with the layers)
        ffn = {k: v[0] for k, v in model.cast_params(model.init(0))[
            "stack"]["groups"]["l00"]["ffn"].items()}
        mm = RECIPES[recipe].ffn_linear
        rng = np.random.default_rng(5)
        dt = getattr(torch, cfg.dtype)
        x = torch.from_numpy(rng.standard_normal(
            (2, 128, cfg.d_model), dtype=np.float32)).to(dt)
        c = torch.from_numpy(rng.standard_normal(
            (2, 128, cfg.d_model), dtype=np.float32))
        e = cfg.moe.num_experts
        ep = e % world == 0
        mine = {}
        for k, v in ffn.items():
            if k == "router":
                mine[k] = v
            elif ep:
                mine[k] = v.chunk(world, 0)[rank]
            else:       # d_ff: w_gate / w_up's last dim, w_down's dim 1
                mine[k] = v.chunk(world, 1 if k == "w_down" else 2)[rank]
        with comms.recording() as log:
            split = _moe_sublayer(cfg, mm, mine, x, c, msplit)
        out[name] = {
            "keys": sorted(ffn), "ep": ep, "split": split,
            "partial": _moe_sublayer(cfg, mm, mine, x, c, msplit, True),
            "whole": _moe_sublayer(cfg, mm, ffn, x, c, None),
            "census": [r.to_dict() for r in log]}
    return out


def moe_axis(rank, world, sublayer_cases, train, inits):
    """``expert_sublayer`` of ``sublayer_cases``, then ``train_mesh`` of
    each ``(name, over, steps)`` of ``train`` from the reference's
    ``inits[name]`` (numpy trees), in this one process group."""
    out = {"sublayer": expert_sublayer(rank, world, sublayer_cases)}
    for name, over, steps in train:
        out[name] = train_mesh(rank, world, over, steps, "", inits[name])
    return out


class _PlainKernels:
    """While entered, the fused pipeline (``kernels.fp4_matmul``) runs the
    plain versions of ``qmm_stream``, ``quantize_rows`` and ``tiled_mm``
    on whatever device its tensors are on."""

    def __enter__(self):
        from repro_torch.kernels import fp4_matmul
        from repro_torch.kernels import qmm_stream as qs
        from repro_torch.kernels import quantize_rows as qr
        from repro_torch.kernels import tiled_mm as tm

        def stream(a, b, *, a_sr=False, b_sr=False, seed_a=None,
                   seed_b=None, **kw):
            return qs.qmm_stream_plain(a, b, seed_a=seed_a if a_sr else None,
                                       seed_b=seed_b if b_sr else None, **kw)

        def quant(x, *, sr=False, seed=None, **kw):
            return qr.quantize_rows_plain(x, seed=seed if sr else None, **kw)
        self._saved = [(n, getattr(fp4_matmul, n)) for n in
                       ("qmm_stream", "quantize_rows", "tiled_mm")]
        fp4_matmul.qmm_stream, fp4_matmul.quantize_rows = stream, quant
        fp4_matmul.tiled_mm = tm.tiled_mm_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import fp4_matmul
        for n, fn in self._saved:
            setattr(fp4_matmul, n, fn)


class _OwnAmax:
    """While entered, the kernels' quant groups that meet the model split
    keep each rank's own amax (``ops.model_span`` finds no group to
    share): the control of a shared-amax check."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = ops.model_span
        ops.model_span = lambda *a, **kw: None
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.model_span = self._saved


def expert_tp_card(rank, world, recipes):
    """d_ff split inside every expert on the card: olmoe-1b-7b
    ``REDUCED`` in bf16 with 3 experts (32 of d_ff's 64 a rank), layer
    0's MoE sublayer under each recipe of ``recipes`` through the kernels
    (the batched amax-in entry of ``qmm_stream`` and the batched shared
    amax of ``quantize_rows``, the windows over the gloo group staged
    through host memory) and through their plain versions on the same
    card tensors: {recipe: {"kernels" / "plain": [y, dx, leaf grads] on
    the host, "own": the kernels with each rank's own amax (the control),
    "launches": each kernel's counts of the kernels' run}}; and
    the batched amax-in entry's quantized panels (each expert's operand
    times the identity) against the plain version's, bitwise
    ("panels": the number of differing panels)."""
    import dataclasses
    import importlib
    from repro_torch.core.quantize import ModelSplit, window_max
    from repro_torch.core.recipe import RECIPES
    from repro_torch.distributed import comms
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.models import build_model
    torch.cuda.set_device(0)
    msplit = ModelSplit(dist.group.WORLD, rank, world)
    cfg = importlib.import_module("repro_torch.configs.olmoe_1b_7b").REDUCED
    cfg = cfg.replace(linear_impl="pallas", moe=dataclasses.replace(
        cfg.moe, num_experts=3))
    model = build_model(cfg, "cpu")
    ffn = {k: v[0] for k, v in model.cast_params(model.init(0))[
        "stack"]["groups"]["l00"]["ffn"].items()}
    mine = {k: (v if k == "router" else v.chunk(
        world, 1 if k == "w_down" else 2)[rank]).cuda()
        for k, v in ffn.items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (2, 128, cfg.d_model), dtype=np.float32)).to(torch.bfloat16).cuda()
    c = torch.from_numpy(rng.standard_normal(
        (2, 128, cfg.d_model), dtype=np.float32)).cuda()
    kernels = (qs.KERNEL, qr.KERNEL)
    out = {}
    with comms.host_staging():
        for recipe in recipes:
            mm = RECIPES[recipe].ffn_linear
            for k in kernels:
                k.reset()
            got = _moe_sublayer(cfg, mm, mine, x, c, msplit)
            launches = {k.name: k.counts() for k in kernels}
            with _PlainKernels():
                plain = _moe_sublayer(cfg, mm, mine, x, c, msplit)
            with _OwnAmax():
                own = _moe_sublayer(cfg, mm, mine, x, c, msplit)
            out[recipe] = {"kernels": got, "plain": plain, "own": own,
                           "launches": launches}
        # the batched amax-in entry at the down projection's operands:
        # h (3, 256, 32) block groups along K, w_down (3, 32, 64) tile
        # groups, each group's amax maxed over both ranks' halves
        gen = torch.Generator(device="cuda").manual_seed(11)
        e, m, f, d = 3, 256, 32, cfg.d_model
        a = torch.randn(e, m, f, generator=gen, device="cuda").to(
            torch.bfloat16)
        b = (torch.randn(e, f, d, generator=gen, device="cuda") * 0.05).to(
            torch.bfloat16)

        def window(words):
            return window_max(words, msplit, f, 128)
        eye_k = torch.eye(f, dtype=torch.bfloat16,
                          device="cuda").expand(e, f, f).contiguous()
        differing = 0
        for args, kw in (
                ((a, eye_k), dict(a_mode="block", b_mode="pass",
                                  a_fmt="fp4_e2m1", b_fmt="bf16",
                                  amax_reduce_a=window)),
                ((eye_k, b), dict(a_mode="pass", b_mode="tile",
                                  a_fmt="bf16", b_fmt="fp4_e2m1",
                                  amax_reduce_b=window))):
            want = qs.qmm_stream_plain(*args, **kw)
            got = qs.qmm_stream(*args, **kw)
            differing += sum(not torch.equal(g_, w_)
                             for g_, w_ in zip(got, want))
        out["panels"] = differing
    return out


# ---------------------------------------------------------------------------
# mamba on the model axis (whole SSD heads a rank)
# ---------------------------------------------------------------------------

def _mamba_blocks(cfg, mixer, rank, world):
    """This rank's blocks of a mamba layer's leaves, as the reference's
    default rules lay them out on a (1, ``world``) mesh."""
    from repro_torch.distributed import AbstractMesh, default_rules
    from repro_torch.models.ssm import mamba_param_specs
    rules = default_rules(AbstractMesh((1, world), ("data", "model")), cfg)
    out = {}
    for k, sp in mamba_param_specs(cfg).items():
        dims = [d for d, names in rules.param_sharding(sp).dim_axes().items()
                if "model" in names]
        out[k] = (mixer[k].chunk(world, dims[0])[rank] if dims
                  else mixer[k])
    return out


@contextlib.contextmanager
def _statistic_control(kind=None):
    """Inside the block a split gated norm takes a control statistic:
    ``"own"``, each rank's mean of squares over its own columns alone;
    ``"forward"``, the group's sum in the forward only (``model_sum``:
    its cotangent the rank's own); ``None``, the mixer's own."""
    from repro_torch.core import qlinear
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.nn import layers
    if kind is None:
        yield
        return
    target, name, swap = {
        "own": (ssm_lib, "_gated_norm",
                lambda v, scale, d_inner: layers.rms_norm(v, scale)),
        "forward": (layers, "model_stat_sum", qlinear.model_sum),
    }[kind]
    orig = getattr(target, name)
    setattr(target, name, swap)
    try:
        yield
    finally:
        setattr(target, name, orig)


def _mamba_sublayer(cfg, recipe, mixer, x, c, control=None):
    """The mamba mixer of ``mixer`` (the rank's blocks) on ``x`` with the
    output cotangent ``c`` under whatever split is installed
    (``control``: ``_statistic_control``'s): [the norm's input, y, dx,
    and each leaf's gradient in sorted key order], f32 numpy on the
    host."""
    from repro_torch.models import ssm as ssm_lib
    seen = []
    xr = x.clone().requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in mixer.items()}
    with _statistic_control(control):
        orig = ssm_lib._gated_norm

        def capture(v, *a):
            seen.append(v.detach().clone())
            return orig(v, *a)
        ssm_lib._gated_norm = capture
        try:
            y = ssm_lib.mamba_mixer(leaves, cfg, xr, recipe)
            (y.to(torch.float32) * c).sum().backward()
        finally:
            ssm_lib._gated_norm = orig
    return [t.float().cpu().numpy() for t in [seen[0], y.detach(), xr.grad]
            + [leaves[k].grad for k in sorted(leaves)]]


def mamba_sublayer(rank, world, cases):
    """Each case ``(name, arch, over, recipe, impl)``: layer 0's mamba
    mixer of ``arch``'s ``REDUCED`` config (``over``: its fields to
    replace) from ``init(0)``, on a seeded (2, 128, D) input and output
    cotangent, on this rank's heads under the model split ("split"), the
    two controls ("own", "forward"), and in one process on whole leaves
    ("whole"): {name: each one's [norm input, y, dx, leaf gradients
    (sorted keys)], "keys" and "census"}."""
    import importlib
    from repro_torch.core.quantize import ModelSplit
    from repro_torch.core.recipe import RECIPES
    from repro_torch.distributed import comms
    from repro_torch.models import build_model
    from repro_torch.nn import layers
    msplit = ModelSplit(dist.group.WORLD, rank, world)
    out = {}
    for name, arch, over, recipe, impl in cases:
        cfg = importlib.import_module(
            "repro_torch.configs." + arch.replace("-", "_").replace(
                ".", "_")).REDUCED.replace(linear_impl=impl, **over)
        model = build_model(cfg, "cpu")
        mixer = {k: v[0] for k, v in model.cast_params(model.init(0))[
            "stack"]["groups"]["l00"]["mixer"].items()}
        mine = _mamba_blocks(cfg, mixer, rank, world)
        mm = RECIPES[recipe].ffn_linear
        rng = np.random.default_rng(5)
        dt = getattr(torch, cfg.dtype)
        x = torch.from_numpy(rng.standard_normal(
            (2, 128, cfg.d_model), dtype=np.float32)).to(dt)
        c = torch.from_numpy(rng.standard_normal(
            (2, 128, cfg.d_model), dtype=np.float32))
        res = {"keys": sorted(mixer), "split_keys": sorted(
            k for k in mixer if mine[k].shape != mixer[k].shape)}
        with layers.sharding_context(None, None, msplit):
            with comms.recording() as log:
                res["split"] = _mamba_sublayer(cfg, mm, mine, x, c)
            res["census"] = [r.to_dict() for r in log]
            for control in ("own", "forward"):
                res[control] = _mamba_sublayer(cfg, mm, mine, x, c, control)
        res["whole"] = _mamba_sublayer(cfg, mm, mixer, x, c)
        out[name] = res
    return out


def ssm_axis(rank, world, sublayer_cases, train, inits):
    """``mamba_sublayer`` of ``sublayer_cases``, then ``train_mesh`` of
    each ``(name, over, steps)`` of ``train`` from the reference's
    ``inits[name]`` (numpy trees), in this one process group."""
    out = {"sublayer": mamba_sublayer(rank, world, sublayer_cases)}
    for name, over, steps in train:
        out[name] = train_mesh(rank, world, over, steps, "", inits[name])
    return out


def mamba_tp_card(rank, world):
    """mamba2-780m's mixer at full width (one layer of ``init(0)``, bf16)
    on the card, 24 of its 48 heads a rank, under paper_fp4 through the
    kernels (in_dt's 24 columns of its one 128-wide tile sharing their
    amax over the ranks, out_proj's row-parallel K) and through their
    plain versions on the same card tensors, and the kernels with each
    rank's own norm statistic (the control): {"kernels" / "plain" /
    "own": [norm input, y, dx, leaf grads (sorted keys)] on the host,
    "launches": each kernel's counts of the kernels' run}."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import ModelSplit
    from repro_torch.core.recipe import RECIPES
    from repro_torch.distributed import comms
    from repro_torch.kernels import qmm_stream as qs
    from repro_torch.kernels import quantize_rows as qr
    from repro_torch.models import build_model
    from repro_torch.nn import layers
    torch.cuda.set_device(0)
    msplit = ModelSplit(dist.group.WORLD, rank, world)
    cfg = get_config("mamba2-780m").replace(
        n_layers=1, linear_impl="pallas", scan_layers=False)
    model = build_model(cfg, "cpu")
    mixer = model.cast_params(model.init(0))["stack"]["layers"][0]["mixer"]
    mine = {k: v.cuda() for k, v in
            _mamba_blocks(cfg, mixer, rank, world).items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (2, 256, cfg.d_model), dtype=np.float32)).to(torch.bfloat16).cuda()
    c = torch.from_numpy(rng.standard_normal(
        (2, 256, cfg.d_model), dtype=np.float32)).cuda()
    mm = RECIPES["paper_fp4"].ffn_linear
    kernels = (qs.KERNEL, qr.KERNEL)
    with comms.host_staging(), layers.sharding_context(None, None, msplit):
        for k in kernels:
            k.reset()
        got = _mamba_sublayer(cfg, mm, mine, x, c)
        launches = {k.name: k.counts() for k in kernels}
        with _PlainKernels():
            plain = _mamba_sublayer(cfg, mm, mine, x, c)
        own = _mamba_sublayer(cfg, mm, mine, x, c, "own")
    return {"kernels": got, "plain": plain, "own": own,
            "launches": launches}
