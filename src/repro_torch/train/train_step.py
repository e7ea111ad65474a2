"""One training step: loss, gradients (with microbatch accumulation),
global-norm clipping, fp8 gradient compression, the LR schedule and the
optimizer update (counterpart of ``repro.train.train_step``, eager).

The precision plan changes the math, so the trainer builds one step per
active plan, as the reference holds one compiled graph per plan; here a
step is a plain Python closure.

With ``TrainConfig.telemetry`` the step installs a telemetry collector
around the loss: the forward-side quant stats come back in the loss
metrics, the backward-side ones as the gradients of zero probes
(``telemetry.collect``), and the per-layer gradient norms are added.
With it off the step has no collector and no probes: it is the plain
step.

Data parallelism (``rules``, a ``distributed.sharding.ShardingRules``
over a live ``DeviceMesh``): ``torch.distributed`` runs one process a
device, each holding the whole step.  Each rank takes its rows of the
global batch (rows ``i*B/dp ...``, as ``rules.batch_sharding`` splits dim
0) and runs the model under ``rules.manual_over(rules.dp_axes)`` (its
slice is already the data shard: a data hint is a no-op).  The reduction follows the
reference's two orders:

  * ``grad_compression="fp8"`` with a data axis > 1: quantize before
    communicating, then clip — ``optim.compressed_psum_grads`` over the
    data group (1-byte codes on the wire, a shared f32 scale, each rank
    its own residual: the residual tree keeps the reference's leading
    replica axis, a rank holding its block ``(1, *shape)``).  The
    reference vmaps its model over per-shard slices there, so each
    slice's quantization is its own: the region carries no token split;
  * otherwise the mean gradient (weighted by each rank's count of
    targets, which makes it the global batch's gradient), then the
    global-norm clip.  The reference's step is then the one-device
    function of the global batch, so the region carries the token split
    (``core.quantize.TokenSplit``): a quant group spanning the tokens
    shares its amax across the data group, the kernels key their SR
    noise by the global rows, and the telemetry taps reduce their stats
    over the group, so every rank's quantization and stats are one
    process's.  Microbatches split the global batch first and each rank
    takes its rows of each, as the reference's reshape of the sharded
    batch does.  With ``fsdp`` the leaves the rules shard over the data
    axes (``embed``) and their optimizer state are held as blocks: the
    step all-gathers them for the forward, reduce-scatters their
    gradients, and clips by the norm of the whole gradient (the blocks'
    squared sums all-reduced).  A spec over part of the data axes (on a
    ``(pod, data, model)`` mesh, ``data`` alone) gathers and
    reduce-scatters over that axis's group and all-reduces over the
    others'.  Adafactor's factored moments reduce over the sharded dim
    (``optim.adafactor``, ``shards=``).

Tensor parallelism (a ``model`` axis > 1: a dense attention stack,
an MoE model, a mamba stack or the hybrid): the heads / kv_heads / mlp /
experts / mamba leaves are each rank's blocks of the model group and are
used as blocks (``models.attention``, ``models.mlp``: the Megatron
layout, the row-parallel sums and the cotangent sums placed there;
``models.moe``: a rank's experts, their outputs gathered, or its block
of every expert's ``d_ff``; ``models.ssm``: a rank's whole SSD heads,
the gated norm's statistic summed both ways); a ``vocab`` leaf that the rules split is gathered whole for the
forward, as fsdp's blocks are, and its gradient sliced back.  The region
carries the model split (``core.quantize.ModelSplit``) beside the token
split, so a quant group that meets it shares its amax over the model
group.  Every leaf's gradient is then the same on every model rank of a
data shard, or the rank's block, and reduces over the data group alone;
the clip's norm sums each block's squares over its groups
(``DataParallel.global_norm``).

With no rules, or data and model axes of 1, the step is the
single-device step:
clip, then ``fp8_compress_grads`` (the reference's order there), and no
collective.  Every collective goes through ``distributed.comms``, which
records it for the census.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.core.qlinear import matmul_impl
from repro_torch.core.quantize import ModelSplit, TokenSplit
from repro_torch.core.recipe import as_plan
from repro_torch.distributed import comms
from repro_torch.distributed.sharding import (Sharding, ShardingRules,
                                              opt_state_shardings)
from repro_torch.models.model import Model
from repro_torch.nn import layers
from repro_torch.nn.params import map_specs
from repro_torch.optim import (clip_by_global_norm, compressed_psum_grads,
                               fp8_compress_grads, get_optimizer,
                               warmup_cosine)
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState
from repro_torch.telemetry import collect as telemetry
from repro_torch.telemetry.profiler import phase_span
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "make_optimizer",
           "train_step_shardings", "compression_state_sharding",
           "DataParallel", "Shard", "check_rules"]


def make_optimizer(model: Model, tcfg: TrainConfig):
    return get_optimizer(
        model.cfg.optimizer, weight_decay=tcfg.weight_decay,
        beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps)


def _grads(model: Model, plan, params, batch, collector=None):
    """(loss, metrics, grads, probe grads): value and gradient of the loss
    with respect to every parameter leaf (a tree like ``params``) and,
    with a telemetry ``collector``, to fresh probes (else None)."""
    leaves = tree_leaves(params)
    unread = {id(p) for p in model.unread_leaves(params)}
    probes = None
    for p in leaves:
        p.requires_grad_(True)
    try:
        with phase_span("fwd"):
            if collector is None:
                loss, metrics = model.loss(params, batch, plan)
            else:
                probes = telemetry.make_probes(model.cfg.n_layers,
                                               model.device)
                with telemetry.collecting(collector, probes):
                    loss, metrics = model.loss(params, batch, plan)
                    metrics = {**metrics, **collector.drain_root()}
        with phase_span("bwd"):
            extra = list(probes.values()) if probes else []
            grads = torch.autograd.grad(loss, leaves + extra,
                                        allow_unused=bool(extra or unread))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    if any(g is None and id(p) not in unread
           for p, g in zip(leaves, grads)):
        raise RuntimeError("a parameter does not reach the loss")
    # an unread leaf's gradient is zeros, as the reference's: AdamW's
    # moments and weight decay then move it as there
    grads = [torch.zeros_like(p) if g is None and i < len(leaves) else g
             for i, (p, g) in enumerate(zip(leaves + extra, grads))]
    # a class with no tap in this model leaves its probe unused: its
    # gradient is zero, as in the reference
    pg = None if probes is None else {
        c: torch.zeros_like(p) if g is None else g
        for (c, p), g in zip(probes.items(), grads[len(leaves):])}
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params), pg)


# ---------------------------------------------------------------------------
# Mesh structure
# ---------------------------------------------------------------------------

def model_size(rules: Optional[ShardingRules]) -> int:
    """The size of the rules' ``model`` axis (1 without one)."""
    if rules is None or "model" not in rules.axis_names:
        return 1
    return rules.axis_size(("model",))


def check_rules(rules: ShardingRules, model: Optional[Model] = None
                ) -> None:
    """Raise ``NotImplementedError`` for a mesh axis other than the data
    axes and ``model`` that is larger than 1, and, on a model axis > 1,
    for a model the port does not split over it yet: one with cross
    attention (``vlm``, ``audio``).  A dense attention stack, an MoE
    model (expert parallelism, or ``d_ff`` split inside every expert), a
    mamba stack (``ssm``: whole SSD heads a rank) and the hybrid of all
    three split."""
    for name in rules.axis_names:
        if name not in rules.dp_axes and name != "model" \
                and rules.axis_size((name,)) > 1:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {rules.axis_size((name,))}: "
                "the port splits the data axes and 'model'")
    if model is not None and model_size(rules) > 1 \
            and model.cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"a {model.cfg.family} model on a model axis of "
            f"{model_size(rules)}: the port splits attention heads, "
            "kv_heads, mlp, vocab, experts and mamba heads; cross "
            "attention on the model axis is ROADMAP queue A")


def compression_state_sharding(rules: ShardingRules, param_shardings):
    """Shardings of the error-feedback residuals: with a data axis > 1 a
    leading replica axis over the data axes (each data shard owns its
    slice) before the parameter's own spec; else the params'."""
    dp = rules.dp_axes
    if rules.dp_size <= 1:
        return param_shardings

    def shift(sh: Sharding) -> Sharding:
        if sh.uses(dp):
            raise ValueError(
                "fp8 grad compression's per-shard residuals need params "
                "replicated over the data axes, but a param shards over "
                f"{sh.spec}.  Build rules with default_rules(..., "
                "fsdp=False) (TrainConfig.fsdp = False).")
        return Sharding(rules.mesh,
                        (dp[0] if len(dp) == 1 else dp,) + tuple(sh.spec))

    return tree_map(shift, param_shardings)


def train_step_shardings(model: Model, tcfg: TrainConfig,
                         rules: ShardingRules):
    """(in_shardings, out_shardings) of the step ``(params, opt_state,
    comp_state, batch, step, lr_scale)``, as the reference derives them:
    params and optimizer state from the rules, the batch's dim 0 over the
    data axes, the rest replicated."""
    p_shard = rules.param_shardings(model.param_specs())
    meta = map_specs(lambda sp: torch.empty(sp.shape, device="meta"),
                     model.param_specs())
    opt_like = make_optimizer(model, tcfg).init(meta)
    o_shard = opt_state_shardings(opt_like, meta, p_shard, rules.mesh)
    c_shard = (compression_state_sharding(rules, p_shard)
               if tcfg.grad_compression == "fp8" else rules.replicated())
    rep = rules.replicated()
    return ((p_shard, o_shard, c_shard, rules.batch_sharding(2), rep, rep),
            (p_shard, o_shard, c_shard, rep))


_GROUPS: Dict[Any, Any] = {}


def _ranks_group(ranks: Tuple[int, ...]):
    """The process group of ``ranks`` (made once; every rank of the world
    must ask for every such group in the same order)."""
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def _data_group(rules: ShardingRules):
    """The process group of the data axes: the ranks that share this
    rank's coordinates on every other axis (the whole mesh when every
    other axis is 1).  Every rank makes every such group, in one
    order."""
    mesh, axes = rules.mesh, rules.dp_axes
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    grid = mesh.mesh.permute(rest + keep).reshape(
        -1, rules.axis_size(axes))
    mine = dist.get_rank()
    out = None
    for row in grid.tolist():
        group = _ranks_group(tuple(sorted(row)))
        if mine in row:
            out = group
    return out


def _axes_group(rules: ShardingRules, axes: Tuple[str, ...]):
    """The process group of ``axes``, data axes of the mesh: all of them
    (the data group) or one (the mesh's own group of that axis, made with
    the mesh: every rank builds every axis's groups once)."""
    if axes == rules.dp_axes:
        return _data_group(rules)
    if len(axes) == 1:
        return rules.mesh.get_group(axes[0])
    raise NotImplementedError(f"a spec over the data axes {axes} of "
                              f"{rules.dp_axes}")


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf's layout on the data axes: its tensor dim ``dim`` is split
    over the data axes ``axes`` (``group``; this rank's block ``index``
    of ``size``).  ``rest``: the group of the other data axes, over which
    the blocks are replicas (None when the leaf shards over every data
    axis)."""

    dim: int
    axes: Tuple[str, ...]
    group: Any
    index: int
    size: int
    rest: Any = None

    def at(self, dim: Optional[int]) -> Optional["Shard"]:
        """The same split on another dim (None: the tensor is whole)."""
        return None if dim is None else dataclasses.replace(self, dim=dim)


def _factor_dims(dim: int, nd: int):
    """The dims of adafactor's (vr, vc) that a parameter's split ``dim``
    lands on (None: that factor is reduced over it, or has no such dim),
    as ``sharding.opt_state_shardings`` drops the trailing spec entries."""
    if nd < 2:
        return dim, None
    return (dim if dim < nd - 1 else None,
            dim if dim < nd - 2 else (nd - 2 if dim == nd - 1 else None))


def _factors(sh: Optional[Shard], nd: int):
    """(vr's, vc's) layout of a parameter split as ``sh``."""
    if sh is None:
        return None, None
    return tuple(sh.at(d) for d in _factor_dims(sh.dim, nd))


def _present(*shards) -> Optional[Tuple[Shard, ...]]:
    """The shards that are not None, or None when there is none."""
    out = tuple(sh for sh in shards if sh is not None)
    return out or None


class DataParallel:
    """A rank's side of a (data, model) mesh: its data group and index
    there, its model group and index there, and for each parameter leaf
    its layout: on the data axes (``shards``: a ``Shard``, None:
    replicated; ``dims``: the dims) and on the model axis (``mshards``;
    ``gathered``: a ``vocab`` leaf, gathered whole before the forward, its
    gradient sliced back).

    The model axis is the Megatron layout: the heads / kv_heads / mlp /
    experts / mamba leaves are used as the rank's blocks
    (``models.attention`` / ``models.mlp`` / ``models.moe`` /
    ``models.ssm`` place the row-parallel sums, the cotangent sums of
    the column-parallel inputs, the expert gathers and the gated norm's
    statistic), so their gradients are the rank's blocks; a leaf the
    rules keep whole over ``model`` (norms, biases, KV heads whose count
    does not divide the axis, an odd vocab, mamba's per-head
    ``dt_bias`` / ``a_log`` / ``d_skip`` and B / C groups that do not
    divide it) has the same gradient on every model rank (every
    activation it meets is summed over the model group first, and a whole
    leaf a rank reads in part passes ``model_grad_sum`` before the
    slice), so every gradient is reduced over the data group alone."""

    def __init__(self, model: Model, rules: ShardingRules):
        self.rules = rules
        self.size = rules.dp_size
        self.msize = model_size(rules)
        self.group = _data_group(rules) if rules.dp_axes else None
        self.index = (dist.get_rank(self.group) if self.group is not None
                      else 0)
        self.mgroup = (rules.mesh.get_group("model") if self.msize > 1
                       else None)
        self.mindex = (dist.get_rank(self.mgroup) if self.mgroup is not None
                       else 0)
        specs = model.param_specs()
        shardings = rules.param_shardings(specs)
        self.shards = tree_map(self._shard, shardings)
        self.dims = tree_map(lambda sh: None if sh is None else sh.dim,
                             self.shards)
        self.sharded = any(d is not None for d in tree_leaves(self.dims))
        self.mshards = tree_map(self._mshard, shardings)
        self.gathered = tree_map(
            lambda sh, axes: sh is not None and axes[sh.dim] == "vocab",
            self.mshards, map_specs(lambda sp: tuple(sp.axes), specs))
        self.msharded = any(sh is not None
                            for sh in tree_leaves(self.mshards))
        nds = map_specs(lambda sp: len(sp.shape), specs)
        dfac = tree_map(_factors, self.shards, nds)
        mfac = tree_map(_factors, self.mshards, nds)
        self.vr_shards = tree_map(lambda d, m: (d[0], m[0]), dfac, mfac)
        self.vc_shards = tree_map(lambda d, m: (d[1], m[1]), dfac, mfac)
        # adafactor's means: every split of a leaf (None: a whole leaf)
        self.opt_shards = tree_map(_present, self.shards, self.mshards)

    def _shard(self, sh: Sharding) -> Optional[Shard]:
        dp = self.rules.dp_axes
        dims = [d for d, names in sh.dim_axes().items()
                if any(a in dp for a in names)]
        if not dims or self.size <= 1:
            return None
        axes = tuple(a for a in sh.dim_axes()[dims[0]] if a in dp)
        if axes == dp:
            return Shard(dims[0], axes, self.group, self.index, self.size)
        group = _axes_group(self.rules, axes)
        rest = tuple(a for a in dp if a not in axes)
        return Shard(dims[0], axes, group, dist.get_rank(group),
                     self.rules.axis_size(axes),
                     _axes_group(self.rules, rest))

    def _mshard(self, sh: Sharding) -> Optional[Shard]:
        if self.msize <= 1:
            return None
        dims = [d for d, names in sh.dim_axes().items() if "model" in names]
        if not dims:
            return None
        return Shard(dims[0], ("model",), self.mgroup, self.mindex,
                     self.msize)

    @staticmethod
    def of(model: Model, rules: Optional[ShardingRules]
           ) -> Optional["DataParallel"]:
        """None without rules or on a mesh whose data and model axes are
        1 (the single-device step); raises for what the port does not
        split (``check_rules``)."""
        if rules is None:
            return None
        check_rules(rules, model)
        if rules.dp_size > 1 or model_size(rules) > 1:
            return DataParallel(model, rules)
        return None

    @property
    def world(self) -> int:
        """The ranks that run the step (data x model)."""
        return self.size * self.msize

    def token_split(self) -> Optional[TokenSplit]:
        """The split of the tokens over the data group (this rank holds
        rows ``index * n ...`` of every token axis); None on a data axis
        of 1."""
        if self.size <= 1:
            return None
        return TokenSplit(self.group, self.index, self.size)

    def model_split(self) -> Optional[ModelSplit]:
        """The split of the heads / mlp / experts axes over the model
        group; None on a model axis of 1."""
        if self.msize <= 1:
            return None
        return ModelSplit(self.mgroup, self.mindex, self.msize)

    # -- layout ------------------------------------------------------------

    @staticmethod
    def block(t: torch.Tensor, sh: Optional[Shard]) -> torch.Tensor:
        """This rank's block of a full tensor laid out as ``sh``."""
        if sh is None:
            return t
        return t.chunk(sh.size, sh.dim)[sh.index].clone()

    @staticmethod
    def gather_leaf(t: torch.Tensor, sh: Optional[Shard],
                    tag: str = "param") -> torch.Tensor:
        """The full tensor of the blocks laid out as ``sh``."""
        if sh is None:
            return t
        parts = comms.all_gather(t, sh.group, tag=tag)
        return torch.cat(list(parts.unbind(0)), sh.dim)

    def _block2(self, t, pair):
        return self.block(self.block(t, pair[0]), pair[1])

    def _gather2(self, t, pair, tag):
        return self.gather_leaf(self.gather_leaf(t, pair[1], tag), pair[0],
                                tag)

    def local(self, tree):
        """Blocks of a full params-shaped tree (params, mu, nu)."""
        return tree_map(lambda t, d, m: self._block2(t, (d, m)), tree,
                        self.shards, self.mshards)

    def full(self, tree, tag: str = "param"):
        return tree_map(lambda t, d, m: self._gather2(t, (d, m), tag), tree,
                        self.shards, self.mshards)

    def forward_params(self, params):
        """The tree the forward reads: the data blocks gathered (fsdp),
        the model blocks kept but those of the gathered (``vocab``)
        leaves."""
        if not (self.sharded or any(tree_leaves(self.gathered))):
            return params
        return tree_map(
            lambda t, d, m, g: self.gather_leaf(
                self.gather_leaf(t, d), m if g else None),
            params, self.shards, self.mshards, self.gathered)

    def local_grads(self, grads):
        """The gradients of ``forward_params``'s tree as the rank's model
        blocks (a gathered leaf's gradient, the same on every model rank,
        sliced back)."""
        if not any(tree_leaves(self.gathered)):
            return grads
        return tree_map(lambda g, m, gat: self.block(g, m) if gat else g,
                        grads, self.mshards, self.gathered)

    def local_opt_state(self, opt_state):
        if not (self.sharded or self.msharded):
            return opt_state
        if isinstance(opt_state, AdafactorState):
            return AdafactorState(
                opt_state.count,
                tree_map(self._block2, opt_state.vr, self.vr_shards),
                tree_map(self._block2, opt_state.vc, self.vc_shards))
        return AdamWState(opt_state.count, self.local(opt_state.mu),
                          self.local(opt_state.nu))

    def full_opt_state(self, opt_state):
        if not (self.sharded or self.msharded):
            return opt_state
        if isinstance(opt_state, AdafactorState):
            return AdafactorState(
                opt_state.count,
                tree_map(lambda t, p: self._gather2(t, p, "opt"),
                         opt_state.vr, self.vr_shards),
                tree_map(lambda t, p: self._gather2(t, p, "opt"),
                         opt_state.vc, self.vc_shards))
        return AdamWState(opt_state.count, self.full(opt_state.mu, "opt"),
                          self.full(opt_state.nu, "opt"))

    def rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch (every model rank of a data
        shard holds the same rows)."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.size:
                raise ValueError(
                    f"batch dim {v.shape[0]} not divisible by the "
                    f"data-parallel degree {self.size}")
            n = v.shape[0] // self.size
            out[k] = v[self.index * n:(self.index + 1) * n]
        return out

    # -- reductions ----------------------------------------------------------

    def _reduce_leaf(self, g: torch.Tensor, sh: Optional[Shard]
                     ) -> torch.Tensor:
        if sh is None:
            return comms.all_reduce(g, "sum", self.group, tag="grad")
        moved = g.movedim(sh.dim, 0)
        out = comms.reduce_scatter(moved, sh.group, tag="grad")
        if sh.rest is not None:     # the replicas of the block: summed
            out = comms.all_reduce(out, "sum", sh.rest, tag="grad")
        return out.movedim(0, sh.dim)

    def reduce_grads(self, grads, weight: torch.Tensor):
        """The weighted sum over the data group of ``weight * grads``:
        all-reduced replicated leaves, reduce-scattered blocks of the
        sharded ones (the model blocks as they are: each model rank
        reduces its own)."""
        return tree_map(lambda g, sh: self._reduce_leaf(g * weight, sh),
                        grads, self.shards)

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient: a block's squared sum is
        all-reduced over each group its leaf is split over (one
        all-reduce a kind of split), a whole leaf's counted once."""
        buckets: Dict[Any, list] = {}
        for g, d, m in zip(tree_leaves(grads), tree_leaves(self.shards),
                           tree_leaves(self.mshards)):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            key = (None if d is None else d.axes, m is not None)
            buckets.setdefault(key, (d, m, []))[2].append(sq)
        dev = tree_leaves(grads)[0].device
        total = torch.zeros((), device=dev)
        for d, m, sqs in buckets.values():
            part = sum(sqs).reshape(1)
            if d is not None:
                part = comms.all_reduce(part, "sum", d.group, tag="norm")
            if m is not None:
                part = comms.all_reduce(part, "sum", m.group, tag="norm")
            total = total + part[0]
        return torch.sqrt(total)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       weight: Optional[torch.Tensor] = None,
                       split: bool = False) -> Dict[str, torch.Tensor]:
        """Metrics over the data group in one all-reduce (the model ranks
        of a data shard hold the same ones): counts (integer metrics and
        ``tokens``) summed, the rest averaged (by ``weight`` when given:
        each rank's share of the targets).  Under a token ``split`` the
        telemetry stats (``tel/...``) are already the group's, equal on
        every rank: kept as they are.  On a data axis of 1, as they are."""
        if self.size <= 1:
            return dict(metrics)
        tel = {n: v for n, v in metrics.items()
               if split and n.startswith("tel/")}
        rest = {n: v for n, v in metrics.items() if n not in tel}
        return {**self._reduce_metrics(rest, weight), **tel}

    def _reduce_metrics(self, metrics, weight):
        names = list(metrics)
        count = [n == "tokens" or not metrics[n].is_floating_point()
                 for n in names]
        dev = metrics[names[0]].device
        vals = torch.stack([
            metrics[n].detach().to(dev, torch.float64).reshape(())
            * (1.0 if c else (weight.to(torch.float64) if weight is not None
                              else 1.0 / self.size))
            for n, c in zip(names, count)])
        comms.all_reduce(vals, "sum", self.group, tag="metric")
        return {n: vals[i].to(metrics[n].dtype)
                for i, n in enumerate(names)}

    def token_weight(self, metrics) -> torch.Tensor:
        """This rank's share of the global batch's targets (f32)."""
        n = metrics["tokens"].detach().to(torch.float32).reshape(1)
        if self.size <= 1:
            return torch.ones((), dtype=torch.float32, device=n.device)
        total = comms.all_reduce(n.clone(), "sum", self.group, tag="metric")
        return (n / total)[0]


def make_train_step(model: Model, tcfg: TrainConfig, plan, *,
                    rules: Optional[ShardingRules] = None):
    """Returns ``train_step(params, opt_state, comp_state, batch, step,
    lr_scale=1.0) -> (params, opt_state, comp_state, metrics)``; the
    scheduled LR times ``lr_scale`` (the controller's backoff), both f32.
    ``batch`` holds the global batch's int32 tensors on the model's
    device; ``params`` (f32 masters) and ``opt_state`` are updated in
    place and returned.  ``comp_state`` is the error-feedback residual
    tree under ``grad_compression="fp8"`` (anything, returned as is,
    otherwise).  Metrics: ``loss``, ``tokens``, ``total_loss`` (and
    ``z_loss`` when set), ``grad_norm``, ``lr``, as 0-dim tensors; with
    ``tcfg.telemetry`` also the ``tel/...`` stats.  ``rules``: see the
    module docstring."""
    matmul_impl(model.cfg.linear_impl)   # a typo'd impl fails here
    plan = as_plan(plan, model.cfg.n_layers)
    opt = make_optimizer(model, tcfg)
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.total_steps,
                          tcfg.warmup_frac, tcfg.min_lr_frac)
    k = tcfg.microbatch
    use_compression = tcfg.grad_compression == "fp8"
    if use_compression and model_size(rules) > 1:
        raise NotImplementedError(
            "fp8 gradient compression on a model axis > 1: the port "
            "compresses over the data axes of a data-parallel mesh")
    dp = DataParallel.of(model, rules)
    spmd = dp is not None and use_compression
    if spmd and dp.sharded:
        bad = [sh.spec for sh in tree_leaves(rules.param_shardings(
            model.param_specs())) if sh.uses(rules.dp_axes)]
        raise ValueError(
            "fp8 grad compression's manual-DP reduction needs params "
            "replicated over the data axes (each shard applies the "
            f"same compressed update), but these specs use them: "
            f"{bad[:3]}...  Build rules with default_rules(..., "
            "fsdp=False).")
    # one collector for the step's life; None keeps the plain step
    collector = telemetry.TelemetryCollector() if tcfg.telemetry else None
    ctx = (rules.manual_over(rules.dp_axes) if rules is not None
           else None)
    # the mean-gradient step quantizes the global batch's groups
    split = dp.token_split() if dp is not None and not spmd else None
    msplit = dp.model_split() if dp is not None else None
    if opt.name == "adafactor" and dp is not None and (dp.sharded
                                                       or dp.msharded):
        opt_kw = {"shards": dp.opt_shards}
    else:
        opt_kw = {}

    def compute_grads(params, batch, rows=None):
        """Gradients and metrics of ``batch``; ``rows`` takes this rank's
        rows of it, of each microbatch in turn (the microbatches split
        the global batch)."""
        rows = rows or (lambda mb: mb)
        if not (k and k > 1):
            _, metrics, grads, pg = _grads(model, plan, params, rows(batch),
                                           collector)
        else:
            b = batch["tokens"].shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into {k} "
                                 "microbatches")
            g_acc, pg, loss_sum, per_mb = None, None, None, []
            for i in range(k):
                mb = rows({n: t[i * (b // k):(i + 1) * (b // k)]
                           for n, t in batch.items()})
                loss, metrics, g, pg_i = _grads(model, plan, params, mb,
                                                collector)
                g_acc = g if g_acc is None else tree_map(torch.add, g_acc,
                                                         g)
                # probe rows are sums with a tap-count slot: adding them
                # keeps them self-normalizing
                if pg_i is not None:
                    pg = pg_i if pg is None else {
                        c: pg[c] + pg_i[c] for c in pg}
                loss_sum = loss if loss_sum is None else loss_sum + loss
                per_mb.append(metrics)
            grads = tree_map(lambda x: x / k, g_acc)
            metrics = {n: torch.stack([m[n].to(torch.float32)
                                       for m in per_mb]).mean()
                       for n in per_mb[0]}
            metrics["loss"] = loss_sum / k
        if pg is not None:
            metrics.update(telemetry.probe_metrics(pg))
        return grads, metrics

    def reduce_spmd(params, comp_state, batch):
        """Compress before communicating (a data axis > 1 under fp8)."""
        grads, metrics = compute_grads(params, dp.rows(batch))
        with phase_span("collective"):
            grads, res = compressed_psum_grads(
                grads, tree_map(lambda r: r[0], comp_state), dp.group)
            comp_state = tree_map(lambda r: r[None], res)
            metrics = dp.reduce_metrics(metrics)
        if collector is not None:
            metrics.update(telemetry.grad_norm_metrics(grads))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        return grads, comp_state, metrics, gnorm

    def reduce_mean(params, batch):
        """The mean gradient of the global batch (blocks of the fsdp
        leaves and of the model-split ones), clipped by the whole
        gradient's norm; the per-layer gradient norms (telemetry) of the
        reduced gradient."""
        full = dp.forward_params(params)
        grads, metrics = compute_grads(full, batch, dp.rows)
        del full
        split_any = dp.sharded or dp.msharded
        with phase_span("collective"):
            grads = dp.local_grads(grads)
            if dp.size > 1:
                weight = dp.token_weight(metrics)
                grads = dp.reduce_grads(grads, weight)
                metrics = dp.reduce_metrics(metrics, weight, split=True)
            norm = dp.global_norm(grads) if split_any else None
            if collector is not None:
                whole = dp.full(grads, "telemetry") if split_any else grads
                metrics.update(telemetry.grad_norm_metrics(whole))
                del whole
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm=norm)
        return grads, metrics, gnorm

    def train_step(params, opt_state, comp_state,
                   batch: Dict[str, torch.Tensor], step,
                   lr_scale: float = 1.0):
        with layers.sharding_context(ctx, split, msplit):
            if dp is None:
                grads, metrics = compute_grads(params, batch)
                if collector is not None:
                    metrics.update(telemetry.grad_norm_metrics(grads))
                grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
                if use_compression:
                    with phase_span("collective"):
                        grads, comp_state = fp8_compress_grads(grads,
                                                               comp_state)
            elif spmd:
                grads, comp_state, metrics, gnorm = reduce_spmd(
                    params, comp_state, batch)
            else:
                grads, metrics, gnorm = reduce_mean(params, batch)
        # the scale enters in f32, as the reference's traced scalar: a
        # backed-off LR equals the reference's bit for bit
        lr = lr_fn(step) * torch.tensor(lr_scale, dtype=torch.float32)
        with phase_span("optim"):
            params, opt_state = opt.update(grads, opt_state, params, lr,
                                           **opt_kw)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, comp_state, metrics

    return train_step


def make_eval_step(model: Model, plan, *,
                   rules: Optional[ShardingRules] = None):
    """``eval_step(params, batch) -> metrics`` of the global batch; on a
    data axis > 1 each rank evaluates its rows (the fsdp blocks
    gathered) and the metrics are reduced as the step's."""
    plan = as_plan(plan, model.cfg.n_layers)
    dp = DataParallel.of(model, rules)
    ctx = rules.manual_over(rules.dp_axes) if rules is not None else None
    split = dp.token_split() if dp is not None else None
    msplit = dp.model_split() if dp is not None else None

    @torch.no_grad()
    def eval_step(params, batch):
        with layers.sharding_context(ctx, split, msplit):
            if dp is None:
                return model.loss(params, batch, plan)[1]
            metrics = model.loss(dp.forward_params(params), dp.rows(batch),
                                 plan)[1]
            return dp.reduce_metrics(metrics, dp.token_weight(metrics))

    return eval_step
