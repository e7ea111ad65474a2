"""Logical -> physical sharding rules (counterpart of
``repro.distributed.sharding``; divisibility-, granule- and
conflict-aware, letter for letter the reference's).

Every ``ParamSpec`` carries logical axis names; activations use
``nn.layers.shard_hint`` with logical names.  ``ShardingRules`` maps
those names onto mesh axes:

  * divisibility-aware: an assignment is dropped (replicated) when the
    dim does not divide by the mesh-axis size;
  * granule-aware: flattened head dims shard only when the *head count*
    divides the axis (``granules``), so heads never split;
  * conflict-free: a mesh axis is used at most once per spec (first dim
    wins; later dims replicate).

A :class:`Sharding` carries the spec as a tuple (an entry per tensor
dim: None, an axis name, or a tuple of names; ``tuple(PartitionSpec)``
of the reference's) and, on a live ``DeviceMesh``, the DTensor
placements (``Shard(d)`` / ``Replicate()`` per mesh dim).  The rules
work on a device-free ``mesh.AbstractMesh`` too.

Default mapping (the reference's): params embed -> the data axes
(fsdp), heads / kv_heads / mlp / vocab / experts / mamba_* -> model;
activations batch / tokens -> (pod, data), the model-parallel names ->
model, seq -> None (model under ``seq_parallel``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.distributed.mesh import AbstractMesh, mesh_axis_sizes
from repro_torch.nn.params import ParamSpec, map_specs
from repro_torch.tree import tree_map

__all__ = ["Sharding", "ShardingRules", "default_rules",
           "opt_state_shardings"]

AxisAssignment = Optional[Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: ``spec`` has one entry per tensor
    dim (None | axis name | tuple of axis names)."""

    mesh: Any
    spec: Tuple[Any, ...]

    def dim_axes(self) -> Dict[int, Tuple[str, ...]]:
        """{tensor dim: the mesh axes it shards over}."""
        out = {}
        for d, e in enumerate(self.spec):
            if e is not None:
                out[d] = (e,) if isinstance(e, str) else tuple(e)
        return out

    def uses(self, axes: Sequence[str]) -> bool:
        return any(a in axes for t in self.dim_axes().values() for a in t)

    @property
    def placements(self) -> tuple:
        """The DTensor placements over a live ``DeviceMesh``."""
        from torch.distributed.tensor import Replicate, Shard
        if isinstance(self.mesh, AbstractMesh):
            raise TypeError("an AbstractMesh has no DTensor placements")
        by_axis = {a: d for d, t in self.dim_axes().items() for a in t}
        return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                     for a in self.mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    param_rules: Dict[str, AxisAssignment]
    act_rules: Dict[str, AxisAssignment]
    granules: Dict[str, int]

    # -- core assignment ---------------------------------------------------

    def axis_size(self, names: Sequence[str]) -> int:
        sizes = mesh_axis_sizes(self.mesh)
        return math.prod(sizes[n] for n in names)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(mesh_axis_sizes(self.mesh))

    def _assign(self, rules: Dict[str, AxisAssignment],
                logical: Optional[str], dim: int,
                used: set) -> AxisAssignment:
        if logical is None:
            return None
        want = rules.get(logical)
        if want is None:
            return None
        want = (want,) if isinstance(want, str) else tuple(want)
        granule = self.granules.get(logical, dim)
        # the full tuple, then its prefixes (('pod', 'data') -> ('pod',))
        for k in range(len(want), 0, -1):
            cand = want[:k]
            if any(a in used for a in cand):
                continue
            size = self.axis_size(cand)
            if dim % size == 0 and granule % size == 0:
                used.update(cand)
                return cand
        return None

    def _spec(self, rules, logicals: Sequence[Optional[str]],
              shape: Sequence[int]) -> Tuple[Any, ...]:
        used: set = set()
        parts = [self._assign(rules, lg, d, used)
                 for lg, d in zip(logicals, shape)]
        return tuple(p if p is None else (p[0] if len(p) == 1 else p)
                     for p in parts)

    # -- public ------------------------------------------------------------

    def param_sharding(self, spec: ParamSpec) -> Sharding:
        return Sharding(self.mesh,
                        self._spec(self.param_rules, spec.axes, spec.shape))

    def param_shardings(self, spec_tree) -> Any:
        return map_specs(self.param_sharding, spec_tree)

    def activation_sharding(self, axes: Sequence[Optional[str]],
                            shape: Sequence[int]) -> Sharding:
        return Sharding(self.mesh, self._spec(self.act_rules, axes, shape))

    def batch_sharding(self, ndim: int) -> Sharding:
        """Input-batch sharding: dim 0 over the data axes."""
        return Sharding(self.mesh, self._spec(
            self.act_rules, ["batch"] + [None] * (ndim - 1), [0] * ndim))

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, ())

    # -- data-parallel structure -------------------------------------------

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Mesh axes the batch shards over (the gradient-reduction
        group)."""
        want = self.act_rules.get("batch") or ()
        want = (want,) if isinstance(want, str) else tuple(want)
        return tuple(a for a in want if a in self.axis_names)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp_axes) if self.dp_axes else 1

    def manual_over(self, axes: Sequence[str]) -> "ShardingRules":
        """Rules for code whose placement over ``axes`` is handled
        elsewhere (a rank's own slice of the batch): every assignment to
        those mesh axes is stripped, the others kept."""
        drop = set(axes)

        def strip(rules: Dict[str, AxisAssignment]) -> Dict[str, Any]:
            out: Dict[str, Any] = {}
            for k, v in rules.items():
                if v is None:
                    out[k] = None
                    continue
                t = (v,) if isinstance(v, str) else tuple(v)
                t = tuple(a for a in t if a not in drop)
                out[k] = t or None
            return out

        return dataclasses.replace(self, param_rules=strip(self.param_rules),
                                   act_rules=strip(self.act_rules))

    # -- caches -------------------------------------------------------------

    def cache_shardings(self, cache_tree) -> Any:
        """Shardings for a serving cache tree (dicts and lists of
        anything with a ``.shape``), dispatched on the leaf's key as the
        reference's; a leaf under a ``groups`` key (the reference's
        scan-stacked layout) has a leading ``layers`` dim."""

        def by_path(keys, leaf):
            name = keys[-1] if keys else ""
            ndim = len(leaf.shape)
            lead = ["layers"] if "groups" in keys else []
            if name in ("k", "v"):       # (B, S, KVH, HD)
                ax = lead + ["batch", None, "kv_heads", None]
            elif name == "pos":
                ax = lead + [None]
            elif name == "conv":         # (B, K-1, conv_dim)
                ax = lead + ["batch", None, "mamba_inner"]
            elif name == "state":        # (B, H, P, N)
                ax = lead + ["batch", "mamba_heads", None, None]
            elif name == "length":
                ax = [None] * ndim
            else:
                ax = lead + ["batch"] + [None] * (ndim - len(lead) - 1)
            ax = (ax + [None] * ndim)[:ndim]
            return self.activation_sharding(ax, leaf.shape)

        def walk(tree, keys):
            if isinstance(tree, dict):
                return {k: walk(v, keys + [str(k)]) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                # a list index has no key, as a JAX SequenceKey
                return [walk(v, keys + [""]) for v in tree]
            return by_path(keys, tree)

        return walk(cache_tree, [])


def _dp_axes(names: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in names)


def default_rules(mesh, cfg=None, *, fsdp: bool = True,
                  seq_parallel: bool = False,
                  free_head_shard: bool = False,
                  overrides: Optional[Dict[str, AxisAssignment]] = None,
                  act_overrides: Optional[Dict[str, AxisAssignment]] = None
                  ) -> ShardingRules:
    """The default FSDP + TP (+ EP) layout for a model config (every
    keyword the reference's)."""
    names = tuple(mesh_axis_sizes(mesh))
    dp = _dp_axes(names)
    tp = ("model",) if "model" in names else ()
    param_rules: Dict[str, AxisAssignment] = {
        "embed": dp if fsdp else None,
        "mlp": tp or None,
        "heads": tp or None,
        "kv_heads": tp or None,
        "vocab": tp or None,
        "experts": tp or None,
        "mamba_inner": tp or None,
        "mamba_groups": tp or None,
        "mamba_heads": tp or None,
        "layers": None,
    }
    act_rules: Dict[str, AxisAssignment] = {
        "batch": dp or None,
        # flattened (batch * seq) matmul rows and the per-granularity
        # quantization-scale tensors riding them
        "tokens": dp or None,
        "seq": tp if seq_parallel else None,
        "seq_q": None,
        "embed": None,
        "mlp": tp or None,
        "heads": tp or None,
        "kv_heads": tp or None,
        "vocab": tp or None,
        "experts": tp or None,
        "mamba_heads": tp or None,
        "mamba_inner": tp or None,
        "mamba_groups": tp or None,
    }
    granules: Dict[str, int] = {}
    if cfg is not None:
        if not free_head_shard:
            granules["heads"] = max(cfg.n_heads, 1)
            granules["kv_heads"] = max(cfg.n_kv_heads, 1)
        if cfg.moe is not None:
            granules["experts"] = cfg.moe.num_experts
        if cfg.mamba is not None:
            d_inner = cfg.mamba.expand * cfg.d_model
            granules["mamba_heads"] = d_inner // cfg.mamba.headdim
            granules["mamba_inner"] = d_inner // cfg.mamba.headdim
            granules["mamba_groups"] = cfg.mamba.n_groups
    param_rules.update(overrides or {})
    act_rules.update(act_overrides or {})
    return ShardingRules(mesh=mesh, param_rules=param_rules,
                         act_rules=act_rules, granules=granules)


def opt_state_shardings(opt_state, params_like, param_shardings, mesh):
    """Shardings of an ``AdamWState`` / ``AdafactorState`` from the
    params': mu / nu mirror the params, adafactor's row / column factors
    drop the matching trailing spec entries, the count replicates."""
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState

    rep = Sharding(mesh, ())
    if isinstance(opt_state, AdamWState):
        return AdamWState(count=rep, mu=param_shardings, nu=param_shardings)
    if isinstance(opt_state, AdafactorState):
        def padded(sh: Sharding, nd: int):
            return (tuple(sh.spec) + (None,) * nd)[:nd]

        def vr_sh(sh, p):
            nd = len(p.shape)
            spec = padded(sh, nd)
            return Sharding(mesh, spec[:-1] if nd >= 2 else spec)

        def vc_sh(sh, p):
            nd = len(p.shape)
            if nd < 2:
                return rep
            spec = padded(sh, nd)
            return Sharding(mesh, spec[:-2] + (spec[-1],))

        return AdafactorState(count=rep,
                              vr=tree_map(vr_sh, param_shardings,
                                          params_like),
                              vc=tree_map(vc_sh, param_shardings,
                                          params_like))
    raise TypeError(type(opt_state))
