"""Elastic scaling: re-map a checkpoint onto a different mesh
(counterpart of ``repro.distributed.elastic``).

Checkpoints store full (unsharded) arrays and the sharding rules are
pure functions of (mesh, config), so an elastic resume is::

    state = trainer.resume()          # full arrays, then each rank's block
    rules = default_rules(new_mesh, cfg)
    params = reshard(full_params, rules.param_shardings(model.param_specs()))

``reshard`` takes full host or device tensors, or DTensors, onto the
new placements.  Divisibility-aware rules guarantee a valid layout on any
mesh the job restarts on (worst case: replication).
"""
from __future__ import annotations

from typing import Any, Tuple

__all__ = ["reshard", "choose_mesh_shape"]


def _reshard_one(x, sharding):
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, sharding.placements)
        x = x.full_tensor()
    x = x.to(mesh.device_type)
    # every rank holds the same full tensor: each takes its own block,
    # no data moves between ranks
    return distribute_tensor(x, mesh, sharding.placements,
                             src_data_rank=None)


def reshard(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` as a DTensor on its ``Sharding`` (a tree of
    the same structure over a live ``DeviceMesh``)."""
    from repro_torch.tree import tree_map
    return tree_map(_reshard_one, tree, shardings)


def choose_mesh_shape(n_devices: int, *, prefer_model: int = 16
                      ) -> Tuple[int, int]:
    """A (data, model) shape for any surviving device count: the model
    axis stays ``prefer_model`` when it divides, else the largest power
    of two below it that does; deterministic, so every worker derives the
    same mesh without coordination."""
    model = prefer_model
    while model > 1 and n_devices % model:
        model //= 2
    return (n_devices // model, model)
