"""Distribution: meshes, logical -> physical sharding, elasticity and the
recorded collectives (counterpart of ``repro.distributed``)."""
from repro_torch.distributed.mesh import AbstractMesh, make_mesh
from repro_torch.distributed.sharding import (ShardingRules, default_rules,
                                              opt_state_shardings)

__all__ = ["ShardingRules", "default_rules", "opt_state_shardings",
           "make_mesh", "AbstractMesh"]
