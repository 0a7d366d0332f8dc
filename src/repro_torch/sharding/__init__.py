"""Sharding rules of the port: parameter specs by leaf path and the
logical-axis activation constraints of model parallelism."""
from repro_torch.sharding.rules import (  # noqa: F401
    constrain, current_mesh, logical_to_spec, mesh_rules, named_shardings,
    param_specs)
