"""Sharding rules of the port: parameter specs by leaf path."""
from repro_torch.sharding.rules import param_specs  # noqa: F401
