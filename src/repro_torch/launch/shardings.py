"""Parameter placements over a serving mesh.

Every spec is *sanitized* against divisibility: a dimension that does
not divide evenly over its assigned mesh axes falls back to replication.
The sharded serving runtime (serving/sharded.py) places its launches'
rows with ``sanitize_spec`` (bucket caps are pow2-padded then rounded up
to a multiple of the replica count, so the row axis divides the "data"
axis) and its parameters with ``param_shardings``, which replicates
every leaf on the 1-D serving mesh. `batch_shardings` and
`cache_shardings` belong to model parallelism and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.launch.mesh import ServingMesh
from repro_torch.sharding.rules import Spec, map_with_path, param_specs


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: ServingMesh
    spec: Spec

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)


def _axes_size(mesh: ServingMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def sanitize_spec(mesh: ServingMesh, spec: Spec, shape) -> Spec:
    """``spec`` for an array of ``shape``: one entry per dimension, None
    where the dimension does not divide over its axes."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axes is not None and dim % _axes_size(mesh, axes) == 0:
            out.append(axes)
        else:
            out.append(None)
    return tuple(out)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def sharding_tree(mesh: ServingMesh, spec_tree, shape_tree):
    """`NamedSharding` tree with divisibility sanitation: a spec tree over
    a tree of arrays with the same keys."""
    return map_with_path(
        lambda path, x: NamedSharding(
            mesh, sanitize_spec(mesh, _leaf(spec_tree, path), x.shape)),
        shape_tree)


def param_shardings(mesh: ServingMesh, abstract: Any, *,
                    axis_map: Dict[str, Any] | None = None,
                    fsdp_paths: str | None = None):
    return sharding_tree(mesh, param_specs(abstract, axis_map, fsdp_paths),
                         abstract)
