"""Parameter, batch and cache placements over a mesh.

Every spec is *sanitized* against divisibility: a dimension that does
not divide evenly over its assigned mesh axes falls back to replication.

A `NamedSharding` is a spec bound to a mesh: a `ServingMesh` (the
sharded serving runtime) or a ``torch.distributed`` `DeviceMesh` (model
parallelism). `distribute_tree` places a tree of tensors by a tree of
them as ``DTensor``s on a `DeviceMesh`: the counterpart of
``jax.device_put`` with ``NamedSharding``s.

The sharded serving runtime (serving/sharded.py) places its launches'
rows with ``sanitize_spec`` (bucket caps are pow2-padded then rounded up
to a multiple of the replica count, so the row axis divides the "data"
axis) and its parameters with ``param_shardings``, which replicates
every leaf on the 1-D serving mesh. The dry run (launch/dryrun.py) and
the model-parallel train step place parameters, optimizer state,
batches and decode caches on the production mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.sharding.rules import (Spec, map_with_path, mesh_axis_sizes,
                                        param_specs, sanitize_spec,
                                        spec_placements)

__all__ = ["NamedSharding", "sanitize_spec", "sharding_tree",
           "param_shardings", "batch_shardings", "cache_shardings",
           "distribute_tree", "local_bytes"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def sharding_tree(mesh, spec_tree, shape_tree):
    """`NamedSharding` tree with divisibility sanitation: a spec tree over
    a tree of arrays with the same keys."""
    return map_with_path(
        lambda path, x: NamedSharding(
            mesh, sanitize_spec(mesh, _leaf(spec_tree, path), x.shape)),
        shape_tree)


def param_shardings(mesh, abstract: Any, *,
                    axis_map: Dict[str, Any] | None = None,
                    fsdp_paths: str | None = None):
    return sharding_tree(mesh, param_specs(abstract, axis_map, fsdp_paths),
                         abstract)


def _leaf_spec(leaf, batch_ax) -> Spec:
    """Input sharding by rank: the batch axis leads, the rest replicate
    ((B,) token ids, (B, S) tokens/labels, (B, S, D) embeds/frames)."""
    nd = len(leaf.shape)
    if nd == 0:
        return ()
    return (batch_ax,) + (None,) * (nd - 1)


def batch_shardings(mesh, batch_tree, multi_pod: bool):
    batch_ax = ("pod", "data") if multi_pod else ("data",)
    return map_with_path(
        lambda path, x: NamedSharding(
            mesh, sanitize_spec(mesh, _leaf_spec(x, batch_ax), x.shape)),
        batch_tree)


def cache_shardings(mesh, caches, multi_pod: bool):
    """Decode caches are stacked (L, B, ...): batch on axis 1; attention
    K/V shard the KV-head axis over "model" when it divides, else the
    WINDOW axis (sharding head_dim would split the attention contraction
    into a per-layer score reduction). The ring "pos" buffer follows the
    K/V window decision. The decision is one for the whole tree: the
    first 5-d k/v leaf's."""
    batch_ax = ("pod", "data") if multi_pod else ("data",)
    model = mesh_axis_sizes(mesh)["model"]

    heads_divide = True
    found = []

    def find(path, leaf):
        if not found and len(leaf.shape) == 5 and path[-1] in ("k", "v"):
            found.append(leaf.shape[3] % model == 0)
    map_with_path(find, caches)
    if found:
        heads_divide = found[0]

    def spec(name, leaf):
        nd = len(leaf.shape)
        if nd == 5 and ("k" in name or "v" in name):
            s = (None, batch_ax, None, "model", None) if heads_divide \
                else (None, batch_ax, "model", None, None)
            return sanitize_spec(mesh, s, leaf.shape)
        if nd == 3 and _path_str(name).endswith("pos") and not heads_divide:
            return sanitize_spec(mesh, (None, batch_ax, "model"), leaf.shape)
        if nd == 5:      # ssm (L, B, H, P, N) / mamba states
            return sanitize_spec(mesh, (None, batch_ax, "model", None, None),
                                 leaf.shape)
        if nd >= 2:
            return sanitize_spec(mesh, (None, batch_ax) + (None,) * (nd - 2),
                                 leaf.shape)
        return ()

    return map_with_path(lambda p, x: NamedSharding(mesh, spec(p, x)),
                         caches)


def distribute_tree(mesh, tree, shardings):
    """Each leaf of ``tree`` as a ``DTensor`` on the `DeviceMesh` ``mesh``,
    placed by the `NamedSharding` at its path in ``shardings`` (a single
    `NamedSharding` applies to every leaf). A leaf on the meta device, or
    a fake tensor, stays one: its local shard is made, not scattered."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(path, x):
        sh = shardings if isinstance(shardings, NamedSharding) \
            else _leaf(shardings, path)
        placements = spec_placements(mesh, sh.spec)
        if x.device.type == "meta" or _is_fake(x):
            local = x.new_empty(_local_shape(mesh, sh.spec, x.shape))
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return distribute_tensor(x, mesh, placements)

    return map_with_path(place, tree)


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _local_shape(mesh, spec, shape):
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            out[d] //= sizes[a]
    return tuple(out)


def local_bytes(tree) -> int:
    """The bytes of this rank's local shards over a tree of tensors
    (``DTensor``s count their local shard, plain tensors their whole,
    other leaves nothing)."""
    from torch.distributed.tensor import DTensor
    total = []

    def add(path, x):
        t = x.to_local() if isinstance(x, DTensor) else x
        if isinstance(t, torch.Tensor):
            total.append(t.numel() * t.element_size())
    map_with_path(add, tree)
    return int(sum(total))
