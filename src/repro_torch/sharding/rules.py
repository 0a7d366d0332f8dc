"""Logical-axis sharding rules.

Model code annotates activations with *logical* axes via
``constrain(x, "batch", None, "model")``; the launch layer binds a mesh
(a ``torch.distributed`` `DeviceMesh`) and an axis map (`mesh_rules`)
that translates logical names to mesh axes. Outside any binding, or on a
tensor that is not a ``DTensor``, ``constrain`` is the identity, so the
single-device paths run exactly as before. Bound, it redistributes a
``DTensor`` to the placements its spec gives: the counterpart of the
reference's ``with_sharding_constraint``.

Parameter sharding is assigned by leaf path (``param_specs``): the
Megatron mapping — column-parallel in-projections, row-parallel
out-projections, vocab-sharded embedding/exit-head, expert FFN inner dim
sharded over "model". A spec is a plain tuple with one entry per
dimension of the leaf: a mesh axis name (or a tuple of them) or None
for a dimension that is not split; it equals ``tuple(P)`` of the
reference's ``PartitionSpec``.

Consumers: the dry run (launch/dryrun.py) and the model-parallel train
step bind the (data, model) production mesh; the sharded serving
runtime (serving/sharded.py) reads ``param_specs`` for parameter
placement, every leaf replicated on its 1-D "data" mesh and
Megatron-split on a ("data", "model") mesh, whose forward it runs under
`mesh_rules`.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

from repro_torch.shards import is_dtensor

Spec = Tuple[Any, ...]

_state = threading.local()


def _axis_map() -> Optional[dict]:
    return getattr(_state, "axis_map", None)


def current_mesh():
    """The mesh `mesh_rules` bound on this thread, else None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_rules(mesh, axis_map: dict):
    """Bind ``mesh`` and ``axis_map`` (logical name -> mesh axis, a str or
    a tuple, e.g. {"batch": ("pod", "data"), "model": "model"}) on this
    thread for the duration of the block. Inside it, a plain tensor that
    meets a ``DTensor`` in an op (positions, masks, zeros the model makes)
    joins it as replicated, as an unannotated array does under GSPMD."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = (current_mesh(), _axis_map())
    _state.mesh, _state.axis_map = mesh, axis_map
    try:
        with implicit_replication():
            yield
    finally:
        _state.mesh, _state.axis_map = prev


def logical_to_spec(*logical) -> Spec:
    amap = _axis_map() or {}
    return tuple(amap.get(a) if a is not None else None for a in logical)


def logical_size(name: str) -> int:
    """How many ways the bound mesh splits the logical axis ``name`` (1
    when no mesh is bound or the name maps to no mesh axis)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes((_axis_map() or {}).get(name)))


# a `DeviceMesh`'s axis sizes, kept per mesh: its ``shape`` walks its
# layout on every read, and the serving forward asks for it at every
# `constrain`
_SIZES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a `DeviceMesh` or a `ServingMesh`."""
    if not hasattr(mesh, "mesh_dim_names"):          # a ServingMesh
        return mesh.shape
    sizes = _SIZES.get(mesh)
    if sizes is None:
        sizes = _SIZES[mesh] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """``spec`` for an array of ``shape``: one entry per dimension, None
    where the dimension does not divide evenly over its axes (even
    shards keep memory accounting honest)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        n = math.prod(sizes[a] for a in _axes(axes))
        out.append(axes if axes is not None and dim % n == 0 else None)
    return tuple(out)


def spec_placements(mesh, spec: Spec):
    """The ``DTensor`` placements of a (sanitized) spec on a `DeviceMesh`:
    per mesh axis, ``Shard(d)`` for the tensor dimension whose entry names
    that axis, else ``Replicate()``. A dimension split over several axes
    (("pod", "data")) is split major to minor in mesh-axis order, as the
    reference's mesh splits it. An axis of size 1 splits nothing and is
    ``Replicate()`` (the same layout, which ``DTensor``'s reshapes also
    take where the dimension has size 1)."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    sizes = mesh_axis_sizes(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                 else Replicate() for a in mesh.mesh_dim_names)


def constrain(x, *logical, pin: bool = False):
    """Redistribute ``x`` to its logical spec on the bound mesh (the
    identity when no mesh is bound or ``x`` is not a ``DTensor``).

    ``pin``: redistribute even when ``x`` is placed so already, which
    puts a node in the graph whose backward brings ``x``'s gradient back
    to the same placements (else the gradient keeps whatever placement
    the ops after ``x`` gave it)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = sanitize_spec(mesh, logical_to_spec(*logical), x.shape)
    placements = spec_placements(mesh, spec)
    if tuple(x.placements) == placements and not pin:
        return x
    return x.redistribute(mesh, placements)


def gather_fsdp(w):
    """A ``DTensor`` weight gathered on every mesh axis but the ones
    "model" maps to (FSDP's gather at use, as the reference's weights
    are "gathered per layer at use"), so each product runs Megatron's
    column/row split only; the identity when no mesh is bound or ``w``
    is not a ``DTensor``."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    keep = set(_axes((_axis_map() or {}).get("model")))
    pl = tuple(p if name in keep else Replicate()
               for name, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


# (path regex, logical spec). Later entries win. Logical axes: "model"
# (tensor-parallel) and "fsdp" (weights additionally sharded over the data
# axis). Stacked layer params carry a leading layer axis -> specs are
# right-aligned.
_RULES = [
    (r"embed$", ("model", "fsdp")),                     # (V, D) vocab-sharded
    (r"(wq|wk|wv|wi|wg|w_in|cm_wk|wr)$", ("fsdp", "model")),
    (r"(wo|wv_out|cm_wv|w_out)$", ("model", "fsdp")),
    (r"exit_w$", ("fsdp", "model")),                    # (D, V)
    (r"router$", (None, None)),
    (r"moe/wi$|moe/wg$", (None, "fsdp", "model")),      # (E, D, F)
    (r"moe/wo$", (None, "model", "fsdp")),              # (E, F, D)
]


def _spec_for(path: str, ndim: int) -> Spec:
    matched = None
    for pat, spec in _RULES:
        if re.search(pat, path):
            matched = spec
    if matched is None:
        return ()
    spec = list(matched)
    # right-align: stacked layer axes (leading) stay unsharded
    if ndim < len(spec):
        spec = spec[-ndim:] if ndim else []
    pad = [None] * (ndim - len(spec))
    return (*pad, *spec)


def _path_str(path) -> str:
    """A leaf's path (its keys from the root) as "a/b/c"."""
    return "/".join(str(p) for p in path)


def _is_tree(x) -> bool:
    return hasattr(x, "items") and not hasattr(x, "shape")


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested mappings (dicts or
    `ParamTree`s, as nested dicts of the same keys) and tuples (as
    tuples; a tuple's index is its key in the path); a bare leaf is a
    tree of one."""
    if isinstance(tree, tuple):
        return tuple(map_with_path(fn, v, path + (i,))
                     for i, v in enumerate(tree))
    if not _is_tree(tree):
        return fn(path, tree)
    return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}


def param_specs(params, axis_map: Optional[dict] = None,
                fsdp_paths: Optional[str] = None) -> Dict[str, Any]:
    """Spec tree (nested dict of tuples) for a parameter tree.

    ``axis_map`` translates logical axes ("model"/"fsdp") to mesh axes;
    default keeps "model" and maps "fsdp" to "data".

    ``fsdp_paths``: optional regex — "fsdp" is kept only on leaves whose
    path matches; elsewhere it maps to None (replicated over data)."""
    amap = axis_map or {"model": "model", "fsdp": "data"}
    fsdp_re = re.compile(fsdp_paths) if fsdp_paths else None

    def translate(spec: Spec, path: str) -> Spec:
        out = []
        for a in spec:
            if a == "fsdp" and fsdp_re is not None \
                    and not fsdp_re.search(path):
                out.append(None)
                continue
            out.append(amap.get(a, a) if isinstance(a, str) else a)
        return tuple(out)

    return map_with_path(
        lambda path, leaf: translate(
            _spec_for(_path_str(path), len(leaf.shape)), _path_str(path)),
        params)


def named_shardings(mesh, params):
    """`NamedSharding` tree of ``params``'s default `param_specs` on
    ``mesh`` (not sanitized, as the reference's)."""
    from repro_torch.launch.shardings import NamedSharding
    specs = param_specs(params)

    def at(path):
        node = specs
        for key in path:
            node = node[key]
        return node
    return map_with_path(lambda path, _: NamedSharding(mesh, at(path)),
                         params)
