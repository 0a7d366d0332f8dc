"""Parameter sharding rules by leaf path.

``param_specs`` assigns each parameter leaf a spec from its path: the
Megatron mapping — column-parallel in-projections, row-parallel
out-projections, vocab-sharded embedding/exit-head, expert FFN inner dim
sharded over "model". A spec is a plain tuple with one entry per
dimension of the leaf: a mesh axis name (or a tuple of them) or None
for a dimension that is not split; it equals ``tuple(P)`` of the
reference's ``PartitionSpec``.

The sharded serving runtime (serving/sharded.py) reads ``param_specs``
for parameter placement on its 1-D "data" mesh, where every leaf
replicates: each replica holds both model halves. The activation
constraints of model parallelism (`mesh_rules`, `constrain`,
`logical_to_spec`) are not ported yet.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

Spec = Tuple[Any, ...]

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
    """``fn(path, leaf)`` over a nested mapping (a dict or `ParamTree`),
    as a nested dict of the same keys."""
    return {k: map_with_path(fn, v, path + (k,)) if _is_tree(v)
            else fn(path + (k,), v) for k, v in tree.items()}


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
