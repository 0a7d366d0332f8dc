"""Minimal parameter-tree checkpointing: npz payload + JSON tree manifest,
in the reference's on-disk format, so either package reads the other's
checkpoints.

``arrays.npz`` holds ``leaf_{i}`` for the i-th leaf in the reference's
leaf order: ``jax.tree.flatten`` sorts dict keys at every level, so the
leaves are walked in sorted-key order, not in ``named_parameters()``
order (which lists a module's own parameters before its children's).
``manifest.json`` holds ``num_leaves``, ``dtypes`` (numpy names) and
``paths`` ("/"-joined keys). bfloat16 leaves are stored as uint16 bit
patterns (numpy has no bf16) and restored from the manifest.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import ParamTree, _is_tree


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """[(path, leaf)] with dict keys sorted at every level, as
    ``jax.tree_util.tree_flatten_with_path`` lists a dict pytree."""
    out = []
    for key in sorted(tree.keys()):
        val = tree[key]
        if _is_tree(val):
            out.extend(_flatten(val, prefix + (key,)))
        else:
            out.append(("/".join(prefix + (key,)), val))
    return out


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (a `ParamTree` or a nested mapping of tensors) under
    the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    arrays, dtypes = {}, []
    for i, (_, leaf) in enumerate(flat):
        arr, dt = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dt)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"num_leaves": len(flat), "dtypes": dtypes,
                   "paths": [p for p, _ in flat]}, f)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _target(ref: torch.Tensor, device, i: int) -> torch.device:
    if device is not None:
        return device
    if ref.device.type == "meta":
        raise ValueError(
            f"checkpoint leaf {i}: its like-leaf is on the meta device; "
            f"pass device='cuda' or device='cpu'")
    return ref.device


def load_pytree(path: str, like, *, device=None):
    """Load into the structure of ``like`` (shape-checked), a `ParamTree`
    or a nested mapping of tensors; the result is of the same kind, its
    leaves without gradient and of the dtypes the checkpoint stores.

    Each leaf goes to the device of its ``like`` leaf, or to ``device``
    when given (`resolve_device`'s rules: cuda raises without a GPU). A
    ``like`` on the meta device (``Model.abstract_params()``) needs
    ``device``."""
    dev = None if device is None else resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like)
    if manifest["num_leaves"] != len(flat):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected "
            f"{len(flat)}")
    loaded: Dict[str, torch.Tensor] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (leaf_path, ref) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if manifest["dtypes"][i] == "bfloat16":
                arr = arr.view(np.uint16)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != "
                    f"{tuple(ref.shape)}")
            loaded[leaf_path] = _from_numpy(
                arr, manifest["dtypes"][i]).to(_target(ref, dev, i))
    out = _unflatten(like, loaded, ())
    return ParamTree(out) if isinstance(like, ParamTree) else out


def _unflatten(like, loaded: Dict[str, torch.Tensor],
               prefix: Tuple[str, ...]) -> Dict[str, Any]:
    """``like``'s nesting (in its own key order) over the loaded leaves."""
    return {key: _unflatten(val, loaded, prefix + (key,)) if _is_tree(val)
            else loaded["/".join(prefix + (key,))]
            for key, val in like.items()}
