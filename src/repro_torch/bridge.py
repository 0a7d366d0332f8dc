"""Parameters across the framework boundary.

`params_from_jax` turns the reference package's parameter pytree, with
numpy leaves (``jax.tree.map(np.asarray, params)``), into the port's
`ParamTree` with the same paths, so both sides compute the same function
in the tests. Parity rests on shared parameters, never on matching
``jax.random``. This module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import ParamTree


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array -> torch tensor, bfloat16 (ml_dtypes) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _convert(tree: Mapping[str, Any], device):
    return {k: _convert(v, device) if isinstance(v, Mapping)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def params_from_jax(tree: Mapping[str, Any], *, device=None) -> ParamTree:
    """The reference's param pytree (numpy leaves) as a `ParamTree` on
    ``device`` (default ``cuda``)."""
    return ParamTree(_convert(tree, resolve_device(device)))
