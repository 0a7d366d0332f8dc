"""Serving mesh construction.

The sharded serving runtime (serving/sharded.py) is pure data
parallelism: each replica holds both model halves and serves a
contiguous shard of every micro-batch, so its mesh has one axis,
"data". `ServingMesh` is the port's stand-in for `jax.sharding.Mesh`:
devices laid out over named axes. A function builds it, so importing
this module touches no device.

`make_production_mesh`, `batch_axes` and `axis_map` (the reference's
(data, model) mesh of the dry run and training) belong to model
parallelism and are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


class ServingMesh:
    """``devices`` (an array of `torch.device`, one axis per name) laid
    out over ``axis_names``; ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        self.devices = devs
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(
                f"a mesh of shape {devs.shape} needs {devs.ndim} axis "
                f"names, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_serving_mesh(replicas: int = 1, *, device=None) -> ServingMesh:
    """1-D ("data",) mesh of ``replicas`` replicas on ``device`` (default
    ``cuda``).

    On ``cuda`` the replicas are the first ``replicas`` visible cards, and
    asking for more than are visible raises. On ``cpu`` every replica is
    the host's CPU, so any count runs there: the stand-in for the
    reference's forced host devices
    (``--xla_force_host_platform_device_count``). Nothing falls back to
    fewer replicas or to another device.
    """
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = [torch.device("cpu")] * replicas
    else:
        visible = torch.cuda.device_count()
        if replicas > visible:
            raise ValueError(
                f"requested {replicas} replicas but only {visible} local "
                f"device(s) visible; on the CPU pass device='cpu', which "
                f"lists any number of replicas")
        devices = [torch.device("cuda", i) for i in range(replicas)]
    return ServingMesh(devices, ("data",))
