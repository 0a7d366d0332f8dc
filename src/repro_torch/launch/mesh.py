"""Mesh construction: the production (data, model) mesh of model
parallelism and the serving mesh.

`make_production_mesh` builds the reference's production layout as a
``torch.distributed`` `DeviceMesh`: (16, 16) over ("data", "model"), or
(2, 16, 16) over ("pod", "data", "model") for two pods (512 ranks). It
needs an initialised process group of that world size (the dry run
starts a fake one, launch/dryrun.py) and never starts one itself.

The sharded serving runtime (serving/sharded.py) takes two kinds of
mesh. `ServingMesh`, the port's stand-in for `jax.sharding.Mesh`
(devices laid out over named axes), is pure data parallelism: each
replica holds both model halves and serves a contiguous shard of every
micro-batch, so its mesh has one axis, "data". A ``torch.distributed``
`DeviceMesh` over ("data", "model") (`make_model_serving_mesh`) adds
Megatron tensor parallelism: every rank of the process group runs the
same serving loop on its shards. Functions build both, so importing this
module touches no device.
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


def make_model_serving_mesh(data: int = 1, model: int = 1, *, device=None):
    """("data", "model") `DeviceMesh` of ``data`` x ``model`` serving
    ranks on ``device`` (default cuda; "cpu" for gloo or threaded ranks).

    The default process group must be initialised with a world size of
    ``data * model`` (`make_mesh`). On ``cuda`` rank r serves on card r,
    made its current device; asking for more cards than are visible
    raises, as `make_serving_mesh` does. Nothing falls back to fewer ranks
    or to another device."""
    import torch.distributed as dist
    if data < 1 or model < 1:
        raise ValueError(f"data={data} and model={model} must be >= 1")
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        if data * model > visible:
            raise ValueError(
                f"a ({data}, {model}) mesh needs {data * model} cards but "
                f"only {visible} local device(s) visible; on the CPU pass "
                f"device='cpu'")
        if dist.is_initialized():
            torch.cuda.set_device(dist.get_rank())
    return make_mesh((data, model), ("data", "model"), device=dev.type)


def serving_axis_map(mesh) -> Dict[str, object]:
    """Logical axes of the serving forward on ``mesh``: rows over "data",
    the Megatron split over "model" where the mesh has that axis."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return {"batch": ("data",),
            "model": "model" if "model" in names else None, "seq": None}


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device=None):
    """A `DeviceMesh` of ``shape`` over ``axis_names`` on ``device``
    (default cuda; "cpu" for gloo or fake ranks): the counterpart of
    ``jax.make_mesh``. The default process group must be initialised with
    a world size of ``prod(shape)``; this function starts none."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(torch.distributed.init_process_group) of world size "
            f"{int(np.prod(shape))}; none is")
    world = dist.get_world_size()
    if world != int(np.prod(shape)):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs a world of "
                         f"{int(np.prod(shape))} ranks, the process group "
                         f"has {world}")
    dev = torch.device("cuda" if device is None else device)
    return DeviceMesh(dev.type, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, dp: int = 16,
                         tp: int = 16, device=None):
    """Standard mesh: (dp, tp) = (16, 16) per pod over ("data", "model"),
    (2, dp, tp) over ("pod", "data", "model") with ``multi_pod``. ``dp``
    and ``tp`` re-split the same 256 ranks (their product must be 256)."""
    if dp * tp != 256:          # the reference's assertion, kept under -O
        raise AssertionError((dp, tp))
    shape = (2, dp, tp) if multi_pod else (dp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


AXIS_MAP_SINGLE = {"batch": ("data",), "model": "model", "seq": None}
AXIS_MAP_MULTI = {"batch": ("pod", "data"), "model": "model", "seq": None}


def axis_map(multi_pod: bool):
    return AXIS_MAP_MULTI if multi_pod else AXIS_MAP_SINGLE
