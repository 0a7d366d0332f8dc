"""Multi-pod dry run of the port: run every (architecture x input shape)
step on the production mesh over fake tensors (nothing is allocated) and
record what one device would hold, compute and exchange.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \
        --shape train_4k [--multipod] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-fit]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --refit [--arch A]

The counterpart of ``jax.jit(...).lower(...).compile()`` on 256 or 512
forced host devices is ``FakeTensorMode`` over a fake process group
(backend "fake", ``torch.testing._internal.distributed.fake_pg``): the
parameters, optimizer state, batch and caches are ``DTensor``s of fake
local shards placed on the (16, 16) ("data", "model") mesh, or (2, 16,
16) with ``--multipod``, by the reference's rules (`param_shardings`,
`batch_shardings`, `cache_shardings`; tensor-parallel weights at decode
but for the expert stacks, ``fsdp_paths=r"moe/"``), and the step the
shape names runs eagerly under `mesh_rules`: a train step with its
backward and remat, `prefill`, or `decode_step` at ``split_layer = L //
2``. As the reference's dry run builds its model with ``backend="ref"``,
every kernel here is its plain version (fake CPU tensors); no kernel is
launched.

Per combo it writes the reference's JSON keys, from this rank's view:

* ``memory.argument_bytes``: the bytes of this rank's local shards of
  every argument; ``memory.temp_bytes``: the peak of live storage during
  the step over the arguments (``torch.distributed._tools.mem_tracker``);
  ``memory.output_bytes``: the local bytes of the step's outputs (the
  train step updates its arguments in place and returns them);
* ``flops``: the per-device flops of every matmul-like op counted at its
  local shard's shapes (``torch.utils.flop_counter``'s formulas), so a
  replicated operand is counted on every rank that computes it;
* ``bytes_accessed``: the sum of each non-view op's operand and result
  bytes, local (metadata queries such as ``prim.device`` read none);
* ``collectives``: count and result bytes per kind of the functional
  collectives ``DTensor`` issues;
* ``params`` and ``active_params``.

The step runs at full depth and every op is counted, so these top-level
numbers are exact full-depth counts (the reference's XLA counts a scan
body once, and its HLO parsers ``parse_collective_bytes`` and
``parse_dot_flops`` have no counterpart here; a ``--no-fit`` record is
exact, not a lower bound).

``extrapolated`` is the reference's depth fit (`depth_fit`): the same
step run at L1 = k and L2 = 2k layers (k the hybrid shared-attention
period, else 1) and extrapolated linearly to the full depth: flops,
``bytes_accessed``, each collective's count and bytes, with the two
points under ``fit_points``. Flops, collectives and ``bytes_accessed``
are linear in depth (a train step reads each stacked (L, ...) leaf's
layers through one unbind, whose backward is one stack), so where the
full depth is a multiple of k the fit equals the walk in them.
zamba2-1.2b's 38 layers are not a multiple of its k = 6, and there the
fit and the walk differ (the record holds both). ``memory`` is never fitted: the peak is not
linear in depth, and only the full-depth walk proves the fit in memory.
``--no-fit`` skips the fit (no ``extrapolated`` key; the multi-pod
pass), and ``--refit`` re-derives only ``extrapolated`` of existing
single-pod records, on the mesh each names, from two reduced-depth runs.

Importing this module sets no environment variable and starts no
process group: `run_combo` starts a fake one when none is up, and
destroys it at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import axis_map, make_production_mesh
from repro_torch.launch.shardings import (batch_shardings, cache_shardings,
                                          distribute_tree, local_bytes,
                                          param_shardings)
from repro_torch.launch.train import make_train_step
from repro_torch.models.api import build_model
from repro_torch.models.transformer import ParamTree
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig, flatten
from repro_torch.sharding.rules import map_with_path, mesh_rules

DEFAULT_OUT = os.path.join("build", "dryrun")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# the functional collectives DTensor issues, by the reference's HLO names
_C10D_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0; collectives move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world_up_to(world_size: int):
    """`fake_world` of ``world_size`` ranks, or nothing when a process
    group is already up (the caller's)."""
    import torch.distributed as dist
    return contextlib.nullcontext() if dist.is_initialized() \
        else fake_world(world_size)


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat_tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat_tensors(v)


_propagating = threading.local()


def _in_propagation() -> bool:
    return getattr(_propagating, "depth", 0) > 0


@contextlib.contextmanager
def marked_propagation():
    """Flag the ops ``DTensor``'s sharding propagation runs on global-shape
    fake tensors to derive an output's metadata (under the active fake
    mode, so nothing else tells them from the local ops): the counters
    below skip them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *a, **k):
        _propagating.depth = getattr(_propagating, "depth", 0) + 1
        try:
            return orig(self, *a, **k)
        finally:
            _propagating.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def device_alltoall(counter):
    """``DTensor`` moves a shard from one dim to another with an
    all-to-all; on a CPU mesh it falls back to gathering the whole dim
    and keeping a chunk, which a device mesh (the production one) does
    not. Under this context the move returns this rank's chunk (shape
    only: the tensors are fake) and ``counter`` records it as the
    all-to-all a device backend runs."""
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        n = mesh.size(mesh_dim)
        shape = list(input.shape)
        shape[gather_dim] *= n
        shape[shard_dim] //= n
        out = input.new_empty(shape)
        rec = counter.collectives["all-to-all"]
        rec["count"] += 1
        rec["bytes"] += _tensor_bytes(out)
        return out

    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


class StepCounter(TorchDispatchMode):
    """Counts one rank's work: the flops of each matmul-like op at its
    local shapes, each non-view op's operand + result bytes (but for the
    ``prim`` namespace's metadata queries, such as ``prim.device`` on a
    fake tensor, which read no data), and the functional collectives by
    kind (count, result bytes).

    On a ``DTensor`` op it returns NotImplemented, so ``DTensor`` runs and
    its local ops come back here (a mode entered around ``DTensor`` code
    would otherwise see the global op); the ops of ``DTensor``'s sharding
    propagation are skipped (`marked_propagation`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {c: {"count": 0, "bytes": 0}
                            for c in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _C10D_KINDS.get(packet.__name__) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            rec = self.collectives[kind]
            rec["count"] += 1
            rec["bytes"] += sum(map(_tensor_bytes, _flat_tensors(out)))
        if not func.is_view and func.namespace != "prim":
            self.bytes_accessed += sum(
                map(_tensor_bytes, _flat_tensors((args, kwargs, out))))
        return out

    def summary(self) -> Dict[str, Any]:
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": coll}


def _with_depth(cfg, num_layers: int):
    """Reduced-depth variant of the same config (the encoder's depth
    scales along)."""
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, num_layers=num_layers)
    return dataclasses.replace(cfg, num_layers=num_layers, encoder=enc)


def build_step(arch: str, shape_name: str, mesh, multi_pod: bool, *,
               remat: bool = True, cfg=None, decode_tp_only: bool = True):
    """Returns (step_fn, abstract_args, shardings, cfg, shape) for the
    combo: ``abstract_args`` a tuple of meta trees, ``shardings`` the
    matching `NamedSharding` trees; ``step_fn(*placed_args)`` runs the
    step on the placed ``DTensor`` arguments (the params first).

    Train takes (params, AdamW moments {"m", "v"}, batch), the moments
    placed as their parameters (as the reference's ``param_specs`` over
    its optimizer tree places them); the step count is a Python int here
    (the reference's is an int32 leaf). ``decode_tp_only``: decode steps keep the data-axis ("fsdp") weight
    shard only on the expert stacks (``moe/``)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    model = build_model(cfg)
    amap = {"model": "model", "fsdp": "data"}
    abstract = model.abstract_params()
    fsdp_paths = r"moe/" if shape.kind == "decode" and decode_tp_only \
        else None
    p_sh = param_shardings(mesh, abstract, axis_map=amap,
                           fsdp_paths=fsdp_paths)
    specs = model.input_specs(shape)

    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(), remat=remat)

        def fn(params, moments, batch):
            return step(params, {**moments, "count": 0}, batch)
        moments = {k: v for k, v in adamw_init(abstract).items()
                   if k != "count"}
        by_path = flatten(p_sh)
        args = (abstract, moments, specs["batch"])
        in_sh = (p_sh, {"m": by_path, "v": dict(by_path)},
                 batch_shardings(mesh, specs["batch"], multi_pod))
    elif shape.kind == "prefill":
        def fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch,
                                     cache_seq_len=shape.seq_len)
        args = (abstract, specs["batch"])
        in_sh = (p_sh, batch_shardings(mesh, specs["batch"], multi_pod))
    else:  # decode: the token at the last slot of a seq_len cache
        split_layer = cfg.num_layers // 2

        def fn(params, caches, token, extras=None):
            with torch.no_grad():
                return model.decode_step(
                    params, caches, token, shape.seq_len - 1, extras=extras,
                    split_layer=split_layer, window_seq_len=shape.seq_len)
        args = [specs["caches"], specs["token"]]
        in_sh = [cache_shardings(mesh, specs["caches"], multi_pod),
                 batch_shardings(mesh, specs["token"], multi_pod)]
        if "extras" in specs:
            args.append(specs["extras"])
            in_sh.append(batch_shardings(mesh, specs["extras"], multi_pod))
        args, in_sh = (abstract, *args), (p_sh, *in_sh)
    return fn, args, in_sh, cfg, shape


def _fake_like(tree):
    """Fake CPU tensors of a meta tree's shapes and dtypes (inside an
    active ``FakeTensorMode``)."""
    return map_with_path(lambda _, a: torch.empty(a.shape, dtype=a.dtype,
                                                  device="cpu"), tree)


def _step_mem_tracker():
    """``torch.distributed._tools.mem_tracker.MemTracker`` that leaves the
    sharding propagation's global-shape fakes out of the peak."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _in_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return Tracker()


def run_step(mesh, multi_pod: bool, fn, args, in_sh, *, train: bool):
    """Place ``args`` by ``in_sh`` as fake ``DTensor``s on ``mesh`` and run
    ``fn`` on them under `mesh_rules`, counted (`StepCounter`) and
    memory-tracked. Returns (argument bytes, output bytes, peak bytes
    over the arguments, the counter's summary). Must run inside a
    ``FakeTensorMode``."""
    placed = [distribute_tree(mesh, _fake_like(a), s)
              for a, s in zip(args, in_sh)]
    params = ParamTree(placed[0])
    if train:
        params.requires_grad_(True)
    arg_bytes = local_bytes(tuple(placed))
    tracker, counter = _step_mem_tracker(), StepCounter()
    tracker.track_external(params, *[t for a in placed[1:]
                                     for t in _flat_tensors(a)])
    with mesh_rules(mesh, axis_map(multi_pod)), marked_propagation(), \
            device_alltoall(counter), tracker, counter:
        base = _total(tracker.get_tracker_snapshot("current"))
        out = fn(params, *placed[1:])
        peak = _total(tracker.get_tracker_snapshot("peak"))
    return arg_bytes, local_bytes(out), max(0, peak - base), \
        counter.summary()


def _total(snapshot) -> int:
    return int(sum(dev.get("Total", 0) for dev in snapshot.values()))


def depth_fit(arch: str, shape_name: str, mesh, multi_pod: bool,
              remat: bool, full_layers: int, k: int, *,
              cfg=None) -> Dict[str, Any]:
    """Extrapolate the per-device flops, bytes accessed and collectives
    to ``full_layers`` from two reduced-depth runs of the step (L1 = k,
    L2 = 2k; k respects the hybrid shared-attention period) on ``mesh``,
    as the reference's fit does. ``cfg`` (default ``get_config(arch)``)
    is the config whose depth is reduced. A process group of the mesh's
    world must be up.

    The runs are eager and count every layer, so unlike the reference's
    compiles nothing has to unroll a layer scan: L2 - L1 is exactly k
    layers' per-device cost."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    base = cfg or get_config(arch)
    l1, l2 = k, 2 * k
    points = []
    for depth in (l1, l2):
        with FakeTensorMode():
            fn, args, in_sh, _, shape = build_step(
                arch, shape_name, mesh, multi_pod, remat=remat,
                cfg=_with_depth(base, depth))
            *_, terms = run_step(mesh, multi_pod, fn, args, in_sh,
                                 train=shape.kind == "train")
        points.append(terms)
    (f1, b1, co1), (f2, b2, co2) = (
        (t["flops"], t["bytes_accessed"], t["collectives"]) for t in points)

    def extrap(v1, v2):
        slope = (v2 - v1) / (l2 - l1)
        return v1 + slope * (full_layers - l1)

    coll = {}
    for key in co1:
        if key == "total_bytes":
            continue
        coll[key] = {
            "count": int(round(extrap(co1[key]["count"], co2[key]["count"]))),
            "bytes": int(max(0, round(extrap(co1[key]["bytes"],
                                             co2[key]["bytes"])))),
        }
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values()
                              if isinstance(v, dict))
    return {
        "flops": float(max(0.0, extrap(f1, f2))),
        "bytes_accessed": float(max(0.0, extrap(b1, b2))),
        "collectives": coll,
        "fit_points": {"l1": l1, "l2": l2, "flops": [f1, f2],
                       "bytes": [b1, b2],
                       "coll_bytes": [co1["total_bytes"],
                                      co2["total_bytes"]]},
    }


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              remat: bool = True, out_dir: str | None = None,
              tag: str = "", quiet: bool = False, with_fit: bool = True,
              dp: int = 16, tp: int = 16, cfg=None) -> Dict[str, Any]:
    """Dry-run one combo on the production mesh (a fake world of dp·tp,
    x2 with ``multi_pod``, started here when no process group is up) and
    return its record; with ``with_fit``, also its `depth_fit` of the
    same config under ``extrapolated``; with ``out_dir``, also write it
    as JSON."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with _world_up_to(dp * tp * (2 if multi_pod else 1)):
        mesh = make_production_mesh(multi_pod=multi_pod, dp=dp, tp=tp,
                                    device="cpu")
        t0 = time.time()
        with FakeTensorMode():
            fn, args, in_sh, cfg, shape = build_step(
                arch, shape_name, mesh, multi_pod, remat=remat, cfg=cfg)
            arg_bytes, out_bytes, temp, terms = run_step(
                mesh, multi_pod, fn, args, in_sh,
                train=shape.kind == "train")
        walk_s = time.time() - t0
        n_dev = mesh.size()
        fit = depth_fit(arch, shape_name, mesh, multi_pod, remat,
                        cfg.num_layers, cfg.hybrid_attn_every or 1,
                        cfg=cfg) if with_fit else None
        fit_s = time.time() - t0 - walk_s
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": (f"multi_pod_2x{dp}x{tp}" if multi_pod
                 else f"single_pod_{dp}x{tp}"),
        "num_devices": int(n_dev),
        "tag": tag,
        "compile_s": round(walk_s, 1),
        **terms,
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(temp),
                   "generated_code_bytes": 0},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if fit is not None:
        result["extrapolated"] = fit
    if not quiet:
        coll = result["collectives"]
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']}"
              f"{' #' + tag if tag else ''}: ran in {result['compile_s']}s"
              + (f" (depth fit {fit_s:.1f}s)" if with_fit else "") +
              f"  flops={result['flops']:.3e}  "
              f"bytes={result['bytes_accessed']:.3e}  "
              f"coll={coll['total_bytes']:.3e}B ("
              + ", ".join(f"{k} {v['count']}" for k, v in coll.items()
                          if isinstance(v, dict) and v["count"]) + ")")
        print(f"  memory/device: args={arg_bytes / 1e9:.2f}GB "
              f"temp={temp / 1e9:.2f}GB out={out_bytes / 1e9:.2f}GB",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = f"{arch}_{shape_name}_{result['mesh']}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def refit(out_dir: str, *, only_arch: str = "", remat: bool = True):
    """Recompute only ``extrapolated`` (`depth_fit`) of the single-pod
    records in ``out_dir``, each on the (dp, tp) mesh its ``mesh`` names
    (a fake world of that size); every other key stays as written."""
    import glob
    for path in sorted(glob.glob(os.path.join(out_dir,
                                              "*single_pod*.json"))):
        with open(path) as f:
            r = json.load(f)
        if only_arch and r["arch"] != only_arch:
            continue
        dp, tp = map(int, re.fullmatch(r"single_pod_(\d+)x(\d+)",
                                       r["mesh"]).groups())
        cfg = get_config(r["arch"])
        t0 = time.time()
        with _world_up_to(dp * tp):
            mesh = make_production_mesh(dp=dp, tp=tp, device="cpu")
            fit = depth_fit(r["arch"], r["shape"], mesh, False, remat,
                            cfg.num_layers, cfg.hybrid_attn_every or 1)
        r["extrapolated"] = fit
        with open(path, "w") as f:
            json.dump(r, f, indent=1)
        print(f"[refit] {r['arch']} x {r['shape']}: "
              f"flops={fit['flops']:.3e} bytes={fit['bytes_accessed']:.3e} "
              f"coll={fit['collectives']['total_bytes']:.3e} "
              f"({time.time() - t0:.0f}s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes on the selected mesh")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fit", action="store_true",
                    help="skip the depth-fit compiles (multi-pod pass: "
                         "prove-it-lowers only, roofline is single-pod)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--dp", type=int, default=16)
    ap.add_argument("--tp", type=int, default=16)
    ap.add_argument("--refit", action="store_true",
                    help="recompute depth-fit extrapolations for existing "
                         "single-pod JSONs only")
    args = ap.parse_args(argv)

    if args.refit:
        refit(args.out, only_arch=args.arch or "",
              remat=not args.no_remat)
        return

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    failures = []
    for a, s in combos:
        try:
            run_combo(a, s, multi_pod=args.multipod, out_dir=args.out,
                      remat=not args.no_remat, tag=args.tag,
                      with_fit=not args.no_fit, dp=args.dp, tp=args.tp)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((a, s, repr(e)[:300]))
            print(f"[dryrun] FAILED {a} x {s}: {repr(e)[:300]}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run combos failed: "
                         + "; ".join(f"{a}x{s}" for a, s, _ in failures))
    print(f"[dryrun] all {len(combos)} combos ran OK "
          f"({'multi' if args.multipod else 'single'}-pod)")


if __name__ == "__main__":
    main()
