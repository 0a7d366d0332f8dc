#!/usr/bin/env python3
"""Two costs of training an LM (rwkv6-3b by default) on one CUDA GPU.

    python3 tools/wkv6_training_costs.py [--layers 16] [--steps 3]
        [--depths 32,30,29,28] [--arch rwkv6-3b]

(``--layers 0`` skips the second, ``--depths ""`` the first.)

1. The deepest full-width ``--arch`` (default rwkv6-3b; any token LM:
   bf16, remat, 16 x 64 tokens) whose training step fits the card: for
   each of ``--depths``, a process of its own (the card otherwise empty)
   builds the model and takes two steps (`make_train_step`, AdamW), and
   prints its peak device memory or the out-of-memory error that stopped
   it.
2. A full-width rwkv6-3b training step (bf16, remat, 16 x 64 tokens,
   ``--layers`` of its 32) with `train_loss` reading each stacked (L, ...)
   parameter through one unbind (as it does) and through L ``v[i]``
   selects (as it did before: each select's backward writes a zero-filled
   leaf-sized gradient and the leaf sums L of them), in the order
   select, unbind, unbind, select: ms a step (the mean after a first
   step) and peak device memory. The same weights and batch throughout;
   the losses are printed, and the two paths' agree bitwise.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


class _Select:
    """A leaf's layer views as ``v[i]``: `train_loss` before the unbind."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, i):
        return self.leaf[i]


def _select_views(layers):
    from repro_torch.models.transformer import _is_tree
    return {k: _select_views(v) if _is_tree(v) else _Select(v)
            for k, v in layers.items()}


def depth_peak(torch, dev, arch: str, layers: int):
    """Two training steps of full-width ``arch`` at ``layers`` layers on
    an otherwise empty card: prints the peak device memory, or the
    out-of-memory error."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    params = transformer.init_params(cfg, seed=28, device=dev)
    params.requires_grad_(True)
    batch = _batch(torch, dev)
    state = adamw_init(params)
    step = make_train_step(build_model(cfg), AdamWConfig(lr=3e-4),
                           total_steps=2, warmup=0, remat=True)
    try:
        for _ in range(2):
            step(params, state, batch)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError as e:
        print(f"{arch} {layers} layers: out of memory: "
              f"{str(e).splitlines()[0]}", flush=True)
        return
    print(f"{arch} {layers} layers: two steps fit, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB "
          f"(max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.3f}",
          flush=True)


def _batch(torch, dev):
    from repro_torch.data import make_dataset
    tokens = torch.as_tensor(make_dataset("imdb_like", 16, seed=5)["tokens"],
                             device=dev)
    return {"tokens": tokens, "labels": tokens.long()}


def step_times(torch, dev, layers: int, steps: int):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=layers)
    model = build_model(cfg)
    params0 = transformer.init_params(cfg, seed=28, device=dev)
    batch = _batch(torch, dev)
    unbind = transformer.unbind_layers
    losses = {}
    for path in ("select", "unbind", "unbind", "select"):
        transformer.unbind_layers = _select_views if path == "select" \
            else unbind
        params = transformer.ParamTree(
            {k: v for k, v in _clone(params0).items()}).requires_grad_(True)
        state = adamw_init(params)
        step = make_train_step(model, AdamWConfig(lr=3e-4),
                               total_steps=steps, warmup=0, remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, run = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, _, info = step(params, state, batch)
            run.append(float(info["loss"]))
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        transformer.unbind_layers = unbind
        ms = sum(walls[1:]) / len(walls[1:]) * 1e3
        print(f"rwkv6-3b {layers} layers, one step of 16 x 64 tokens, "
              f"stacked leaves through {path}: {ms:.3f} ms a step (steps "
              f"2..{steps}), peak {peak / 1e9:.3f} GB; losses {run}",
              flush=True)
        if losses.setdefault(path, run) != run:
            print(f"  the two {path} runs' losses differ", flush=True)
        del params, state, step
        torch.cuda.empty_cache()
    print(f"select and unbind losses bitwise equal: "
          f"{losses['select'] == losses['unbind']}")


def _clone(tree):
    return {k: _clone(v) if hasattr(v, "items") else v.detach().clone()
            for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--depths", default="32,30,29,28",
                    help="depths to fit, each in a process of its own")
    ap.add_argument("--arch", default="rwkv6-3b",
                    help="the token LM whose depths --depths fits")
    ap.add_argument("--depth", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.depth:
        depth_peak(torch, dev, args.arch, args.depth)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    from repro_torch.kernels import build_all
    build_all()
    for layers in filter(None, args.depths.split(",")):
        subprocess.run([sys.executable, __file__, "--arch", args.arch,
                        "--depth", layers], check=True)
    if args.layers:
        step_times(torch, dev, args.layers, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
