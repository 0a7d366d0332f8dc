"""Training entry point of the port: a train step (loss, gradients, AdamW)
and the multi-exit classifier training the paper's experiments use
(stage ii, supervised fine-tuning).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 20

runs the reference's recipe (sst2_like, 8192 samples, batch 64, lr 3e-4,
200 steps unless ``--steps``); without ``--device`` it trains on cuda.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import batch_iterator, make_dataset
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.shards import is_dtensor


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    total_steps: int = 1000, warmup: int = 50,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"})``: the loss and its gradients by autograd, then one
    AdamW step under the cosine schedule. ``params`` (trainable leaves)
    and ``opt_state`` are updated in place and returned; the info values
    are device tensors, read when the caller needs them.

    Over ``DTensor`` parameters (model parallelism, under `mesh_rules`)
    the same step runs on the mesh: AdamW updates each rank's shards, the
    gradient norm is the global one, and the info values are the whole
    (replicated) scalars on each rank."""
    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        loss = model.train_loss(params, batch, remat=remat)
        loss.backward()
        # a leaf the loss never reads (rwkv6's unused channel-mix copy
        # under "tm") gets a zero gradient, as jax.grad gives it
        grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
                 for name, p in params.named_parameters()}
        lr_scale = cosine_schedule(opt_state["count"], total_steps, warmup)
        gnorm = adamw_update(params, grads, opt_state, opt_cfg, lr_scale)
        info = {"loss": loss.detach(), "gnorm": gnorm}
        return params, opt_state, {k: v.full_tensor() if is_dtensor(v)
                                   else v for k, v in info.items()}

    return train_step


def _device_batch(b, device):
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def train_classifier(cfg, data: Dict[str, np.ndarray], *, steps: int,
                     batch_size: int, seed: int = 0, lr: float = 3e-4,
                     log_every: int = 20, remat: bool = False, device=None):
    """Train a multi-exit classifier (the paper's supervised fine-tune,
    stage ii) on ``device`` (default cuda). Returns (params, model, log):
    params frozen again (no gradient, the last step's gradients dropped)
    for serving, log a list of {step, loss, time} every ``log_every``
    steps and at the last. The loss is read (a device sync) only at a
    logged step. (The reference's ``eval_data`` argument, which it never
    reads, is left out.)"""
    dev = resolve_device(device)
    model = build_model(cfg)
    params = model.init(seed=seed, device=dev).requires_grad_(True)
    opt_cfg = AdamWConfig(lr=lr)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg, total_steps=steps, remat=remat)
    log = []
    it = batch_iterator(data, batch_size, seed=seed, epochs=10_000)
    t0 = time.time()
    for step in range(steps):
        b = next(it)
        batch = _device_batch({"tokens": b["tokens"], "labels": b["labels"]},
                              dev)
        params, opt_state, info = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            log.append({"step": step, "loss": float(info["loss"]),
                        "time": time.time() - t0})
    params.zero_grad(set_to_none=True)
    return params.requires_grad_(False), model, log


@torch.no_grad()
def exit_accuracy(model: Model, params, data, *, batch_size: int = 256):
    """Per-exit confidence and accuracy on a dataset (diagnostics and the
    SplitEE input), on the device of ``params``. Returns numpy conf (N, L)
    float32, pred (N, L) int32 and correct (N, L) bool."""
    dev = params["embed"].device
    confs, preds = [], []
    n = len(data["labels"])
    for s in range(0, n, batch_size):
        tokens = torch.as_tensor(data["tokens"][s:s + batch_size], device=dev)
        out = model.forward_exits(params, {"tokens": tokens})
        confs.append(out["conf"].cpu().numpy().T)          # (B, L)
        preds.append(out["pred"].cpu().numpy().T)
    conf = np.concatenate(confs)
    pred = np.concatenate(preds)
    correct = pred == data["labels"][:n, None]
    return conf, pred, correct


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="elasticbert12")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--domain", default="sst2_like")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.num_classes == 0:
        raise SystemExit("train.py main targets classification testbeds; "
                         "LM training has no entry point here")
    from repro_torch.data.synthetic import DOMAINS, VOCAB
    cfg = dataclasses.replace(cfg, vocab_size=VOCAB,
                              num_classes=DOMAINS[args.domain].num_classes,
                              dtype="float32")
    data = make_dataset(args.domain, args.n_train, seed=0)
    _, _, log = train_classifier(cfg, data, steps=args.steps,
                                 batch_size=args.batch_size,
                                 device=args.device)
    for row in log:
        print(f"step {row['step']:5d} loss {row['loss']:.4f} "
              f"t={row['time']:.1f}s")


if __name__ == "__main__":
    main()
