"""End-to-end edge/cloud serving demo of the PyTorch port (the paper's
Figure 1 pipeline). The twin of ``examples/serve_splitee.py``:

  1. train a multi-exit testbed on the calibration domain (stage ii),
  2. calibrate alpha on its labeled validation split,
  3. stream the shifted evaluation domain through the online SplitEE
     controller driving the edge half and the cloud half, with the
     offload payload metered in bytes,
  4. compare SplitEE vs SplitEE-S vs final-exit / cascade baselines.

The serving side is one declarative `ServingConfig` served through the
`serve()` facade — the same config scales from the per-sample loop to
micro-batches, data-parallel replicas, and multi-process clusters. Runs
on cuda; ``--device cpu`` runs the plain PyTorch versions.

    PYTHONPATH=src python examples/serve_splitee_torch.py --samples 800

Multi-process serving spawns itself (serving/distributed.py; workers on
a card all use ``cuda:0``):

    PYTHONPATH=src python examples/serve_splitee_torch.py --distributed \\
        --num-processes 2 --batch-size 32
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (CostModel, calibrate_alpha, confidence_cascade,
                              final_exit)
from repro_torch.data import OnlineStream
from repro_torch.launch.serve import build_testbed
from repro_torch.launch.train import exit_accuracy
from repro_torch.serving import EdgeCloudRuntime, ServingConfig, serve
from repro_torch.serving.distributed import (ENV_COORDINATOR, ENV_KV_DIR,
                                             cluster_identity,
                                             drive_respawned_cluster,
                                             init_distributed_from_env)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=800)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--offload", type=float, default=5.0)
    ap.add_argument("--eval-domain", default="imdb_like")
    ap.add_argument("--batch-size", type=int, default=1,
                    help=">1 serves micro-batches through the "
                         "delayed-feedback batched runtime")
    ap.add_argument("--edge-mode", choices=["bucketed", "scan"],
                    default="bucketed",
                    help="edge-phase strategy for the batched/sharded "
                         "runtimes: 'scan' runs each micro-batch as one "
                         "masked forward through every layer (ignored by "
                         "--distributed, which stays bucketed)")
    ap.add_argument("--replicas", type=int, default=0,
                    help=">0 serves through the sharded data-parallel "
                         "runtime with that many replicas (the first R "
                         "cards, or R CPU replicas with --device cpu); "
                         "async offload overlap is on")
    ap.add_argument("--overlap-depth", type=int, default=1,
                    help="max in-flight cloud flushes K for the sharded/"
                         "distributed async offload pipeline")
    ap.add_argument("--distributed", action="store_true",
                    help="serve across worker processes; spawns "
                         "--num-processes workers when run standalone")
    ap.add_argument("--num-processes", type=int, default=2,
                    help="worker count for --distributed self-spawn")
    ap.add_argument("--fault-tolerant", action="store_true",
                    help="with --distributed: serve through the "
                         "resilient exchange over a FileKV dir — the "
                         "cluster survives worker death (full "
                         "supervisor/respawn flow lives in "
                         "repro_torch.launch.serve)")
    ap.add_argument("--heartbeat-timeout", type=float, default=5.0,
                    help="failure-detection bound for --fault-tolerant")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    # worker mode iff spawned by respawn_distributed: join the cluster's
    # store before any device use (FileKV clusters — --fault-tolerant —
    # exchange through ENV_KV_DIR instead)
    in_cluster = (os.environ.get(ENV_COORDINATOR) is not None
                  or os.environ.get(ENV_KV_DIR) is not None)
    if in_cluster:
        init_distributed_from_env()
    dev = resolve_device(args.device)

    if args.distributed and not in_cluster:
        if args.fault_tolerant:
            with tempfile.TemporaryDirectory(prefix="splitee-kv-") as kv:
                drive_respawned_cluster(
                    args.num_processes, env={ENV_KV_DIR: kv},
                    coordinator=False, fail_fast=False)
        else:
            drive_respawned_cluster(args.num_processes)
        return
    host0 = (not in_cluster) or cluster_identity()[0] == 0

    cfg, params, model, _, eval_data, (conf_val, correct_val), log = \
        build_testbed(layers=args.layers, steps=args.steps,
                      eval_domain=args.eval_domain, device=dev)
    if host0:
        print(f"testbed trained (final loss {log[-1]['loss']:.4f})")

    cost = CostModel(num_layers=cfg.num_layers, offload=args.offload)
    alpha = calibrate_alpha(conf_val, cost, correct_val)
    cost = dataclasses.replace(cost, alpha=alpha)
    if host0:
        print(f"alpha={alpha:.2f} (labeled validation split, "
              f"fine-tune domain)")

    # one declarative config; the facade resolves the runtime from it
    if in_cluster:
        scfg = ServingConfig(
            distributed=True,
            fault_tolerant=os.environ.get(ENV_KV_DIR) is not None,
            batch_size=max(args.batch_size, args.replicas, 1),
            replicas=max(args.replicas, 1),
            overlap_depth=args.overlap_depth,
            heartbeat_timeout=args.heartbeat_timeout,
            max_samples=args.samples)
    elif args.replicas > 0:
        scfg = ServingConfig(
            path="sharded",
            batch_size=max(args.batch_size, args.replicas),
            replicas=args.replicas, overlap_depth=args.overlap_depth,
            edge_mode=args.edge_mode, max_samples=args.samples)
    else:
        scfg = ServingConfig(batch_size=args.batch_size,
                             edge_mode=args.edge_mode,
                             max_samples=args.samples)

    runtime = EdgeCloudRuntime(cfg, device=dev)
    results = {}
    for side_info, label in [(False, "SplitEE"), (True, "SplitEE-S")]:
        stream = OnlineStream(eval_data, seed=0)
        out = serve(runtime, params, stream, cost,
                    dataclasses.replace(scfg, side_info=side_info))
        results[label] = out
        arms = np.bincount(out["arms"][-200:],
                           minlength=cfg.num_layers)
        if host0:
            print(f"{label:10s} acc={out['accuracy']:.3f} "
                  f"cost={out['cost_total']:.0f}λ "
                  f"offload={out['offload_frac']:.0%} "
                  f"({out['offload_bytes']/1e6:.2f} MB shipped) "
                  f"modal split={int(arms.argmax()) + 1} "
                  f"[{out.path} path]")

    if not host0:
        return                      # one summary per cluster, from host 0
    n = results["SplitEE"]["n"]
    order = OnlineStream(eval_data, seed=0).order[:n]
    sub = {k: v[order] for k, v in eval_data.items()}
    conf_e, _, corr_e = exit_accuracy(model, params, sub)
    fa, fc = final_exit(conf_e, corr_e, cost)
    ca, cc = confidence_cascade(conf_e, corr_e, cost)
    print(f"{'final-exit':10s} acc={float(fa.mean()):.3f} "
          f"cost={float(fc.sum()):.0f}λ (reference)")
    print(f"{'cascade':10s} acc={float(ca.mean()):.3f} "
          f"cost={float(cc.sum()):.0f}λ (ElasticBERT-style, no offload)")
    sp = results["SplitEE"]
    print(f"==> SplitEE cost reduction vs final-exit: "
          f"{100 * (1 - sp['cost_total'] / float(fc.sum())):.0f}% "
          f"at {100 * (sp['accuracy'] - float(fa.mean())):+.1f} pts accuracy")


if __name__ == "__main__":
    main()
