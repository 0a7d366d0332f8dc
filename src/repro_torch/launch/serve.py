"""Serving driver of the port: train a multi-exit classifier on the
calibration domain, then stream the (shifted) evaluation domain through
the online SplitEE edge/cloud runtime — the paper's full pipeline
(stages i-iii) end to end.

    PYTHONPATH=src python -m repro_torch.launch.serve --samples 1500

runs on cuda; ``--device cpu`` runs the plain PyTorch versions (without
a GPU and without it, the driver raises). The flags are the reference's
(``repro.launch.serve``) but ``--conf-backend``: every kernel dispatches
by the device of its tensors.

The serving side of a run is one declarative `ServingConfig`
(serving/api.py), served through the `serve()` facade which picks the
runtime (sequential / batched / sharded / distributed) from the config.
``--config run.json`` rebuilds the *serving side* of a run from a saved
config artifact (remaining serving flags override its fields);
``--dump-config PATH`` writes the resolved config. Testbed flags
(``--layers/--steps/--offload/--eval-domain``) describe the model, not
the serving run, and must be repeated alongside ``--config``.

Multi-process serving spawns itself: ``--distributed --num-processes 2``
re-executes this driver (``sys.argv``) as 2 worker processes over the
cluster's TCPStore, each building the same deterministic testbed and
serving its contiguous slice of every micro-batch
(serving/distributed.py); host 0's summary is echoed. Workers on a card
all use ``cuda:0``; the driver itself touches no device.

``--fault-tolerant`` switches the cluster to the resilient runtime:
workers exchange over a shared FileKV directory (no coordinator, so no
single process owns the transport), publish heartbeats, and survive
worker death — the supervisor respawns a dead worker once and it rejoins
at an epoch boundary from the KV-store state. ``--heartbeat-timeout``
bounds failure detection.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import (CostModel, calibrate_alpha, confidence_cascade,
                              final_exit)
from repro_torch.data import OnlineStream, make_dataset
from repro_torch.data.synthetic import DOMAINS, VOCAB
from repro_torch.launch.train import exit_accuracy, train_classifier
from repro_torch.models.api import build_model
from repro_torch.serving import (DecodeRuntime, EdgeCloudRuntime,
                                 ServingConfig, serve)
from repro_torch.serving.distributed import (ENV_COORDINATOR, ENV_KV_DIR,
                                             cluster_identity,
                                             drive_respawned_cluster,
                                             ft_serving_context,
                                             init_distributed_from_env)

DEFAULT_SAMPLES = 1000


def build_testbed(*, layers: int = 6, steps: int = 300,
                  calib_domain: str = "sst2_like",
                  eval_domain: str = "imdb_like", n_train: int = 6144,
                  n_eval: int = 4096, seed: int = 0, device=None):
    """Train the multi-exit testbed (ElasticBERT geometry cut to d 128, 4
    heads, d_ff 512, float32) on ``device`` (default cuda). Returns (cfg,
    params, model, train_data, eval_data, (conf_val, correct_val), log):
    the validation slice of the calibration domain is what alpha is
    calibrated on."""
    base = get_smoke_config("elasticbert12")
    cfg = dataclasses.replace(
        base, num_layers=layers, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=VOCAB,
        num_classes=DOMAINS[calib_domain].num_classes, dtype="float32")
    train_data = make_dataset(calib_domain, n_train, seed=seed)
    params, model, log = train_classifier(cfg, train_data, steps=steps,
                                          batch_size=64, seed=seed,
                                          device=device)
    eval_data = make_dataset(eval_domain, n_eval, seed=seed + 1)
    # alpha calibrated on the *fine-tune* domain validation slice (labeled)
    val = make_dataset(calib_domain, 1024, seed=seed + 2)
    conf_val, _, correct_val = exit_accuracy(model, params, val)
    return cfg, params, model, train_data, eval_data, (conf_val,
                                                       correct_val), log


def add_serving_config_args(ap: argparse.ArgumentParser):
    """Flags that override `ServingConfig` fields (defaults are None so
    only explicitly-passed flags layer onto a ``--config`` file)."""
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="load a ServingConfig JSON artifact; the flags "
                         "below override its fields")
    ap.add_argument("--dump-config", default=None, metavar="PATH",
                    help="write the resolved ServingConfig JSON to PATH "
                         "(the serving-side reproducibility artifact)")
    ap.add_argument("--samples", type=int, default=None,
                    help=f"sample cap (config: max_samples; default "
                         f"{DEFAULT_SAMPLES} when no --config is given)")
    ap.add_argument("--side-info", action="store_true", default=None,
                    help="SplitEE-S: read all exits below the split "
                         "(config: side_info)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="micro-batch size B; >1 selects the batched "
                         "delayed-feedback runtime (config: batch_size)")
    ap.add_argument("--edge-mode", choices=["bucketed", "scan", "auto"],
                    default=None,
                    help="edge-phase strategy (config: edge_mode): "
                         "'bucketed' = one pow2-padded call per distinct "
                         "split depth, 'scan' = one masked forward through "
                         "every layer per micro-batch, 'auto' = scan for "
                         "mixed-depth micro-batches, bucketed otherwise")
    ap.add_argument("--workload", choices=["classify", "decode"],
                    default=None,
                    help="serving workload (config: workload): 'decode' = "
                         "autoregressive generation with per-token "
                         "early-exit/offload")
    ap.add_argument("--max-new-tokens", type=int, default=None,
                    help="tokens generated per prompt (config: "
                         "max_new_tokens; decode workload only)")
    ap.add_argument("--split-policy", choices=["bandit", "final"],
                    default=None,
                    help="decode split policy (config: split_policy): "
                         "'final' forces full depth every step — the "
                         "bit-identical plain-decode baseline")
    ap.add_argument("--mesh", action="store_true", default=None,
                    help="serve through the sharded data-parallel runtime "
                         "on a 1-D device mesh (config: mesh)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="data-parallel replica count (config: replicas; "
                         "the first R cards, or R CPU replicas with "
                         "--device cpu)")
    ap.add_argument("--no-overlap", action="store_true", default=None,
                    help="disable the async offload queue (config: "
                         "overlap=false); cloud flushes resolve at their "
                         "own batch boundary")
    ap.add_argument("--overlap-depth", type=int, default=None,
                    help="max in-flight cloud flushes K (config: "
                         "overlap_depth; 1 = double buffering; feedback "
                         "delay grows to <= (K+1)*B-1 rounds)")
    ap.add_argument("--distributed", action="store_true", default=None,
                    help="serve across worker processes (config: "
                         "distributed); spawns --num-processes workers "
                         "when run outside a cluster")
    ap.add_argument("--fault-tolerant", action="store_true", default=None,
                    help="serve through the resilient exchange (config: "
                         "fault_tolerant); heartbeats + membership "
                         "verdicts over a shared FileKV dir, supervised "
                         "respawn + rejoin")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds a host's heartbeat may be stale before "
                         "it is declared dead (config: heartbeat_timeout)")
    ap.add_argument("--controller-mode",
                    choices=["stationary", "sliding_window", "discounted"],
                    default=None,
                    help="bandit forgetting mode for non-stationary "
                         "streams (config: controller_mode)")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window size in micro-batches (config: "
                         "window; 0 = unbounded; needs "
                         "--controller-mode sliding_window)")
    ap.add_argument("--discount", type=float, default=None,
                    help="per-sample pull-count decay gamma in (0, 1] "
                         "(config: discount; needs --controller-mode "
                         "discounted)")
    ap.add_argument("--cost-trace", default=None, metavar="JSON",
                    help="time-varying offload cost as a CostTrace JSON "
                         "object (config: cost_trace), e.g. "
                         "'{\"kind\": \"steps\", \"times\": [500], "
                         "\"values\": [1.0, 8.0]}'")
    ap.add_argument("--offload-quant", choices=["none", "int8", "int4"],
                    default=None,
                    help="quantize the offloaded bottleneck activation "
                         "(config: offload_quant); per-channel affine")
    ap.add_argument("--offload-sparsity", type=float, default=None,
                    help="fraction of bottleneck entries dropped by "
                         "top-|x| sparsification before quantization "
                         "(config: offload_sparsity; 0 = dense)")
    ap.add_argument("--scheduler", choices=["none", "fifo"], default=None,
                    help="continuous-batching request scheduler (config: "
                         "scheduler)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="close partial batches after this wait (config: "
                         "batch_deadline_ms; 0 = close on fill only)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="request admission cap (config: max_queue; "
                         "0 = unbounded queue)")
    ap.add_argument("--shed-policy", choices=["reject", "drop_oldest"],
                    default=None,
                    help="queue-full policy (config: shed_policy)")


# flag -> ServingConfig field, for the flags whose value is the field's
_VALUE_FLAGS = (("samples", "max_samples"), ("batch_size", "batch_size"),
                ("edge_mode", "edge_mode"), ("workload", "workload"),
                ("max_new_tokens", "max_new_tokens"),
                ("split_policy", "split_policy"), ("replicas", "replicas"),
                ("overlap_depth", "overlap_depth"),
                ("heartbeat_timeout", "heartbeat_timeout"),
                ("controller_mode", "controller_mode"), ("window", "window"),
                ("discount", "discount"), ("offload_quant", "offload_quant"),
                ("offload_sparsity", "offload_sparsity"),
                ("scheduler", "scheduler"),
                ("deadline_ms", "batch_deadline_ms"),
                ("max_queue", "max_queue"), ("shed_policy", "shed_policy"))


def serving_config_from_args(args) -> ServingConfig:
    """Layer explicitly-passed CLI flags over the ``--config`` artifact
    (or the defaults)."""
    if args.config:
        with open(args.config) as f:
            base = ServingConfig.from_json(f.read())
    else:
        base = ServingConfig(max_samples=DEFAULT_SAMPLES)
    overrides = {field: getattr(args, flag) for flag, field in _VALUE_FLAGS
                 if getattr(args, flag) is not None}
    if args.side_info:
        overrides["side_info"] = True
    if args.mesh:
        overrides["mesh"] = True
    if args.no_overlap:
        overrides["overlap"] = False
    if args.distributed:
        overrides["distributed"] = True
    if args.fault_tolerant:
        overrides["fault_tolerant"] = True
        overrides["distributed"] = True
    if args.cost_trace is not None:
        overrides["cost_trace"] = json.loads(args.cost_trace)
    return dataclasses.replace(base, **overrides) if overrides else base


DECODE_EXIT_RATE = 0.85     # alpha-calibration target: shallow-exit freq


def run_decode(args, scfg: ServingConfig):
    """Decode workload: stream prompts through the per-token early-exit
    runtime (serving/decode.py) on ``args.device``. There is no LM
    fine-tuning stage, so the exit heads are confidence-*calibrated*
    rather than trained: alpha is set from a full-depth probe pass so ~85%
    of decode steps clear the exit threshold. The weights are the port's
    random init from seed 0 (`Model.init`)."""
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_smoke_config(args.decode_arch),
                              dtype="float32")
    params = build_model(cfg).init(seed=0, device=dev)
    runtime = DecodeRuntime(cfg, device=dev)

    n = scfg.max_samples or DEFAULT_SAMPLES
    rng = np.random.default_rng(0)
    prompts = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       size=args.prompt_len)}
               for _ in range(n)]

    # probe pass: run one batch at full depth, read the shallow exits'
    # confidences, put alpha at the (1 - target-rate) quantile
    probe = np.stack([np.asarray(p["tokens"], np.int32)
                      for p in prompts[:scfg.batch_size]])
    total = args.prompt_len + scfg.max_new_tokens
    logits0, caches = runtime.prefill_fn(params, probe, total)
    tok = logits0.argmax(dim=-1).to(torch.int32)
    depths = torch.full((probe.shape[0],), cfg.num_layers - 1,
                        dtype=torch.int32, device=dev)
    confs = []
    for t in range(scfg.max_new_tokens):
        _, conf, _, _, pred_fin, _, caches = runtime.edge_fn(
            params, caches, tok, args.prompt_len + t, depths, total)
        confs.append(conf[:-1].cpu().numpy().ravel())
        tok = pred_fin
    alpha = float(np.quantile(np.concatenate(confs),
                              1.0 - DECODE_EXIT_RATE))
    cost = CostModel(num_layers=cfg.num_layers, alpha=alpha,
                     offload=args.offload)
    print(f"decode testbed: arch={args.decode_arch} "
          f"L={cfg.num_layers} calibrated alpha={alpha:.4f}")

    out = serve(runtime, params, iter(prompts), cost, scfg)
    dec = out.decode
    depth = float(np.asarray(dec["realized_depths"]).mean()) + 1
    print(f"SplitEE-decode (policy={scfg.split_policy} "
          f"B={scfg.batch_size} T={scfg.max_new_tokens}): "
          f"sequences={dec['sequences']} "
          f"tokens={dec['tokens_generated']} "
          f"({dec['tokens_per_sec']:.1f} tok/s) "
          f"cost={out['cost_total']:.0f}λ "
          f"offload_frac={out['offload_frac']:.2f} "
          f"mean_depth={depth:.2f}/{cfg.num_layers} "
          f"wire={np.mean(dec['wire_bytes_per_sequence'])/1e3:.1f}kB/seq")
    if out.scheduler:
        s = out.scheduler
        print(f"scheduler: served={s['served']} shed={s['shed']} "
              f"{dict(s['shed_reasons'])}")


def _drive_cluster(args, scfg: ServingConfig):
    """Driver mode: re-run this program as ``--num-processes`` workers
    and echo host 0's output."""
    if not scfg.fault_tolerant:
        drive_respawned_cluster(args.num_processes)
        return
    # coordinator-free cluster over a FileKV dir: any worker (host 0
    # included) can die without taking the transport along, and the
    # supervisor can respawn it to rejoin
    with tempfile.TemporaryDirectory(prefix="splitee-kv-") as kv_dir:
        drive_respawned_cluster(
            args.num_processes, env={ENV_KV_DIR: kv_dir},
            coordinator=False, fail_fast=False, respawn=True,
            watchdog_timeout=max(4 * scfg.heartbeat_timeout, 20.0),
            startup_grace=600.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_serving_config_args(ap)
    # testbed / cluster-shape flags (not part of the ServingConfig)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--offload", type=float, default=5.0)
    ap.add_argument("--eval-domain", default="imdb_like")
    ap.add_argument("--decode-arch", default="qwen3-1.7b",
                    help="LM arch for --workload decode (any decoder-only "
                         "text arch of configs.ARCHS)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="prompt length for --workload decode")
    ap.add_argument("--fused-exit", action="store_true",
                    help="fuse exit-norm + head + confidence into one "
                         "launch (runtime, not config)")
    ap.add_argument("--num-processes", type=int, default=2,
                    help="worker count for --distributed self-spawn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    scfg = serving_config_from_args(args)

    # worker mode iff the SPLITEE_* cluster env vars are present (set by
    # respawn_distributed); joins the cluster before any device use
    in_cluster = (os.environ.get(ENV_COORDINATOR) is not None
                  or os.environ.get(ENV_KV_DIR) is not None)
    if in_cluster:
        init_distributed_from_env()
        if not scfg.distributed:      # workers always serve distributed
            scfg = dataclasses.replace(scfg, distributed=True)
    elif args.dump_config:            # driver process only, once
        with open(args.dump_config, "w") as f:
            f.write(scfg.to_json())
        print(f"wrote serving config to {args.dump_config}")
    dev = resolve_device(args.device)     # raises here without a GPU
    if scfg.workload == "decode":     # never distributed (config rejects)
        run_decode(args, scfg)
        return
    if not in_cluster and scfg.distributed:
        _drive_cluster(args, scfg)
        return

    # fault-tolerant workers build their exchange (and, when respawned,
    # download the merged state + stream position) BEFORE the expensive
    # testbed build, so heartbeats cover the startup skew
    fault_tolerant = in_cluster and os.environ.get(ENV_KV_DIR) is not None
    exchange, init_state, skip = None, None, 0
    if fault_tolerant:
        exchange, init_state, skip = ft_serving_context(
            heartbeat_timeout=scfg.heartbeat_timeout,
            heartbeat_interval=scfg.heartbeat_interval,
            pipeline_depth=scfg.overlap_depth if scfg.overlap else 0)

    host0 = (not in_cluster) or cluster_identity()[0] == 0

    cfg, params, model, _, eval_data, (conf_val, correct_val), log = \
        build_testbed(layers=args.layers, steps=args.steps,
                      eval_domain=args.eval_domain, device=dev)
    if host0:
        print(f"trained multi-exit testbed: final loss {log[-1]['loss']:.4f}")

    cost = CostModel(num_layers=cfg.num_layers, offload=args.offload)
    alpha = calibrate_alpha(conf_val, cost, correct_val)
    cost = dataclasses.replace(cost, alpha=alpha)
    if host0:
        print(f"calibrated alpha={alpha:.2f}")

    runtime = EdgeCloudRuntime(cfg, device=dev, fused_exit=args.fused_exit)
    stream = OnlineStream(eval_data, seed=0)
    path = scfg.resolved_path()
    if path in ("sharded", "distributed"):
        # bucket caps must divide over the data axis
        scfg = dataclasses.replace(
            scfg, batch_size=max(scfg.batch_size, scfg.replicas))
    if path == "distributed":
        if scfg.max_samples:          # capped run: shrink the cap by the
            samples = scfg.max_samples - skip     # rejoiner's progress
            if samples <= 0:
                # rejoin ack landed at (or past) the stream's final
                # fold: nothing left to serve, and max_samples=0 would
                # mean "unlimited" to the serving loop
                print(f"[fault-tolerant] rejoined at stream position "
                      f"{skip} of {scfg.max_samples}: nothing left to "
                      f"serve")
                return
            scfg = dataclasses.replace(scfg, max_samples=samples)
        if skip:                      # rejoined worker: resume mid-stream
            stream = itertools.islice(iter(stream), skip, None)
        out = serve(runtime, params, stream, cost, scfg,
                    exchange=exchange, init_state=init_state,
                    stream_offset=skip)
    else:
        out = serve(runtime, params, stream, cost, scfg)
    if not host0:
        return                      # one summary per cluster, from host 0
    variant = "SplitEE-S" if scfg.side_info else "SplitEE"
    if path == "distributed":
        ov = out["overlap"]
        dist = out["distributed"]
        ft = " FT" if dist.get("fault_tolerant") else ""
        variant += (f" (distributed H={dist['num_hosts']} "
                    f"R={out['replicas']}/host B={out['batch_size']} "
                    f"overlap={'K=%d' % ov['depth'] if ov['enabled'] else 'off'}"
                    f"{ft})")
        for rec in dist.get("reconfigurations", []):
            print(f"[fault-tolerant] round {rec['round']}: "
                  f"removed={rec['removed']} joined={rec['joined']} "
                  f"members={rec['members_after']} "
                  f"(detected in {rec['detect_s']:.1f}s)")
        if dist.get("lost_samples"):
            print(f"[fault-tolerant] {dist['lost_samples']} samples lost "
                  f"with failed hosts' in-flight slices")
    elif path == "sharded":
        ov = out["overlap"]
        variant += (f" (sharded R={out['replicas']} "
                    f"B={out['batch_size']} overlap="
                    f"{'K=%d' % ov['depth'] if ov['enabled'] else 'off'})")
    elif path == "batched":
        variant += f" (batched B={scfg.batch_size})"
    print(f"{variant}: n={out['n']} acc={out.get('accuracy', float('nan')):.3f} "
          f"cost={out['cost_total']:.0f}λ offload_frac={out['offload_frac']:.2f} "
          f"offloaded={out['offload_bytes']/1e6:.1f}MB "
          f"({out['samples_per_sec']:.0f} samples/s)")
    if out.scheduler:
        s, lat = out.scheduler, out.scheduler["latency_ms"]
        fill = s["mean_batch_fill"]
        print(f"scheduler: served={s['served']} shed={s['shed']} "
              f"{dict(s['shed_reasons'])} "
              f"p50={lat.get('p50', float('nan')):.2f}ms "
              f"p99={lat.get('p99', float('nan')):.2f}ms "
              f"fill={fill if fill is None else round(fill, 2)}")

    if skip:
        return     # rejoined host 0: partial stream, baselines unmeaning
    # reference: final-exit on the same samples
    conf_e, _, corr_e = exit_accuracy(model, params, {
        k: v[stream.order[:out["n"]]] for k, v in eval_data.items()})
    fa, fc = final_exit(conf_e, corr_e, cost)
    print(f"final-exit: acc={float(fa.mean()):.3f} cost={float(fc.sum()):.0f}λ")
    ca, cc = confidence_cascade(conf_e, corr_e, cost)
    print(f"cascade(ElasticBERT-style): acc={float(ca.mean()):.3f} "
          f"cost={float(cc.sum()):.0f}λ")


if __name__ == "__main__":
    main()
