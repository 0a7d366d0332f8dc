"""Request-level serving with the `Engine` push-session API, in the
PyTorch port. The twin of ``examples/serve_engine.py``.

The one-shot `serve()` facade replays a finite offline stream. Real
deployments see *traffic*: requests arrive in bursts, and the server
must keep serving between them. This demo drives the same SplitEE
controller + offload-queue machinery through `Engine.submit/drain/close`:

  1. train the multi-exit testbed and calibrate alpha (as in
     examples/serve_splitee_torch.py),
  2. replay the evaluation stream as bursty arrivals (seeded random
     burst sizes), pushing each burst into the engine — full
     micro-batches are served as soon as they accumulate,
  3. drain mid-session for a live report (throughput, exit mix),
  4. close, and verify the session learned *exactly* what the one-shot
     facade would have: bit-identical arms, predictions, and bandit
     state on the same samples,
  5. replay the same bursts through the continuous-batching scheduler
     (`scheduler="fifo"`): per-request shed deadlines, a bounded queue
     with drop-oldest eviction, batch deadlines closing partial
     batches, and the `report.scheduler` ledger with p50/p99 latency.

Runs on cuda; ``--device cpu`` runs the plain PyTorch versions.

    PYTHONPATH=src python examples/serve_engine_torch.py --samples 600
"""
import argparse
import dataclasses
import itertools

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import CostModel, calibrate_alpha
from repro_torch.data import OnlineStream
from repro_torch.launch.serve import build_testbed
from repro_torch.serving import EdgeCloudRuntime, Engine, ServingConfig, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--offload", type=float, default=5.0)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--mean-burst", type=int, default=24,
                    help="average number of requests per arrival burst")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, model, _, eval_data, (conf_val, correct_val), log = \
        build_testbed(layers=args.layers, steps=args.steps, device=dev)
    print(f"testbed trained (final loss {log[-1]['loss']:.4f})")

    cost = CostModel(num_layers=cfg.num_layers, offload=args.offload)
    alpha = calibrate_alpha(conf_val, cost, correct_val)
    cost = dataclasses.replace(cost, alpha=alpha)
    print(f"alpha={alpha:.2f}")

    runtime = EdgeCloudRuntime(cfg, device=dev)
    scfg = ServingConfig(batch_size=args.batch_size,
                         max_samples=args.samples)

    # the "traffic": the eval stream chopped into seeded random bursts
    requests = list(itertools.islice(iter(OnlineStream(eval_data, seed=0)),
                                     args.samples))
    rng = np.random.default_rng(0)
    bursts, i = [], 0
    while i < len(requests):
        size = int(rng.integers(1, 2 * args.mean_burst))
        bursts.append(requests[i:i + size])
        i += size

    eng = Engine(runtime, params, cost, scfg)
    for k, burst in enumerate(bursts):
        eng.submit(burst)
        if k == len(bursts) // 2:          # mid-session health check
            waiting = eng.pending          # queue depth before the flush
            mid = eng.drain()
            print(f"[mid-session] served {mid.n} requests "
                  f"({mid.samples_per_sec:.0f} samples/s, "
                  f"exit-on-edge {1 - mid.offload_frac:.0%}; drain "
                  f"flushed {waiting} waiting for a batch)")
    report = eng.close()
    print(f"[final]       served {report.n} requests in {len(bursts)} "
          f"bursts: acc={report.accuracy:.3f} "
          f"cost={report.cost_total:.0f}λ "
          f"offload={report.offload_frac:.0%} "
          f"exits/layer={report.exits_per_layer.tolist()}")

    # the push-session is the one-shot facade, bit for bit — provided
    # drain() is only called at batch boundaries the one-shot run also
    # sees (mid-stream drains flush a ragged batch early, which is a
    # *different* but equally valid schedule; here the halfway drain
    # landed between bursts, so compare a fresh session without it)
    clean = Engine(runtime, params, cost, scfg)
    clean.submit(requests)
    session = clean.close()
    oneshot = serve(runtime, params, OnlineStream(eval_data, seed=0),
                    cost, scfg)
    np.testing.assert_array_equal(session.arms, oneshot.arms)
    np.testing.assert_array_equal(session.preds, oneshot.preds)
    np.testing.assert_array_equal(session.state["q"], oneshot.state["q"])
    print("push-session == one-shot serve(): arms, preds, and bandit "
          "state are bit-identical")

    # --- the same bursts behind the continuous-batching scheduler ----
    # A virtual clock stands in for wall time so the demo is
    # deterministic: each burst "arrives" 2 ms after the previous one,
    # requests expire if still queued after 8 ms, and partial batches
    # close after 4 ms instead of waiting for the next burst.
    clock_t = [0.0]
    sched_cfg = dataclasses.replace(
        scfg, scheduler="fifo", max_queue=4 * args.batch_size,
        batch_deadline_ms=4.0, shed_policy="drop_oldest")
    sched = Engine(runtime, params, cost, sched_cfg,
                   clock=lambda: clock_t[0])
    for burst in bursts:
        fire = sched.scheduler.next_fire()
        if fire is not None and fire <= clock_t[0] + 0.002:
            clock_t[0] = max(clock_t[0], fire)
            sched.tick()               # a batch deadline came due first
        clock_t[0] += 0.002
        sched.submit(burst, deadline_ms=8.0)
    sreport = sched.close()
    s, lat = sreport.scheduler, sreport.scheduler["latency_ms"]
    print(f"[scheduled]   served {s['served']} shed {s['shed']} "
          f"{dict(s['shed_reasons'])} over {s['batches']} batches "
          f"(fill {s['mean_batch_fill']:.2f}); latency "
          f"p50={lat['p50']:.2f}ms p99={lat['p99']:.2f}ms "
          f"(virtual clock)")


if __name__ == "__main__":
    main()
