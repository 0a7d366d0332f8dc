"""SplitEE on an assigned LM architecture's decode path, through the
serving runtime of the PyTorch port. The twin of
``examples/lm_decode_splitee.py``.

Generation runs behind ``serve(workload="decode")`` (serving/decode.py):
every decode step evaluates the exit head at the bandit's splitting
layer; confident tokens are emitted by the edge half, the rest ship the
split-layer hidden plus the <= split cache slice to the cloud, which
finishes the step and returns the state the edge re-syncs from
(serving/kvcache.py keeps the KV cache consistent across the mix).

The default arch is rwkv6 (attention-free: the offloaded recurrent state
is tiny, the most favourable case for split computing; its layers run
the WKV6 kernel on the card); try ``--arch qwen3-1.7b`` for the
attention-family payload instead. The weights are the port's random init
from seed 0. Runs on cuda; ``--device cpu`` runs the plain PyTorch
versions.

    PYTHONPATH=src python examples/lm_decode_splitee_torch.py --tokens 16
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import CostModel
from repro_torch.models.api import build_model
from repro_torch.serving import DecodeRuntime, ServingConfig, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--tokens", type=int, default=16,
                    help="tokens generated per prompt")
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--alpha", type=float, default=0.02,
                    help="exit threshold (untrained weights, so near "
                         "chance)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"],
                    help="offload payload codec (with error feedback "
                         "when lossy)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_smoke_config(args.arch), dtype="float32")
    params = build_model(cfg).init(seed=0, device=dev)
    runtime = DecodeRuntime(cfg, device=dev)
    print(f"{args.arch} (reduced): {cfg.num_layers} layers, "
          f"d={cfg.d_model}, vocab={cfg.vocab_size} — untrained weights, "
          f"so alpha is set near chance ({args.alpha})")

    cost = CostModel(num_layers=cfg.num_layers, alpha=args.alpha,
                     offload=3.0)
    rng = np.random.default_rng(0)
    prompts = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       size=args.prompt_len)}
               for _ in range(args.prompts)]
    scfg = ServingConfig(workload="decode", max_new_tokens=args.tokens,
                         batch_size=args.prompts,
                         offload_quant=args.quant,
                         offload_error_feedback=args.quant != "none")

    out = serve(runtime, params, iter(prompts), cost, scfg)

    dec = out.decode
    depths = np.asarray(dec["realized_depths"])      # (B, T), 0-based
    exited = np.asarray(dec["exited_steps"])
    for t in range(min(5, args.tokens)):
        n_exit = int(exited[:, t].sum())
        print(f"  t={t:3d} mean_split_layer={depths[:, t].mean() + 1:5.2f} "
              f"{n_exit}/{args.prompts} EXIT on edge, "
              f"{args.prompts - n_exit} offload -> cloud")
    final_cost = cost.lam * cfg.num_layers * dec["tokens_generated"]
    print(f"decoded {dec['tokens_generated']} tokens over "
          f"{dec['sequences']} sequences "
          f"({dec['tokens_per_sec']:.1f} tok/s): "
          f"{int(exited.sum())} exited on edge, "
          f"{int(np.asarray(dec['offloaded_steps']).sum())} offloaded "
          f"({np.mean(dec['offloads_per_sequence']):.1f}/seq, "
          f"{np.mean(dec['wire_bytes_per_sequence']) / 1e3:.2f} kB/seq "
          f"on the wire); total cost {out['cost_total']:.1f}λ "
          f"(final-exit would be {final_cost:.1f}λ)")


if __name__ == "__main__":
    main()
