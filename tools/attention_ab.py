#!/usr/bin/env python3
"""The block-attention kernel of two checkouts timed in turns on one card.

    python3 tools/attention_ab.py --src A/src --src B/src [--rounds 2]

On a machine with a CUDA GPU and the toolkit: for each round, runs A then
B then B then A (``--rounds 2`` gives A B B A A B B A), each in a fresh
process that imports ``repro_torch`` from its ``--src`` directory (whose
kernels build under that checkout's own ``build/``) and times
`ops.attention` without a gradient at the serve shape (32, 12, 64, 64)
bf16 bidirectional and the qwen3 decode prefill (8, 16/8, 64, 128) bf16
causal GQA: device ms per call, the median of 7 CUDA-graph replays of 20
calls (``chip_smoke.graph_ms``), all 7 printed. Inputs come from a fixed
seed, so both checkouts see the same tensors. Give it an older revision
unpacked by ``git archive`` under ``build/`` to hold a kernel change
against its parent; the card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import statistics, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke
from repro_torch.kernels.flash_attention.ops import attention
gen = torch.Generator(device="cuda").manual_seed(0)
def mk(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
cases = {"serve (32,12,64,64) bidirectional":
             ((mk(32, 12, 64, 64), mk(32, 12, 64, 64), mk(32, 12, 64, 64)),
              False),
         "qwen3 prefill (8,16/8,64,128) causal":
             ((mk(8, 16, 64, 128), mk(8, 8, 64, 128), mk(8, 8, 64, 128)),
              True)}
with torch.no_grad():
    for name, ((q, k, v), causal) in cases.items():
        ms = [chip_smoke.graph_ms(lambda: attention(q, k, v, causal=causal))
              for _ in range(7)]
        print(f"{sys.argv[3]}: {name}: median {statistics.median(ms):.6f} ms; "
              f"all {[round(x, 6) for x in ms]}", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, action="append", required=True,
                    help="a checkout's src directory; give two")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if len(args.src) != 2:
        ap.error("give --src twice: A, then B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    a, b = (p.resolve() for p in args.src)
    for _ in range(args.rounds):
        for label, src in (("A", a), ("B", b), ("B", b), ("A", a)):
            out = subprocess.run(
                [sys.executable, "-c", CHILD, str(src), str(ROOT),
                 f"{label} {src}"], capture_output=True, text=True, cwd=ROOT)
            print(out.stdout.strip(), flush=True)
            if out.returncode:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
