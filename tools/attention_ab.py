#!/usr/bin/env python3
"""The block-attention kernels of two checkouts timed in turns on one card.

    python3 tools/attention_ab.py --src A/src --src B/src [--rounds 2]
    python3 tools/attention_ab.py --tiles --src B/src

On a machine with a CUDA GPU and the toolkit: for each round, runs A then
B then B then A (``--rounds 2`` gives A B B A A B B A), each in a fresh
process that imports ``repro_torch`` from its ``--src`` directory (whose
kernels build under that checkout's own ``build/``) and times

* `ops.attention` without a gradient at the serve shape (32, 12, 64, 64)
  bf16 bidirectional and the qwen3 decode prefill (8, 16/8, 64, 128) bf16
  causal GQA;
* the backward kernel `flash_attention_backward_cuda` (on the forward's
  output and lse, through the tile its checkout picks) at seamless's
  encoder (8, 16, 4096, 64) bidirectional, its cross-attention q (8, 16,
  32, 64) over k/v (8, 16, 4096, 64), and qwen2-vl's training shape (16,
  12/2, 64, 128) bf16 causal GQA:

device ms per call, the median of 7 CUDA-graph replays (``chip_smoke.
graph_ms``), all 7 printed. Inputs come from a fixed seed, so both
checkouts see the same tensors. Give it an older revision unpacked by
``git archive`` under ``build/`` to hold a kernel change against its
parent; the card's name and power limit head the output.

``--tiles`` instead times the backward's two tensor_core tiles of one
checkout against each other, mma_sync then wgmma then wgmma then mma_sync
in one process, over key counts at head dims 64 and 128 (the A/B behind
`kernel.WGMMA_MIN_KEYS`).
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
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import attention
gen = torch.Generator(device="cuda").manual_seed(0)
def mk(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def report(name, fn, few=False):
    kw = {"calls": 3, "replays": 4} if few else {}
    ms = [chip_smoke.graph_ms(fn, **kw) for _ in range(7)]
    print(f"{sys.argv[3]}: {name}: median {statistics.median(ms):.6f} ms; "
          f"all {[round(x, 6) for x in ms]}", flush=True)
cases = {"serve (32,12,64,64) bidirectional":
             ((mk(32, 12, 64, 64), mk(32, 12, 64, 64), mk(32, 12, 64, 64)),
              False),
         "qwen3 prefill (8,16/8,64,128) causal":
             ((mk(8, 16, 64, 128), mk(8, 8, 64, 128), mk(8, 8, 64, 128)),
              True)}
with torch.no_grad():
    for name, ((q, k, v), causal) in cases.items():
        report(name, lambda: attention(q, k, v, causal=causal))
    for name, (b, hq, hkv, sq, skv, d, causal) in {
            "backward seamless encoder (8,16,4096,64)":
                (8, 16, 16, 4096, 4096, 64, False),
            "backward seamless cross (8,16,32 over 4096,64)":
                (8, 16, 16, 32, 4096, 64, False),
            "backward qwen2-vl (16,12/2,64,128) causal":
                (16, 12, 2, 64, 64, 128, True)}.items():
        q, k, v, dout = mk(b, hq, sq, d), mk(b, hkv, skv, d), \
            mk(b, hkv, skv, d), mk(b, hq, sq, d)
        out, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                          return_lse=True)
        report(name, lambda: K.flash_attention_backward_cuda(
            q, k, v, out, lse, dout, causal=causal, window=0,
            scale=d ** -0.5), few=sq * skv > 1 << 20)
        del q, k, v, dout, out, lse
'''

TILES = r'''
import statistics, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
import chip_smoke
from repro_torch.kernels.flash_attention import kernel as K
gen = torch.Generator(device="cuda").manual_seed(0)
def mk(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
shapes = [(8, 16, 16, s, s, 64, c) for c in (False, True)
          for s in (64, 128, 256, 512, 1024, 4096)]
shapes += [(8, 16, 16, 32, s, 64, False) for s in (64, 128, 256, 1024, 4096)]
shapes += [(16, 12, 2, s, s, 128, True) for s in (64, 128, 256, 512, 1024)]
with torch.no_grad():
    for b, hq, hkv, sq, skv, d, causal in shapes:
        q, k, v, dout = mk(b, hq, sq, d), mk(b, hkv, skv, d), \
            mk(b, hkv, skv, d), mk(b, hq, sq, d)
        out, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                          return_lse=True)
        few = {"calls": 3, "replays": 4} if sq * skv > 1 << 20 else {}
        got = {"mma_sync": [], "wgmma": []}
        for tile in ("mma_sync", "wgmma", "wgmma", "mma_sync") * 2:
            got[tile].append(chip_smoke.graph_ms(
                lambda: K.flash_attention_backward_cuda(
                    q, k, v, out, lse, dout, causal=causal, window=0,
                    scale=d ** -0.5, tile=tile), **few))
        picked = K.attention_backward_tile(torch.bfloat16, d, True, sq, skv)
        print(f"tiles ({b},{hq}/{hkv},{sq}x{skv},{d})"
              f"{' causal' if causal else ''}: "
              + "; ".join(f"{t} median {statistics.median(m):.6f} ms all "
                          f"{[round(x, 6) for x in m]}"
                          for t, m in got.items())
              + f"; picked {picked}", flush=True)
        del q, k, v, dout, out, lse
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, action="append", required=True,
                    help="a checkout's src directory; give two (one with "
                         "--tiles)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tiles", action="store_true",
                    help="time the backward's two tiles of one checkout")
    args = ap.parse_args()
    if len(args.src) != (1 if args.tiles else 2):
        ap.error("give --src once with --tiles, else twice: A, then B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    if args.tiles:
        src = args.src[0].resolve()
        turns = [(TILES, "tiles", src)]
    else:
        a, b = (p.resolve() for p in args.src)
        turns = [(CHILD, label, src) for _ in range(args.rounds)
                 for label, src in (("A", a), ("B", b), ("B", b), ("A", a))]
    for code, label, src in turns:
        out = subprocess.run(
            [sys.executable, "-c", code, str(src), str(ROOT),
             f"{label} {src}"], capture_output=True, text=True, cwd=ROOT)
        print(out.stdout.strip(), flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
