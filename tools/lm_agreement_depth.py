#!/usr/bin/env python3
"""Card vs CPU agreement of full-width rwkv6-3b in float32, by depth, with
a float64 CPU reading as the witness.

    python3 tools/lm_agreement_depth.py --layers 8 16 32

On a CUDA GPU, from the repository root: builds the port's kernels, makes
the full-width rwkv6-3b weights of ``chip_smoke.py`` (bf16, seed 0) and, for
each cut to the first N layers, runs ``chip_smoke.lm_depth_witness``:
`forward_exits` and `forward_exits_masked` (8 samples, exit depths spread
over 0..N-1) on the card in float32 (WKV6 and exit kernels), on the CPU in
float32 and on the CPU in float64 (plain versions), with each pair's max
relative conf error. A card that sits more than WITNESS_FACTOR times as
far from float64 as the CPU's float32 is reported as a port fault; the
script prints every cut and then exits 1.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 16, 32])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("lm_agreement_depth.py: no CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    build_all()
    dev = torch.device("cuda", 0)
    params, cfg, data, _ = cs.serve_setup(torch, dev, cs.LM, 16)
    held = [cs.lm_depth_witness(torch, dev, params, cfg, data, n,
                                strict=False) for n in args.layers]
    return 0 if all(held) else 1


if __name__ == "__main__":
    sys.exit(main())
