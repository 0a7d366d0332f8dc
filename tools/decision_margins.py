#!/usr/bin/env python3
"""Where two builds of the port part ways on rwkv6-3b serving decisions.

    python3 tools/decision_margins.py record --src DIR --out FILE.json
    python3 tools/decision_margins.py compare A.json B.json

``record`` (on a CUDA GPU) imports the port from ``DIR`` (the ``src`` of
a checkout, so an older revision can be recorded beside the current one)
and reproduces the rwkv6-3b "batched B=32" run of ``chip_smoke.py``: the
published configuration in bfloat16 with weights from seed 0, the
512-sample ``imdb_like`` stream (seed 1), alpha the median layer-16
confidence of 64 ``sst2_like`` samples (seed 2), the batched driver at
B = 32. It writes alpha, the served arms and exits, and every sample's
exit confidence at every layer (``forward_exits`` over the stream's
micro-batches), in stream order.

``compare`` finds the first sample whose arm or exit differs between two
records and prints, for each sample of that micro-batch whose exit
differs, its confidence at its arm in both records against alpha, beside
the median and largest relative confidence difference between the records
at that layer over all samples: the rounding scale of the change (and
the median at every exit). ``record
--device cpu --smoke --samples 64`` rehearses it on the CPU with the
small rwkv6 configuration.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BATCH = 32
SAMPLES = 512
ARCH = "rwkv6-3b"
ALPHA_LAYER = 16


def record(src: Path, out: Path, samples: int = SAMPLES,
           device: str = "cuda", smoke: bool = False) -> int:
    sys.path.insert(0, str(src.resolve()))
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import CostModel
    from repro_torch.data import OnlineStream, make_dataset, microbatches
    from repro_torch.models.transformer import forward_exits, init_params
    from repro_torch.serving import EdgeCloudRuntime, _serve_stream_batched

    if device == "cuda" and not torch.cuda.is_available():
        print("decision_margins.py record: no CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device(device)
    cfg = (get_smoke_config if smoke else get_config)(ARCH)
    params = init_params(cfg, seed=0, device=dev)
    data = make_dataset("imdb_like", samples, seed=1)
    calib = make_dataset("sst2_like", 64, seed=2)["tokens"]
    with torch.no_grad():
        conf = forward_exits(params, cfg, {"tokens": torch.as_tensor(
            calib, device=dev)})["conf"]
        alpha = float(conf[min(ALPHA_LAYER, cfg.num_layers) - 1].float().median())
        cost = CostModel(num_layers=cfg.num_layers, alpha=alpha, offload=3.0)
        served = _serve_stream_batched(
            EdgeCloudRuntime(cfg, device=dev), params,
            OnlineStream(data, seed=0), cost, batch_size=BATCH)
        confs = []
        for mb in microbatches(OnlineStream(data, seed=0), BATCH):
            tokens = torch.as_tensor(np.stack([s["tokens"] for s in mb]),
                                     device=dev)
            confs.append(forward_exits(params, cfg, {"tokens": tokens})[
                "conf"].float().cpu().numpy())
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "src": str(src), "device": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
        "alpha": alpha, "arms": np.asarray(served["arms"]).tolist(),
        "exited": np.asarray(served["exited"]).astype(int).tolist(),
        "conf": np.concatenate(confs, axis=1).T.tolist()}))   # (N, L)
    print(f"{src}: alpha {alpha!r}, exits {int(np.sum(served['exited']))} "
          f"of {served['n']} -> {out}")
    return 0


def compare(a_path: Path, b_path: Path) -> int:
    import numpy as np
    a, b = (json.loads(Path(p).read_text()) for p in (a_path, b_path))
    arms_a, arms_b = np.asarray(a["arms"]), np.asarray(b["arms"])
    ex_a, ex_b = np.asarray(a["exited"]), np.asarray(b["exited"])
    conf_a, conf_b = np.asarray(a["conf"]), np.asarray(b["conf"])
    print(f"alpha {a['alpha']!r} / {b['alpha']!r}; exits {ex_a.sum()} / "
          f"{ex_b.sum()} of {len(ex_a)}")
    for name, rec, arms, conf in (("a", a, arms_a, conf_a),
                                  ("b", b, arms_b, conf_b)):
        at_arm = conf[np.arange(len(arms)), arms] >= rec["alpha"]
        last = arms + 1 == conf.shape[1]
        bad = int(np.sum((at_arm | last) != np.asarray(rec["exited"], bool)))
        print(f"  {name}: exits that the recorded confidences do not "
              f"reproduce: {bad}")
    med = np.median(np.abs(conf_a - conf_b) / conf_a, axis=0)
    print("  median relative conf difference a / b at each exit: "
          + ", ".join(f"{m:.2e}" for m in med))
    diff = np.nonzero((arms_a != arms_b) | (ex_a != ex_b))[0]
    if not len(diff):
        print("identical arms and exits")
        return 0
    first = int(diff[0])
    mb = first // BATCH
    print(f"first difference at sample {first} (micro-batch {mb}); "
          f"{len(diff)} samples differ in all")
    for s in range(mb * BATCH, min((mb + 1) * BATCH, len(ex_a))):
        if arms_a[s] == arms_b[s] and ex_a[s] == ex_b[s]:
            continue
        layer = int(arms_a[s])
        rel = np.abs(conf_a[:, layer] - conf_b[:, layer]) / conf_a[:, layer]
        print(f"  sample {s}: arm {arms_a[s]} / {arms_b[s]}, exited "
              f"{ex_a[s]} / {ex_b[s]}; conf at layer {layer + 1}: "
              f"{float(conf_a[s, layer])!r} / {float(conf_b[s, layer])!r}, relative to "
              f"alpha {conf_a[s, layer] / a['alpha'] - 1:+.3e} / "
              f"{conf_b[s, layer] / b['alpha'] - 1:+.3e}; relative conf "
              f"difference a / b at that layer over all samples: median "
              f"{np.median(rel):.3e}, largest {rel.max():.3e}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    rec = sub.add_parser("record")
    rec.add_argument("--src", type=Path, required=True)
    rec.add_argument("--out", type=Path, required=True)
    rec.add_argument("--samples", type=int, default=SAMPLES)
    rec.add_argument("--device", default="cuda")
    rec.add_argument("--smoke", action="store_true")
    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("a", type=Path)
    cmp_.add_argument("b", type=Path)
    args = ap.parse_args()
    if args.cmd == "record":
        return record(args.src, args.out, args.samples, args.device,
                      args.smoke)
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
