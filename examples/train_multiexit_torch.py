"""End-to-end driver of the PyTorch port: train a multi-exit classifier
(the paper's stage ii) and report per-exit accuracy/confidence on a
*shifted* evaluation domain (stage iii input). The twin of
``examples/train_multiexit.py``.

Default geometry is small; ``--full`` trains the paper's BERT-base
geometry (ElasticBERT-12: 12 layers, d 768, float32). Runs on cuda;
``--device cpu`` runs the plain PyTorch versions. ``--save DIR`` writes
the trained parameters in the reference's checkpoint format
(`repro_torch.checkpoint`), which either package loads.

    PYTHONPATH=src python examples/train_multiexit_torch.py --steps 300
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_dataset
from repro_torch.data.synthetic import DOMAINS, VOCAB
from repro_torch.launch.train import exit_accuracy, train_classifier


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="paper geometry (BERT-base, 110M)")
    ap.add_argument("--calib-domain", default="sst2_like")
    ap.add_argument("--eval-domain", default="imdb_like")
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = get_config("elasticbert12") if args.full \
        else get_smoke_config("elasticbert12")
    cfg = dataclasses.replace(
        base,
        num_layers=base.num_layers if args.full else args.layers,
        d_model=base.d_model if args.full else args.d_model,
        num_heads=base.num_heads if args.full else 4,
        num_kv_heads=base.num_kv_heads if args.full else 4,
        d_ff=base.d_ff if args.full else 4 * args.d_model,
        vocab_size=VOCAB,
        num_classes=DOMAINS[args.calib_domain].num_classes,
        dtype="float32")
    print(f"training multi-exit model: {cfg.num_layers} layers, "
          f"d={cfg.d_model} ({cfg.param_count()/1e6:.1f}M params), "
          f"exit after every layer")

    train = make_dataset(args.calib_domain, 8192, seed=0)
    params, model, log = train_classifier(
        cfg, train, steps=args.steps, batch_size=args.batch_size, device=dev)
    for row in log[:: max(1, len(log) // 8)]:
        print(f"  step {row['step']:5d}  loss {row['loss']:.4f}  "
              f"t={row['time']:.0f}s")

    for domain in (args.calib_domain, args.eval_domain):
        data = make_dataset(domain, 2048, seed=9)
        conf, pred, correct = exit_accuracy(model, params, data)
        accs = " ".join(f"{a:.2f}" for a in correct.mean(0))
        confs = " ".join(f"{c:.2f}" for c in conf.mean(0))
        print(f"{domain:14s} per-exit acc : {accs}")
        print(f"{'':14s} per-exit conf: {confs}")

    if args.save:
        save_pytree(args.save, params)
        print(f"saved params to {args.save}")


if __name__ == "__main__":
    main()
