"""The serving testbed: train the multi-exit classifier on the
calibration domain and hand the serving phase everything it needs (the
paper's stages i-ii). The serve CLI of the reference is not ported yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.data import make_dataset
from repro_torch.data.synthetic import DOMAINS, VOCAB
from repro_torch.launch.train import exit_accuracy, train_classifier


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
