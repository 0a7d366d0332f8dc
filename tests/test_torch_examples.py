"""The port's examples (``examples/*_torch.py``) against their reference
twins, on the CPU (``--device cpu``) at tiny sizes.

* serve_splitee and serve_engine: both examples' ``build_testbed``
  replaced by one tiny testbed the reference trained once (bridged for
  the port); every printed line equal but the wall-clock rates, and
  serve_engine's "push-session == one-shot serve()" assertion holds;
* lm_decode_splitee: the port's ``Model.init`` replaced by the bridged
  reference init; every printed line equal but tokens/s;
* train_multiexit ``--save``: the checkpoint loads in the reference's
  `load_pytree` bitwise as in the port's, and the port's `exit_accuracy`
  on it reprints the example's per-exit accuracy and confidence lines;
* quickstart: the profile, alpha, oracle, SplitEE and final-exit lines
  equal the reference's (the regret line sums in another order);
* each example's ``main`` raises without ``--device cpu`` on a host
  without CUDA.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load
from repro.configs import get_smoke_config
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import make_dataset
from repro_torch.data.synthetic import VOCAB
from repro_torch.launch.train import exit_accuracy
from repro_torch.models.api import Model, build_model

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LAYERS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in the other port files with many small
    calls; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv, monkeypatch, capsys):
    """The reference example's ``main()`` under ``sys.argv``, or the
    port's ``main(argv)``; returns what it printed."""
    if hasattr(mod, "resolve_device"):
        mod.main(argv)
    else:
        monkeypatch.setattr("sys.argv", [mod.__name__, *argv])
        mod.main()
    return capsys.readouterr().out


RATES = re.compile(r"\d+(\.\d+)? (samples/s|tok/s)")


def _steady(out):
    return RATES.sub("<rate>", out).splitlines()


@pytest.fixture(scope="module")
def testbeds():
    """The reference's tiny testbed (trained once) and its port twin."""
    ref = jserve.build_testbed(layers=LAYERS, steps=20, n_train=512,
                               n_eval=256)
    cfg, jp, _, train, evald, val, log = ref
    tcfg = dataclasses.replace(
        t_get_smoke_config("elasticbert12"), num_layers=LAYERS, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=VOCAB,
        num_classes=cfg.num_classes, dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    port = (tcfg, tp, build_model(tcfg), train, evald,
            tuple(np.asarray(v) for v in val), log)
    return ref, port


@pytest.mark.parametrize("name,argv", [
    ("serve_splitee", ["--samples", "40", "--batch-size", "8"]),
    ("serve_engine", ["--samples", "56", "--batch-size", "8",
                      "--mean-burst", "6"]),
])
def test_serving_examples_match_reference(name, argv, testbeds, monkeypatch,
                                          capsys):
    ref, port = testbeds
    jmod, tmod = _example(name), _example(f"{name}_torch")
    monkeypatch.setattr(jmod, "build_testbed", lambda **kw: ref)
    monkeypatch.setattr(tmod, "build_testbed", lambda **kw: port)
    argv = argv + ["--layers", str(LAYERS)]
    want = _run(jmod, argv, monkeypatch, capsys)
    got = _run(tmod, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert _steady(got) == _steady(want), (got, want)
    if name == "serve_engine":
        assert "push-session == one-shot serve(): arms, preds, and bandit " \
            "state are bit-identical" in got


def test_lm_decode_example_matches_reference(monkeypatch, capsys):
    cfg = dataclasses.replace(get_smoke_config("rwkv6-3b"), dtype="float32")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp)
    argv = ["--tokens", "6", "--prompts", "4", "--alpha", "0.02"]
    want = _run(_example("lm_decode_splitee"), argv, monkeypatch, capsys)
    got = _run(_example("lm_decode_splitee_torch"), argv + ["--device", "cpu"],
               monkeypatch, capsys)
    assert _steady(got) == _steady(want), (got, want)
    assert "decoded 24 tokens over 4 sequences" in got


def test_train_multiexit_checkpoint(tmp_path, monkeypatch, capsys):
    d = 32
    argv = ["--steps", "4", "--layers", str(LAYERS), "--d-model", str(d),
            "--batch-size", "16", "--save", str(tmp_path), "--device", "cpu"]
    out = _run(_example("train_multiexit_torch"), argv, monkeypatch, capsys)
    assert f"saved params to {tmp_path}" in out
    cfg = dataclasses.replace(
        get_smoke_config("elasticbert12"), num_layers=LAYERS, d_model=d,
        num_heads=4, num_kv_heads=4, d_ff=4 * d, vocab_size=VOCAB,
        num_classes=2, dtype="float32")
    ref = j_load(str(tmp_path), jtf.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = dataclasses.replace(
        t_get_smoke_config("elasticbert12"), num_layers=LAYERS, d_model=d,
        num_heads=4, num_kv_heads=4, d_ff=4 * d, vocab_size=VOCAB,
        num_classes=2, dtype="float32")
    model = build_model(tcfg)
    params = load_pytree(str(tmp_path), model.abstract_params(),
                         device="cpu")
    for (kp, want), (name, got) in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0],
            sorted(params.named_parameters())):
        assert "/".join(k.key for k in kp) == name.replace(".", "/")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lines = out.splitlines()
    for domain in ("sst2_like", "imdb_like"):
        conf, _, correct = exit_accuracy(model, params,
                                         make_dataset(domain, 2048, seed=9))
        i = lines.index(f"{domain:14s} per-exit acc : " + " ".join(
            f"{a:.2f}" for a in correct.mean(0)))
        assert lines[i + 1] == f"{'':14s} per-exit conf: " + " ".join(
            f"{c:.2f}" for c in conf.mean(0))


def test_quickstart_matches_reference(monkeypatch, capsys):
    want = _run(_example("quickstart"), [], monkeypatch, capsys).splitlines()
    got = _example("quickstart_torch")
    got.main()
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 7
    assert got[:6] == want[:6]
    assert got[6].startswith("regret: ")


@pytest.mark.parametrize("name", ["train_multiexit_torch", "serve_engine_torch",
                                  "serve_splitee_torch",
                                  "lm_decode_splitee_torch"])
def test_examples_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this process has CUDA; the guard is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
