"""Port vs reference: the serve CLI (launch/serve.py).

* `add_serving_config_args` / `serving_config_from_args` give the
  reference's `ServingConfig` (compared as JSON) over a table of flag
  sets: every flag, ``--config`` with overrides, ``--cost-trace``, and
  ``--fault-tolerant`` implying ``distributed``; invalid sets raise the
  reference's message;
* classify ``main`` against the reference's ``main`` (``sys.argv``
  monkeypatched), with both modules' ``build_testbed`` replaced by one
  tiny testbed that the reference trained once (bridged for the port):
  the summary line's decision fields (path, n, acc, cost, offload_frac,
  offloaded; not samples/s), the alpha line, the baselines and the
  scheduler's counts are equal for bucketed, scan, ``--side-info``,
  ``--fused-exit``, ``--mesh --replicas 1`` and ``--scheduler fifo``,
  and both ``--dump-config`` files are equal as JSON;
* ``run_decode`` against the reference's, the port's ``Model.init``
  replaced by the bridged reference init: the calibrated alpha, tokens,
  cost, offload_frac, mean depth and wire bytes printed equal;
* driver mode (``python -m repro_torch.launch.serve --distributed``, a
  subprocess: the workers re-run ``sys.argv``): a 2-process lockstep
  cluster's host-0 summary equals the port's own 1-process distributed
  run with the same flags. The fault-tolerant driver mode (a kill,
  respawn and rejoin) is timing-bound and does not fit this file's time
  budget beside the suite's load: ``chip_smoke.py`` runs it on the GPU;
* without ``--device cpu`` on a host without CUDA, ``main`` raises.
"""
import argparse
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro.serving import ServingConfig as JConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data.synthetic import VOCAB
from repro_torch.launch import serve as tserve
from repro_torch.models.api import Model, build_model
from repro_torch.serving import ServingConfig

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LAYERS = 2
SAMPLES = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's xdist workers torch's pool
    (a thread a core in every worker) oversubscribes the cores and makes
    these many small calls several times slower. Restored after the
    module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ config flags

FLAG_SETS = [
    [],
    ["--samples", "0"],
    ["--edge-mode", "scan", "--batch-size", "8"],
    ["--edge-mode", "auto", "--batch-size", "8", "--side-info"],
    ["--mesh", "--replicas", "2", "--batch-size", "8"],
    ["--no-overlap", "--overlap-depth", "3", "--replicas", "2"],
    ["--distributed", "--overlap-depth", "2", "--batch-size", "16"],
    ["--fault-tolerant"],
    ["--fault-tolerant", "--heartbeat-timeout", "2.5"],
    ["--controller-mode", "sliding_window", "--window", "4"],
    ["--controller-mode", "discounted", "--discount", "0.9"],
    ["--cost-trace", '{"kind": "steps", "times": [500], '
                     '"values": [1.0, 8.0]}'],
    ["--offload-quant", "int4", "--offload-sparsity", "0.5"],
    ["--scheduler", "fifo", "--deadline-ms", "4", "--max-queue", "32",
     "--shed-policy", "drop_oldest", "--batch-size", "8"],
    ["--workload", "decode", "--max-new-tokens", "4", "--split-policy",
     "final", "--batch-size", "4"],
]
BAD_SETS = [["--window", "4"], ["--fault-tolerant", "--scheduler", "fifo"],
            ["--max-new-tokens", "3"], ["--batch-size", "0"],
            ["--offload-sparsity", "1.0"]]


def _parsers():
    out = []
    for mod in (jserve, tserve):
        ap = argparse.ArgumentParser()
        mod.add_serving_config_args(ap)
        out.append(ap)
    return out


def test_parsers_take_the_same_flags():
    j, t = _parsers()
    assert [a.option_strings for a in j._actions] == \
        [a.option_strings for a in t._actions]
    assert [(a.default, a.choices, a.type) for a in j._actions] == \
        [(a.default, a.choices, a.type) for a in t._actions]


def _configs(argv):
    j, t = _parsers()
    return (jserve.serving_config_from_args(j.parse_args(argv)),
            tserve.serving_config_from_args(t.parse_args(argv)))


@pytest.mark.parametrize("argv", FLAG_SETS, ids=lambda a: " ".join(a) or "-")
def test_serving_config_from_args_matches_reference(argv, tmp_path):
    want, got = _configs(argv)
    assert isinstance(got, ServingConfig)
    assert got.to_json() == want.to_json()
    assert got.resolved_path() == want.resolved_path()
    # the same flags over a --config artifact (either package's JSON)
    base = JConfig(batch_size=4, beta=0.5, max_samples=77,
                   offload_quant="int8")
    path = tmp_path / "base.json"
    path.write_text(base.to_json())
    want, got = _configs(["--config", str(path)] + argv)
    assert got.to_json() == want.to_json()
    if "--fault-tolerant" in argv:
        assert got.fault_tolerant and got.distributed


@pytest.mark.parametrize("argv", BAD_SETS, ids=" ".join)
def test_invalid_flag_sets_raise_the_reference_message(argv):
    j, t = _parsers()
    with pytest.raises(ValueError) as want:
        jserve.serving_config_from_args(j.parse_args(argv))
    with pytest.raises(ValueError) as got:
        tserve.serving_config_from_args(t.parse_args(argv))
    assert str(got.value) == str(want.value)


def test_an_unknown_choice_exits_as_the_reference():
    for ap in _parsers():
        with pytest.raises(SystemExit):
            ap.parse_args(["--edge-mode", "warp"])


# --------------------------------------------------------- classify main

@pytest.fixture(scope="module")
def testbeds():
    """The reference's tiny testbed (trained once) and the port's twin of
    it: the same config, the bridged parameters, the same data and the
    same validation confidences (so both calibrate the same alpha)."""
    ref = jserve.build_testbed(layers=LAYERS, steps=20, n_train=512,
                               n_eval=256)
    cfg, jp, jmodel, train, evald, val, log = ref
    tcfg = dataclasses.replace(
        t_get_smoke_config("elasticbert12"), num_layers=LAYERS, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=VOCAB,
        num_classes=cfg.num_classes, dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    val = tuple(np.asarray(v) for v in val)
    port = (tcfg, tp, build_model(tcfg), train, evald, val, log)
    return ref, port


SUMMARY = re.compile(r"^(?P<path>.*): n=(?P<n>\d+) acc=(?P<acc>\S+) "
                     r"cost=(?P<cost>\S+)λ offload_frac=(?P<frac>\S+) "
                     r"offloaded=(?P<mb>\S+)MB \(\S+ samples/s\)$")
SCHEDULER = re.compile(r"^scheduler: served=(\d+) shed=(\d+) (\{.*\}) ")


def _decisions(out: str):
    """The printed lines with the wall-clock numbers taken out."""
    lines = []
    for line in out.splitlines():
        if line.startswith("wrote serving config"):
            continue
        m = SUMMARY.match(line) or SCHEDULER.match(line)
        lines.append(m.groups() if m else line)
    return lines


MODES = {
    "bucketed": ["--batch-size", "16"],
    "scan": ["--batch-size", "16", "--edge-mode", "scan"],
    "side-info": ["--batch-size", "16", "--side-info"],
    "fused-exit": ["--batch-size", "16", "--fused-exit"],
    "mesh": ["--batch-size", "16", "--mesh", "--replicas", "1"],
    "fifo": ["--batch-size", "16", "--scheduler", "fifo"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_classify_main_matches_reference(mode, testbeds, monkeypatch,
                                         capsys, tmp_path):
    ref, port = testbeds
    monkeypatch.setattr(jserve, "build_testbed", lambda **kw: ref)
    monkeypatch.setattr(tserve, "build_testbed", lambda **kw: port)
    argv = ["--samples", str(SAMPLES), "--layers", str(LAYERS)] + MODES[mode]
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv, "--dump-config",
                                      str(tmp_path / "ref.json")])
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(argv + ["--dump-config", str(tmp_path / "port.json"),
                        "--device", "cpu"])
    got = capsys.readouterr().out
    assert _decisions(got) == _decisions(want), (got, want)
    summary = [ln for ln in _decisions(got) if isinstance(ln, tuple)]
    assert summary and summary[0][1] == str(SAMPLES)
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_run_decode_matches_reference(arch, monkeypatch, capsys):
    cfg = dataclasses.replace(jserve.get_smoke_config(arch), dtype="float32")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None: tp)
    args = types.SimpleNamespace(decode_arch=arch, prompt_len=5, offload=5.0,
                                 conf_backend="ref", device="cpu")
    scfg = dict(workload="decode", max_new_tokens=4, batch_size=4,
                max_samples=10)
    jserve.run_decode(args, JConfig(**scfg))
    want = capsys.readouterr().out
    tserve.run_decode(args, ServingConfig(**scfg))
    got = capsys.readouterr().out

    def fields(out):
        alpha, summary = out.splitlines()
        return alpha, re.sub(r"\(\S+ tok/s\) ", "", summary)

    assert fields(got) == fields(want), (got, want)
    assert "tokens=40 " in got


# ------------------------------------------------------------ driver mode

def _cli(*flags):
    """``python -m repro_torch.launch.serve FLAGS --device cpu`` in a
    subprocess (driver mode re-runs ``sys.argv`` in every worker)."""
    penv = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *flags,
         "--device", "cpu"], env=penv, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _finish(proc, timeout=150):
    """The driver's output; on a timeout its session (the driver and its
    workers) is killed and the test fails."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out, err


def test_driver_mode_clusters_on_the_cpu():
    """A 2-process lockstep cluster equals the 1-process distributed run
    of the same flags in every decision field (the two clusters run at
    once)."""
    flags = ["--distributed", "--batch-size", "8", "--samples", "41",
             "--layers", "2", "--steps", "5", "--overlap-depth", "2"]
    procs = {"pair": _cli(*flags, "--num-processes", "2"),
             "one": _cli(*flags, "--num-processes", "1")}
    outs = {name: _finish(p) for name, p in procs.items()}
    pair, one = (_decisions(outs[k][0]) for k in ("pair", "one"))
    assert pair[0].startswith("trained multi-exit testbed")
    (path2, *rest2), = [ln for ln in pair if isinstance(ln, tuple)]
    (path1, *rest1), = [ln for ln in one if isinstance(ln, tuple)]
    assert path2 == "SplitEE (distributed H=2 R=1/host B=8 overlap=K=2)"
    assert path1 == "SplitEE (distributed H=1 R=1/host B=8 overlap=K=2)"
    assert rest2 == rest1 and rest2[0] == "41"
    assert [ln for ln in pair if not isinstance(ln, tuple)] == \
        [ln for ln in one if not isinstance(ln, tuple)]


def test_main_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this process has CUDA; the guard is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--samples", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--workload", "decode", "--max-new-tokens", "2"])
