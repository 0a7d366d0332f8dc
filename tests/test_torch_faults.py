"""The port's fault plans (serving/faults.py) against the reference's.

* `parse_fault_plan` gives the reference's actions over a list of specs
  (wildcards, several actions, ``random_kill`` draws from its seed), and
  the reference's errors on malformed ones;
* `FaultInjector` keeps the reference's slice of a plan per host, reads
  `SPLITEE_FAULTS` as the reference does, and executes it at round
  entry: ``sleep`` with the heartbeat running, ``freeze`` with it paused
  and resumed, ``drop_kv`` as a dropped write, ``kill`` as exit code 43
  (in a subprocess).
"""
import dataclasses
import os
import subprocess
import sys
import time

import pytest
import torch

from repro.serving import faults as jfaults
from repro_torch.serving import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread under the suite's parallel workers (see
    tests/test_torch_sharded.py); restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SPECS = [
    "",
    "kill:host=1,epoch=3",
    "kill:host=1,epoch=2;sleep:host=*,epoch=*,secs=0.8",
    " drop_kv:host=2,epoch=0 ; freeze:host=0,epoch=5,secs=3.5 ;",
    "sleep:host=*,epoch=4,secs=0.25;kill:host=3,epoch=*",
    "random_kill:seed=0,hosts=3,epochs=8",
    "random_kill:seed=7,hosts=4,epochs=16;sleep:host=*,epoch=*,secs=0.1",
] + [f"random_kill:seed={s},hosts={h},epochs={e}"
     for s in range(12) for h, e in ((2, 2), (3, 5), (8, 40))]


def _fields(actions):
    return [dataclasses.astuple(a) for a in actions]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_plan_matches_reference(spec):
    assert _fields(tfaults.parse_fault_plan(spec)) == \
        _fields(jfaults.parse_fault_plan(spec))


BAD_SPECS = ["explode:host=1,epoch=2", "random_kill:seed=1,hosts=1,epochs=5",
             "random_kill:seed=1,hosts=3,epochs=1", "kill:host=1",
             "sleep:host=x,epoch=1"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_plans_raise_as_reference(spec):
    errors = []
    for mod in (jfaults, tfaults):
        with pytest.raises(Exception) as err:
            mod.parse_fault_plan(spec)
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1]


def test_constants_match_reference():
    assert tfaults.FAULT_KILL_EXIT == jfaults.FAULT_KILL_EXIT == 43
    assert tfaults.ENV_FAULTS == jfaults.ENV_FAULTS == "SPLITEE_FAULTS"


@pytest.mark.parametrize("host", [0, 1, 2, 3])
def test_injector_slice_and_env_match_reference(host, monkeypatch):
    spec = ("kill:host=1,epoch=3;sleep:host=*,epoch=*,secs=0.5;"
            "drop_kv:host=2,epoch=4;random_kill:seed=3,hosts=4,epochs=9")
    got = tfaults.FaultInjector(tfaults.parse_fault_plan(spec), host)
    ref = jfaults.FaultInjector(jfaults.parse_fault_plan(spec), host)
    assert _fields(got.actions) == _fields(ref.actions)
    for r in range(10):
        assert got.drop_write(r) == ref.drop_write(r)
    monkeypatch.setenv("SPLITEE_FAULTS", spec)
    assert _fields(tfaults.FaultInjector.from_env(host).actions) == \
        _fields(jfaults.FaultInjector.from_env(host).actions)
    monkeypatch.setenv("SPLITEE_FAULTS", "kill:host=9,epoch=1")
    assert tfaults.FaultInjector.from_env(host) is None
    monkeypatch.delenv("SPLITEE_FAULTS")
    assert tfaults.FaultInjector.from_env(host) is None


class _Exchange:
    """Records the heartbeat calls an injector makes."""

    def __init__(self):
        self.calls = []

    def pause_heartbeat(self):
        self.calls.append(("pause", time.monotonic()))

    def resume_heartbeat(self):
        self.calls.append(("resume", time.monotonic()))


def test_sleep_and_freeze_at_round_entry():
    """``sleep`` stalls with the heartbeat untouched; ``freeze`` stalls
    between a pause and a resume; other rounds and hosts do nothing."""
    plan = tfaults.parse_fault_plan(
        "sleep:host=1,epoch=2,secs=0.2;freeze:host=1,epoch=3,secs=0.3;"
        "freeze:host=0,epoch=*,secs=5")
    inj, ex = tfaults.FaultInjector(plan, 1), _Exchange()
    for r, want in ((0, 0.0), (2, 0.2), (3, 0.3)):
        t0 = time.monotonic()
        inj.before_round(ex, r)
        took = time.monotonic() - t0
        assert want <= took < want + 0.5, (r, took)
    assert [c for c, _ in ex.calls] == ["pause", "resume"]
    assert ex.calls[1][1] - ex.calls[0][1] >= 0.3


def test_kill_exits_with_the_fault_code():
    code = ("import sys; sys.path.insert(0, 'src')\n"
            "from repro_torch.serving.faults import FaultInjector, "
            "parse_fault_plan\n"
            "inj = FaultInjector(parse_fault_plan('kill:host=2,epoch=1'), 2)\n"
            "inj.before_round(None, 0)\n"
            "print('round 0 ok', flush=True)\n"
            "inj.before_round(None, 1)\n"
            "print('not reached')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == tfaults.FAULT_KILL_EXIT, proc.stderr
    assert proc.stdout == "round 0 ok\n"
