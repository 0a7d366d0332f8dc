"""Deterministic fault injection for the distributed serving runtime.

Real fleets fail in messy, timing-dependent ways; tests and benchmarks
need the same failures to happen at exactly the same point in the
serving schedule every run. This module provides that: a *fault plan* —
parsed from a compact spec string (usually the ``SPLITEE_FAULTS`` env
var, so subprocess workers inherit it) — mapping (host, serving round)
to an action the exchange executes at the round boundary:

  kill:host=H,epoch=E          the worker dies (`os._exit`, exit code
                               43 — no cleanup, the closest a Python
                               process gets to SIGKILL-at-a-chosen-line)
                               at the start of gather round E
  drop_kv:host=H,epoch=E       the worker's round-E payload write is
                               silently dropped and its heartbeats stop
                               reaching the store (a partition between
                               the host and the KV store: the process
                               is alive but invisible — it is declared
                               dead, reads the verdict excluding it,
                               and gets fenced)
  freeze:host=H,epoch=E,secs=S the worker stalls for S seconds with its
                               HEARTBEAT PAUSED (a wedged process: if S
                               exceeds the heartbeat timeout it is
                               declared dead and fenced on wake-up)
  sleep:host=H,epoch=E,secs=S  the worker stalls for S seconds with its
                               heartbeat RUNNING (slow compute: must
                               NOT be declared dead — the detector's
                               slow-vs-dead discrimination)
  random_kill:seed=S,hosts=N,epochs=M
                               seed-driven kill: host drawn uniformly
                               from 1..N-1 (sparing the initial
                               arbiter), epoch from 1..M-1, via
                               `np.random.default_rng(S)`

``host=*`` / ``epoch=*`` match every host / every round (pacing sleeps
in tests use this). Actions are separated by ``;``. "Epoch" here is the
exchange's gather round index — one gather per micro-batch, so epoch e
is the fold boundary of micro-batch e.

The injector is consulted by `ResilientExchange` only — the strict
lockstep `CoordinatorExchange` has no failure handling to exercise.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np

# exit code of an injected kill — distinguishable from crashes (1) and
# real signals (negative returncodes) in supervisor reports and tests
FAULT_KILL_EXIT = 43

ENV_FAULTS = "SPLITEE_FAULTS"

_ANY = -1  # wildcard host/epoch


@dataclasses.dataclass(frozen=True)
class FaultAction:
    kind: str              # kill | drop_kv | freeze | sleep
    host: int              # _ANY matches every host
    epoch: int             # gather round; _ANY matches every round
    seconds: float = 0.0

    def matches(self, host: int, epoch: int) -> bool:
        return (self.host in (_ANY, host)
                and self.epoch in (_ANY, epoch))


def _parse_int(val: str) -> int:
    return _ANY if val == "*" else int(val)


def parse_fault_plan(spec: str) -> List[FaultAction]:
    """Parse a fault-plan spec string into concrete actions.

    `random_kill` entries expand deterministically from their seed, so a
    spec string fully determines the plan — tests and benchmarks can
    reproduce a "random" failure bit-for-bit by pinning the spec.
    """
    actions: List[FaultAction] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, arg_str = part.partition(":")
        kind = kind.strip()
        args = {}
        for kv in arg_str.split(","):
            kv = kv.strip()
            if kv:
                k, _, v = kv.partition("=")
                args[k.strip()] = v.strip()
        if kind == "random_kill":
            rng = np.random.default_rng(int(args["seed"]))
            hosts = int(args["hosts"])
            epochs = int(args["epochs"])
            if hosts < 2 or epochs < 2:
                raise ValueError(f"random_kill needs hosts>=2 and "
                                 f"epochs>=2, got {part!r}")
            actions.append(FaultAction(
                "kill", host=int(rng.integers(1, hosts)),
                epoch=int(rng.integers(1, epochs))))
        elif kind in ("kill", "drop_kv", "freeze", "sleep"):
            actions.append(FaultAction(
                kind, host=_parse_int(args["host"]),
                epoch=_parse_int(args["epoch"]),
                seconds=float(args.get("secs", 0.0))))
        else:
            raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
    return actions


class FaultInjector:
    """Executes a host's slice of a fault plan at exchange round entry.

    Hooks (called by `ResilientExchange`):
      before_round(exchange, r)  sleeps/freezes/kills per the plan
      drop_write(r)              True when the round-r payload write
                                 must be silently dropped
    """

    def __init__(self, actions: List[FaultAction], host_id: int):
        self.host_id = host_id
        self.actions = [a for a in actions
                        if a.host in (_ANY, host_id)]

    @classmethod
    def from_env(cls, host_id: int) -> Optional["FaultInjector"]:
        spec = os.environ.get(ENV_FAULTS)
        if not spec:
            return None
        inj = cls(parse_fault_plan(spec), host_id)
        return inj if inj.actions else None

    def before_round(self, exchange, r: int):
        for a in self.actions:
            if not a.matches(self.host_id, r):
                continue
            if a.kind == "kill":
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(FAULT_KILL_EXIT)
            elif a.kind == "sleep":
                time.sleep(a.seconds)
            elif a.kind == "freeze":
                exchange.pause_heartbeat()
                try:
                    time.sleep(a.seconds)
                finally:
                    exchange.resume_heartbeat()

    def drop_write(self, r: int) -> bool:
        return any(a.kind == "drop_kv" and a.matches(self.host_id, r)
                   for a in self.actions)
