"""Multi-process distributed edge/cloud serving — per-host streams, with the
bandit merged host-side at batch boundaries.

The sharded runtime (sharded.py) scales a micro-batch over the replicas
of ONE process's mesh. This module is the step to a deployable
multi-host shape: N processes (edge sites, or nodes of a cloud cluster)
each run the same deterministic serving schedule over their own
devices, and the controller is kept globally consistent without a single
device collective.

How one micro-batch flows, on every host simultaneously:

  1. **select** — every process draws the full batch's arms from its
     local `SplitEEController` mirror (`choose_splits` is deterministic,
     and the mirrors are bit-identical by induction — see step 4 — so
     all processes agree on every arm without communicating);
  2. **shard** — the batch is split into contiguous per-host slices
     (`_shard_sizes`, hosts in process-id order). A process runs
     `batched._edge_phase` + its `OffloadQueue` only on its own slice,
     over its own serving mesh (`make_serving_mesh` on the runtime's
     device), with the same depth-``K`` flush pipeline as the sharded
     runtime;
  3. **exchange** — at fold time each process packs its slice summary
     (`SplitEEController.prepare_shard_update` — pure, computed from the
     frozen state — plus its slice's predictions) and all-gathers the
     payloads through a key-value store (`CoordinatorExchange` over the
     cluster's ``torch.distributed.TCPStore``): host-side bytes, no
     process group, no device collective. Several processes
     may therefore share one card, each with its own CUDA context;
  4. **merge** — every process folds the identical gathered summaries
     with `SplitEEController.merge_cross_host`, which replays the
     sequential (q, n) arithmetic in host order then sample order. All
     mirrors therefore stay bit-identical, and the policy is invariant
     to the host count exactly as it is to the replica count.

Offload pipelining is inherited unchanged: ``overlap_depth=K`` keeps up
to K of a host's cloud flushes in flight behind later edge batches
(feedback delay <= (K+1)*B - 1 rounds, asserted at every fold).

Semantics: every process must be handed the SAME logical stream (same
seed/order) — the per-host stream is its contiguous slice of every
micro-batch. A 1-process run makes the sharded runtime's calls on the
same tensors, so it is bit-identical to it. An N-process run makes the
same decisions as the single-process run on the same stream wherever the
slices' confidences land on the same side of alpha: a slice's calls have
fewer rows than the whole batch's, so their floats may differ from the
single-process run's in the last bits.

Workers are fresh interpreters (`run_supervised_cluster` spawns ``python
-c`` programs with the SPLITEE_* cluster variables set; never ``fork``
after CUDA is up): a worker calls `init_distributed_from_env()` first,
which opens the cluster's TCPStore (process 0 serves it). CPU workers
serve with a runtime on ``device="cpu"``; workers on one card all use
``cuda:0``.

Fault tolerance (``fault_tolerant=True``): the lockstep
`CoordinatorExchange` is replaced by `ResilientExchange`, which runs the
same per-round all-gather over a pluggable KV transport
(serving/kvstore.py) with a liveness layer on top — every host's
heartbeat thread stamps a per-host key, gathers bound their wait on
missing payloads by watching those stamps, and the acting arbiter (the
lowest-id live host) publishes a per-round membership *verdict* every
host folds identically. A crashed worker is detected within the
heartbeat timeout, its un-gathered slice of the in-flight batch is
dropped (the only data loss), survivors re-slice subsequent
micro-batches over the reduced host set, and — because the merged
controller state is policy-complete — the run continues bit-identically
to a smaller cluster seeded with the merged state at the failure epoch:
failure changes who computes, never what the policy learns. A respawned
worker rejoins at an epoch boundary by downloading the merged state +
stream position from the KV store (`request_rejoin`).
"""
from __future__ import annotations

import atexit
import base64
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.controller import (ShardUpdate, SplitEEController,
                                         state_from_bytes, state_to_bytes)
from repro_torch.core.rewards import CostModel
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.serving.batched import OffloadQueue, _edge_phase, _offload_scale
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.kvstore import (CoordinatorKV, FileKV, KVKeyExists,
                                         KVTimeout, open_tcp_store)
from repro_torch.serving.sharded import (_BatchCtx, _check_lockstep,
                                         _drive_pipeline, _placement,
                                         _resolve_cloud,
                                         _serve_result, _shard_sizes)
from repro_torch.serving.simulator import EdgeCloudRuntime

# Cluster topology env vars understood by `init_distributed_from_env` /
# `ft_serving_context` (set for every worker by
# `run_distributed_subprocesses` / `run_supervised_cluster`); the same
# names as the reference's, so workers of either package read them.
ENV_COORDINATOR = "SPLITEE_COORDINATOR"
ENV_NUM_PROCESSES = "SPLITEE_NUM_PROCESSES"
ENV_PROCESS_ID = "SPLITEE_PROCESS_ID"
# coordinator-free clusters: root directory of the FileKV exchange
ENV_KV_DIR = "SPLITEE_KV_DIR"
# set by the supervisor on respawned workers: take the rejoin path
ENV_REJOIN = "SPLITEE_REJOIN"
# liveness file stamped by `start_worker_heartbeat` for the supervisor's
# hung-worker watchdog
ENV_WORKER_HEARTBEAT = "SPLITEE_WORKER_HEARTBEAT"

# how long process 0, which serves the cluster's store, waits at exit for
# the other processes to finish with it
SHUTDOWN_TIMEOUT_S = 60.0
_SHUTDOWN_KEY = "splitee/shutdown"


_WORKER_HB_STARTED = [False]


def start_worker_heartbeat(interval: float = 0.5) -> bool:
    """Stamp the supervisor's liveness file from a daemon thread.

    When `ENV_WORKER_HEARTBEAT` is set (by `run_supervised_cluster` with
    a watchdog), the file's mtime is the supervisor's only way to tell a
    *hung* worker (SIGSTOP, deadlock — process alive, stamps frozen)
    from a slow one; a worker that never starts stamping is covered by
    the supervisor's startup grace. Idempotent; returns True when the
    thread was started.
    """
    path = os.environ.get(ENV_WORKER_HEARTBEAT)
    if not path or _WORKER_HB_STARTED[0]:
        return False
    _WORKER_HB_STARTED[0] = True

    def loop():
        i = 0
        while True:
            i += 1
            try:
                with open(path, "w") as f:
                    f.write(str(i))
            except OSError:
                pass
            time.sleep(interval)

    threading.Thread(target=loop, daemon=True).start()
    return True


@dataclasses.dataclass
class _Cluster:
    """The process's membership of a store-backed cluster."""
    store: Any                     # torch.distributed.TCPStore
    host_id: int
    num_hosts: int


# set once by `init_distributed_from_env` (the process-wide counterpart
# of the reference's jax.distributed client)
_CLUSTER: List[_Cluster] = []


def _cluster_store():
    """The TCPStore `init_distributed_from_env` opened, or None."""
    return _CLUSTER[0].store if _CLUSTER else None


def init_distributed_from_env() -> bool:
    """Join the store-backed cluster the SPLITEE_* env vars describe.

    Opens a ``torch.distributed.TCPStore`` at `ENV_COORDINATOR`
    (``host:port``); process 0 serves it, as the reference's coordinator
    lives in process 0. No process group is initialized: the exchange
    needs only the store. Process 0 waits at exit (at most
    `SHUTDOWN_TIMEOUT_S`) until every process has reached its own exit,
    so no store operation outlives the server. Call first thing in a
    worker. Returns True when a multi-process cluster was joined, False
    when the env vars are absent (plain single-process run, or a
    coordinator-free FileKV cluster — see `ft_serving_context`).
    """
    start_worker_heartbeat()
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    if _CLUSTER:
        raise RuntimeError("init_distributed_from_env() was already called "
                           "in this process")
    num = int(os.environ[ENV_NUM_PROCESSES])
    pid = int(os.environ[ENV_PROCESS_ID])
    host, _, port = coord.rpartition(":")
    store = open_tcp_store(host, int(port), is_master=pid == 0)
    _CLUSTER.append(_Cluster(store, pid, num))
    atexit.register(_shutdown_barrier)
    return num > 1


def _shutdown_barrier():
    """At exit: every process checks in; process 0 (the store's server)
    waits for all of them, bounded, before its exit closes the store."""
    c = _CLUSTER[0]
    if c.host_id != 0:
        c.store.add(_SHUTDOWN_KEY, 1)     # check in; the last store op
        return
    try:
        CoordinatorKV(c.store).barrier(_SHUTDOWN_KEY, c.num_hosts,
                                       SHUTDOWN_TIMEOUT_S)
    except KVTimeout:
        pass                       # a crashed worker never checks in


def cluster_identity() -> Tuple[int, int]:
    """(host_id, num_hosts) for this process.

    The cluster `init_distributed_from_env` joined, if any; else a
    spawned worker's SPLITEE_* env vars (FileKV clusters never open a
    store); else a single process (0, 1).
    """
    if _CLUSTER:
        return _CLUSTER[0].host_id, _CLUSTER[0].num_hosts
    pid = os.environ.get(ENV_PROCESS_ID)
    if pid is not None and os.environ.get(ENV_COORDINATOR) is None:
        return int(pid), int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    return 0, 1


class LoopbackExchange:
    """Single-host stand-in: the gather of one host's payload is itself."""

    num_hosts = 1
    host_id = 0

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        return [payload]

    def close(self):
        pass


_EXCHANGE_EPOCH = [0]   # distinct KV namespace per exchange instance


class CoordinatorExchange:
    """Host-side all-gather over the cluster's KV store.

    The store (already running: it bootstrapped the cluster) carries the
    O(B*L) bandit summaries — no device collective, so CPU-only processes,
    processes sharing a card and heterogeneous edge hosts work the same.
    Rounds are strictly ordered: every host calls ``allgather_bytes`` the
    same number of times in the same batch order (the serving schedule is
    deterministic), and each call blocks until all hosts' round-r
    payloads are present.

    Keys are garbage-collected one round behind: completing the gather of
    round r proves every host has written round r, hence finished reading
    round r-1, so a host's own r-1 key is safely deletable. The final
    round's keys are removed by ``close()`` behind a store barrier.

    Each instance claims a fresh epoch namespace (all hosts construct
    their exchanges in the same deterministic order, so epochs agree) —
    back-to-back serving passes on one cluster never collide on keys.

    By default the transport, identity and epoch come from the cluster
    `init_distributed_from_env` joined; ``kv``, ``host_id``,
    ``num_hosts`` and ``epoch`` set them explicitly (hosts as threads of
    one process, each with its own store client).
    """

    def __init__(self, *, prefix: str = "splitee/xhost",
                 timeout_ms: int = 300_000,
                 kv: Optional[CoordinatorKV] = None,
                 host_id: Optional[int] = None,
                 num_hosts: Optional[int] = None,
                 epoch: Optional[int] = None):
        if kv is None:
            if not _CLUSTER:
                raise RuntimeError(
                    "no cluster store is open — call "
                    "init_distributed_from_env() before serving "
                    "distributed")
            kv = CoordinatorKV(_CLUSTER[0].store)
        self._kv = kv
        if epoch is None:
            epoch = _EXCHANGE_EPOCH[0]
            _EXCHANGE_EPOCH[0] += 1
        self._prefix = f"{prefix}/{epoch}"
        self._timeout_ms = timeout_ms
        self._round = 0
        ident = cluster_identity()
        self.host_id = ident[0] if host_id is None else host_id
        self.num_hosts = ident[1] if num_hosts is None else num_hosts

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        r = self._round
        self._round += 1
        self._kv.set(f"{self._prefix}/{r}/{self.host_id}", payload)
        out = [payload if h == self.host_id else
               self._kv.get(f"{self._prefix}/{r}/{h}",
                            self._timeout_ms / 1000.0)
               for h in range(self.num_hosts)]
        if r > 0:
            self._kv.delete(f"{self._prefix}/{r - 1}/{self.host_id}")
        return out

    def close(self):
        """Delete this epoch's final-round keys (barrier: every host must
        have read them before anyone deletes)."""
        if self._round == 0:
            return
        self._kv.barrier(f"{self._prefix}/close", self.num_hosts,
                         self._timeout_ms / 1000.0)
        self._kv.delete(f"{self._prefix}/{self._round - 1}/{self.host_id}")


class FencedHostError(RuntimeError):
    """This host was removed from the membership by a round verdict (its
    update never reached the store in time) and must stop serving; a
    supervisor may respawn it to rejoin at a later epoch boundary."""


@dataclasses.dataclass
class GatherResult:
    """One fault-tolerant gather round's outcome."""
    round: int
    payloads: List[bytes]      # in ``fold`` order
    fold: List[int]            # hosts whose round payloads fold (sorted)
    removed: List[int]         # hosts declared dead this round
    joined: List[int]          # hosts admitted this round (active later)
    members: List[int]         # active membership for the NEXT round


@dataclasses.dataclass
class RejoinAck:
    """What a rejoining host downloads from the KV store: the merged
    controller state (policy-complete), the stream position, and its
    first gather round."""
    state: Dict[str, np.ndarray]
    selected: int
    first_round: int
    members: List[int]


class _HeartbeatMonitor:
    """Tracks per-host heartbeat stamps; a host is stale once its stamp
    has not advanced for the exchange's heartbeat timeout (the baseline
    is the first observation, so detection takes at most one timeout).

    A host with no stamp at all has not started its heartbeat yet: it may
    still be starting up (importing, building its model) on a loaded
    machine, which a frozen stamp cannot be told apart from. It is stale
    only once it has shown no stamp for STARTUP_TIMEOUT, so a host that
    dies before its first stamp is declared dead within STARTUP_TIMEOUT
    (plus one poll) of the first look at it. (The reference's monitor
    takes a missing stamp as a frozen one and fences a host that starts
    later than one heartbeat timeout.)"""

    def __init__(self, exchange: "ResilientExchange"):
        self._ex = exchange
        self._seen: Dict[int, Tuple[Optional[bytes], float]] = {}

    def stale(self, h: int) -> bool:
        stamp = self._ex.kv.try_get(self._ex._hbkey(h))
        now = time.monotonic()
        prev = self._seen.get(h)
        if prev is None or prev[0] != stamp:
            self._seen[h] = (stamp, now)
            return False
        limit = (self._ex.heartbeat_timeout if stamp is not None
                 else STARTUP_TIMEOUT)
        return now - prev[1] > limit


_FT_EPOCH = [0]   # distinct KV namespace per ResilientExchange instance
# seconds a host may show no heartbeat stamp at all before it is declared
# dead (`_HeartbeatMonitor`): room for a worker's start-up on a loaded host
STARTUP_TIMEOUT = 60.0


class ResilientExchange:
    """Fault-tolerant cross-host all-gather over a pluggable KV store.

    Same round structure as `CoordinatorExchange` — every active host
    writes its round-r payload, reads everyone else's, rounds strictly
    ordered — plus a liveness layer that keeps the cluster moving when a
    host dies:

    * **heartbeats** — each host's daemon thread stamps a per-host key
      every ``heartbeat_interval`` seconds, *independently of compute
      progress*, so a slow host (stamps advancing) is distinguishable
      from a dead one (stamps frozen).
    * **bounded gather + verdict** — the acting arbiter (lowest-id live
      host) collects round-r payloads, waiting on a missing host only
      while its heartbeat advances; once the heartbeat has been stale
      for ``heartbeat_timeout`` (a host that has not stamped yet: for
      STARTUP_TIMEOUT) the host is declared dead. The arbiter
      publishes a round *verdict* (fold set + membership map) that every
      host applies identically, so all mirrors agree on exactly which
      shard summaries fold — the survivors' controller evolution stays
      bit-identical across the cluster. Verdict writes are
      first-writer-wins, giving arbiter failover: if the arbiter itself
      dies, the next-ranked live host observes its stale heartbeat,
      decides, and publishes.
    * **rebuild** — hosts removed by a verdict stop being waited on and
      stop receiving batch slices; survivors re-slice subsequent
      micro-batches over the reduced membership. A host whose payload
      was lost but which is still alive (drop-KV-write / partition)
      reads a verdict excluding it and raises `FencedHostError`.
    * **rejoin** — a respawned host writes a rejoin request; the arbiter
      admits it with ``active_from = r + pipeline_depth + 1`` (so
      in-flight overlapped batches are unaffected) and, after folding
      round ``active_from - 1``, acks with the merged controller state
      and stream position (`post_fold`). The joiner restores, skips the
      consumed samples, and serves from its first active round — from
      which point its mirror is bit-identical to the survivors'.

    ``injector`` (serving/faults.py) is the deterministic fault hook
    used by tests.
    """

    fault_tolerant = True

    def __init__(self, kv, *, host_id: int, num_hosts: int,
                 heartbeat_timeout: float = 5.0,
                 heartbeat_interval: float = 0.25,
                 poll_interval: float = 0.05,
                 verdict_timeout: float = 600.0,
                 pipeline_depth: int = 0,
                 prefix: str = "splitee/ft",
                 rejoin: bool = False, injector=None,
                 epoch: Optional[int] = None):
        self.kv = kv
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_interval = heartbeat_interval
        self.poll_interval = poll_interval
        self.verdict_timeout = verdict_timeout
        self.pipeline_depth = pipeline_depth
        self._base = prefix
        self._injector = injector
        self.reconfigurations: List[Dict[str, Any]] = []
        self._pending_acks: Dict[int, int] = {}   # joiner -> ack-due round
        self._fenced = False
        self._round = 0
        self._hb_stop = threading.Event()
        self._hb_pause = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if rejoin:
            # namespace + membership adopted from the rejoin ack
            self._ns: Optional[str] = None
            self._active: Dict[int, int] = {}
        else:
            if epoch is None:
                # per-process counter: all hosts construct exchanges in
                # the same deterministic order, so epochs agree across
                # processes (in-process multi-host tests pass `epoch`)
                epoch = _FT_EPOCH[0]
                _FT_EPOCH[0] += 1
            self._ns = f"{prefix}/{epoch}"
            self._active = {h: 0 for h in range(num_hosts)}
        # liveness is host-scoped, not namespace-scoped: stamping starts
        # immediately even on the rejoin path, so a rejoiner is visible
        # to the arbiter from the moment it asks to join
        self._start_heartbeat()

    # ------------------------------------------------------------- keys
    def _pkey(self, r: int, h: int) -> str:
        return f"{self._ns}/round/{r}/{h}"

    def _vkey(self, r: int) -> str:
        return f"{self._ns}/verdict/{r}"

    def _hbkey(self, h: int) -> str:
        # namespace-scoped: heartbeats assert "serving this pass", not
        # "process exists" — a dead worker's respawned incarnation must
        # NOT mask the death while it waits for admission
        return f"{self._ns}/hb/{h}"

    def _rejoin_key(self, h: int) -> str:
        return f"{self._base}/rejoin/{h}"

    def _rejoin_flag(self) -> str:
        # one probe per round tells the arbiter whether any rejoin
        # requests exist at all (per-host probes are gated on it)
        return f"{self._base}/rejoin_flag"

    def _fenced_key(self, h: int) -> str:
        # durable removal marker: verdicts are GC'd one round behind,
        # but a falsely-removed host may wake arbitrarily late — it
        # must still be able to learn its fate
        return f"{self._ns}/fenced/{h}"

    def _ack_key(self, h: int) -> str:
        return f"{self._base}/ack/{h}"

    # ------------------------------------------------------- heartbeats
    def _start_heartbeat(self):
        def loop():
            i = 0
            while True:
                # rejoiners stamp nothing until the ack hands them the
                # namespace — an unadmitted host has no liveness to claim
                if self._ns is not None and not self._hb_pause.is_set():
                    i += 1
                    try:
                        self.kv.set(self._hbkey(self.host_id),
                                    str(i).encode(), overwrite=True)
                    except Exception:
                        # a transport hiccup costs one stamp; a lasting
                        # one is what the peers' detector is for
                        pass
                if self._hb_stop.wait(self.heartbeat_interval):
                    return
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def pause_heartbeat(self):
        """Fault-injection hook: simulate a wedged process."""
        self._hb_pause.set()

    def resume_heartbeat(self):
        self._hb_pause.clear()

    # ------------------------------------------------------- membership
    def members_for(self, rnd: int) -> List[int]:
        """Hosts that own a slice of (and gather for) round ``rnd``."""
        return sorted(h for h, a in self._active.items() if a <= rnd)

    @property
    def members(self) -> List[int]:
        return self.members_for(self._round)

    @property
    def next_round(self) -> int:
        return self._round

    # ----------------------------------------------------------- gather
    def gather(self, payload: bytes) -> GatherResult:
        """One fault-tolerant all-gather round for this host."""
        if self._fenced:
            raise FencedHostError(f"host {self.host_id} is fenced")
        r = self._round
        if self._injector is not None:
            self._injector.before_round(self, r)
        drop = (self._injector is not None
                and self._injector.drop_write(r))
        if drop:
            # a dropped write models a store partition: heartbeats stop
            # reaching the store too, so the arbiter can detect it
            self.pause_heartbeat()
        else:
            self.kv.set(self._pkey(r, self.host_id), payload)
        verdict = self._obtain_verdict(r, my_write_ok=not drop)
        self._apply_verdict(r, verdict)
        if self.host_id not in self._active:
            self._fenced = True
            raise FencedHostError(
                f"host {self.host_id} fenced at round {r}: its update "
                f"never reached the store within the heartbeat timeout; "
                f"survivors continue without it")
        payloads = []
        for h in verdict["fold"]:
            if h == self.host_id:
                payloads.append(payload)
            else:
                payloads.append(self.kv.get(self._pkey(r, h),
                                            self.verdict_timeout))
        if r > 0:
            # GC one round behind: the round-r verdict proves every
            # fold host finished reading round r-1 (payloads AND
            # verdict; removed hosts learn their fate from the durable
            # fenced marker instead)
            self.kv.delete(self._pkey(r - 1, self.host_id))
            self.kv.delete(self._vkey(r - 1))
        self._round = r + 1
        return GatherResult(round=r, payloads=payloads,
                            fold=[int(h) for h in verdict["fold"]],
                            removed=[int(h) for h in verdict["removed"]],
                            joined=[int(h) for h in verdict["joined"]],
                            members=self.members_for(r + 1))

    def _obtain_verdict(self, r: int, my_write_ok: bool) -> Dict[str, Any]:
        """Wait for (or produce) round r's membership verdict.

        Rank k in the live candidate order may decide and publish only
        once every lower-ranked candidate's heartbeat is stale — rank 0
        (the arbiter) decides immediately. First verdict write wins;
        everyone folds the winner's.

        The wait is LIVENESS-bounded, not wall-clock-bounded: a verdict
        may legitimately be arbitrarily late (the arbiter is waiting on
        a slow-but-alive host, which must not be removed), so the
        ``verdict_timeout`` clock restarts whenever any potential
        decider's heartbeat advances and only expires after that long
        with zero decider liveness. A fenced marker for this host ends
        the wait immediately (its verdict may already be GC'd).
        """
        lower = [h for h in self.members_for(r) if h < self.host_id]
        mon = _HeartbeatMonitor(self)
        stamps: Dict[int, Optional[bytes]] = {}
        deadline = time.monotonic() + self.verdict_timeout
        while True:
            raw = self.kv.try_get(self._vkey(r))
            if raw is not None:
                return json.loads(raw.decode())
            marker = self.kv.try_get(self._fenced_key(self.host_id))
            if (marker is not None and int(marker)
                    >= self._active.get(self.host_id, 0)):
                # a marker from before this incarnation's admission is
                # stale; one at/after it means the survivors removed us
                self._fenced = True
                raise FencedHostError(
                    f"host {self.host_id} was fenced before round {r}'s "
                    f"verdict (removed by the survivors)")
            if all(mon.stale(h) for h in lower):
                verdict = self._decide(r, my_write_ok, mon)
                try:
                    self.kv.set(self._vkey(r),
                                json.dumps(verdict).encode())
                except KVKeyExists:
                    continue          # lost the race; fold the winner's
                return verdict
            for h in lower:
                stamp = self.kv.try_get(self._hbkey(h))
                if stamps.get(h, b"") != stamp:
                    stamps[h] = stamp
                    deadline = time.monotonic() + self.verdict_timeout
            if time.monotonic() > deadline:
                raise KVTimeout(f"no verdict for round {r} after "
                                f"{self.verdict_timeout}s without any "
                                f"decider liveness")
            time.sleep(self.poll_interval)

    def _decide(self, r: int, my_write_ok: bool,
                mon: _HeartbeatMonitor) -> Dict[str, Any]:
        """Acting-arbiter path: collect round-r payloads with a
        heartbeat-bounded wait, declare frozen hosts dead, admit
        pending rejoiners."""
        t0 = time.monotonic()
        fold = [self.host_id] if my_write_ok else []
        waiting = set(h for h in self.members_for(r)
                      if h != self.host_id)
        dead: set = set() if my_write_ok else {self.host_id}
        while waiting:
            for h in sorted(waiting):
                if self.kv.try_get(self._pkey(r, h)) is not None:
                    fold.append(h)
                    waiting.discard(h)
                elif mon.stale(h):
                    dead.add(h)
                    waiting.discard(h)
            if waiting:
                time.sleep(self.poll_interval)
        active = {h: a for h, a in self._active.items() if h not in dead}
        joined = []
        if self.kv.try_get(self._rejoin_flag()) is not None:
            for h in range(self.num_hosts):
                if (h not in active
                        and self.kv.try_get(self._rejoin_key(h))
                        is not None):
                    # admitted past any in-flight overlapped batches
                    active[h] = r + self.pipeline_depth + 1
                    joined.append(h)
        return {"round": r, "fold": sorted(int(h) for h in fold),
                "active": {str(h): int(a) for h, a in active.items()},
                "removed": sorted(int(h) for h in dead),
                "joined": sorted(int(h) for h in joined),
                # to the millisecond: compare it at that resolution (a
                # detection within 0.5 ms past a timeout reads as it)
                "detect_s": (round(time.monotonic() - t0, 3)
                             if dead else 0.0)}

    def _apply_verdict(self, r: int, verdict: Dict[str, Any]):
        self._active = {int(h): int(a)
                        for h, a in verdict["active"].items()}
        removed = [int(h) for h in verdict["removed"]]
        joined = [int(h) for h in verdict["joined"]]
        if removed or joined:
            self.reconfigurations.append({
                "round": r, "removed": removed, "joined": joined,
                "members_after": self.members_for(r + 1),
                "detect_s": float(verdict.get("detect_s", 0.0))})
        for h in removed:
            self._pending_acks.pop(h, None)
            # durable removal marker (idempotent; every host writes the
            # same round) — a falsely-removed host waking after its
            # verdict was GC'd still learns it was fenced. The marker
            # carries the removal round so a later re-admitted
            # incarnation (active_from > r) knows to ignore it.
            self.kv.set(self._fenced_key(h), str(r).encode(),
                        overwrite=True)
            # the dead host never GC'd its previous-round key
            self.kv.delete(self._pkey(r - 1, h))
        # joins AFTER removals: a host killed and respawned fast enough
        # can be removed and re-admitted by the same verdict — its
        # pending ack must survive
        for h in joined:
            self._pending_acks[h] = self._active[h] - 1

    # ----------------------------------------------------------- rejoin
    def post_fold(self, state_blob: bytes, selected: int):
        """Serving-loop hook, called after each fold with the merged
        controller state and the stream position. The acting arbiter
        acks rejoiners whose admission round has just been folded."""
        r = self._round - 1
        due = sorted(h for h, ar in self._pending_acks.items() if ar <= r)
        if not due:
            return
        if self.host_id == min(self.members_for(r)):
            for h in due:
                ack = {"state_b64":
                       base64.b64encode(state_blob).decode(),
                       "selected": int(selected),
                       "first_round": int(self._pending_acks[h]) + 1,
                       "ns": self._ns,
                       "active": {str(k): int(a)
                                  for k, a in self._active.items()}}
                self.kv.set(self._ack_key(h), json.dumps(ack).encode(),
                            overwrite=True)
                self.kv.delete(self._rejoin_key(h))
            # a joiner still waiting re-asserts the flag within a second
            self.kv.delete(self._rejoin_flag())
        for h in due:
            self._pending_acks.pop(h, None)

    def request_rejoin(self, timeout_s: float = 600.0) -> RejoinAck:
        """Rejoin path for a respawned host (constructed with
        ``rejoin=True``): request admission, download the merged state
        and stream position, adopt the cluster's namespace/membership.
        The caller restores the controller from ``ack.state``, skips
        ``ack.selected`` stream samples, and serves; its first gather is
        ``ack.first_round``. Requires the stream to still have batches
        left — a cluster that finishes first never acks."""
        deadline = time.monotonic() + timeout_s
        while True:
            # re-asserted every poll: the flag is consumed whenever the
            # arbiter acks a batch of joiners, and a concurrent joiner
            # must not be left flagless
            self.kv.set(self._rejoin_key(self.host_id), b"1",
                        overwrite=True)
            self.kv.set(self._rejoin_flag(), b"1", overwrite=True)
            try:
                raw = self.kv.get(self._ack_key(self.host_id),
                                  min(1.0, timeout_s))
                break
            except KVTimeout:
                if time.monotonic() > deadline:
                    raise
        ack = json.loads(raw.decode())
        self._ns = ack["ns"]
        self._active = {int(h): int(a)
                        for h, a in ack["active"].items()}
        self._round = int(ack["first_round"])
        self.kv.delete(self._ack_key(self.host_id))
        state = state_from_bytes(base64.b64decode(ack["state_b64"]))
        return RejoinAck(state=state, selected=int(ack["selected"]),
                         first_round=self._round,
                         members=self.members_for(self._round))

    # ------------------------------------------------------------ close
    def close(self):
        """Bounded-barrier close over the final membership, then GC.

        Unlike `CoordinatorExchange.close`, a missing participant (the
        cluster just survived a failure, or a host crashed between the
        last fold and close) times out cleanly after a bounded wait
        instead of wedging the survivors.
        """
        try:
            if self._fenced or self._ns is None or self._round == 0:
                return
            self.kv.set(f"{self._ns}/close/{self.host_id}", b"1",
                        overwrite=True)
            try:
                for h in self.members_for(self._round):
                    if h != self.host_id:
                        self.kv.get(f"{self._ns}/close/{h}",
                                    max(2 * self.heartbeat_timeout, 5.0))
            except KVTimeout:
                pass
            self.kv.delete(self._pkey(self._round - 1, self.host_id))
            self.kv.delete(self._vkey(self._round - 1))
            self.kv.delete(self._hbkey(self.host_id))
        finally:
            self._hb_stop.set()


def default_kv():
    """The KV transport for this worker: FileKV when `ENV_KV_DIR` is set
    (coordinator-free cluster), else the cluster's TCPStore."""
    kv_dir = os.environ.get(ENV_KV_DIR)
    if kv_dir:
        return FileKV(kv_dir)
    return CoordinatorKV()


def make_resilient_exchange(*, heartbeat_timeout: float = 5.0,
                            heartbeat_interval: float = 0.25,
                            pipeline_depth: int = 0,
                            rejoin: Optional[bool] = None,
                            kv=None) -> ResilientExchange:
    """Build the fault-tolerant exchange for this worker from its
    environment (identity, transport, rejoin flag, fault plan)."""
    host_id, num_hosts = cluster_identity()
    if rejoin is None:
        rejoin = os.environ.get(ENV_REJOIN) == "1"
    return ResilientExchange(
        kv if kv is not None else default_kv(),
        host_id=host_id, num_hosts=num_hosts,
        heartbeat_timeout=heartbeat_timeout,
        heartbeat_interval=heartbeat_interval,
        pipeline_depth=pipeline_depth, rejoin=bool(rejoin),
        injector=FaultInjector.from_env(host_id))


def ft_serving_context(*, heartbeat_timeout: float = 5.0,
                       heartbeat_interval: float = 0.25,
                       pipeline_depth: int = 0):
    """Worker-side fault-tolerant setup: ``(exchange, init_state, skip)``.

    Fresh workers get ``(exchange, None, 0)``. Respawned workers
    (`ENV_REJOIN`) block on the rejoin ack and get the restored
    controller snapshot plus the number of already-consumed stream
    samples to skip (pass all three to `serve` with a distributed config:
    ``exchange=``, ``init_state=``, ``stream_offset=skip``).
    """
    start_worker_heartbeat()
    exchange = make_resilient_exchange(
        heartbeat_timeout=heartbeat_timeout,
        heartbeat_interval=heartbeat_interval,
        pipeline_depth=pipeline_depth)
    init_state, skip = None, 0
    if os.environ.get(ENV_REJOIN) == "1":
        ack = exchange.request_rejoin()
        init_state, skip = ack.state, ack.selected
    return exchange, init_state, skip


def _pack_host_update(shard: ShardUpdate, preds: np.ndarray) -> bytes:
    """One host's per-batch wire payload: shard summary + predictions
    (the reference's npz layout, so either package decodes the other's)."""
    buf = io.BytesIO()
    np.savez(buf, arms=shard.arms, rewards=shard.rewards,
             exited=shard.exited, costs=shard.costs,
             offload_bytes=shard.offload_bytes,
             preds=np.asarray(preds, np.int64))
    return buf.getvalue()


def _unpack_host_update(raw: bytes) -> Tuple[ShardUpdate, np.ndarray]:
    z = np.load(io.BytesIO(raw))
    shard = ShardUpdate(arms=z["arms"], rewards=z["rewards"],
                        exited=z["exited"], costs=z["costs"],
                        offload_bytes=z["offload_bytes"])
    return shard, z["preds"]


def _serve_stream_distributed(runtime: EdgeCloudRuntime, params, stream,
                              cost: CostModel, *, batch_size: int = 32,
                              replicas: int = 1,
                              mesh: Optional[ServingMesh] = None,
                              overlap: bool = True, overlap_depth: int = 1,
                              side_info: bool = False, beta: float = 1.0,
                              max_samples: int = 0,
                              labels_for_accounting: bool = True,
                              exchange=None, fault_tolerant: bool = False,
                              heartbeat_timeout: float = 5.0,
                              heartbeat_interval: float = 0.25,
                              init_state: Optional[Dict[str, Any]] = None,
                              stream_offset: int = 0,
                              record_states: bool = False,
                              controller_kwargs: Optional[Dict[str, Any]] = None,
                              codec=None,
                              ) -> Dict[str, Any]:
    """Serve a sample stream across all processes of a cluster.

    Same contract as `_serve_stream_sharded` — ``replicas`` is the
    PER-HOST replica count of the serving mesh, ``overlap``/
    ``overlap_depth`` the flush pipeline — with the batch additionally
    sliced across processes (the edge phase is the bucketed one). Must be
    called by EVERY process with the same logical stream and arguments;
    returns the same global result dict on each (plus a
    ``"distributed"`` section), since every process folds the identical
    gathered statistics.

    ``exchange``  cross-host transport. Defaults to `CoordinatorExchange`
                  in a multi-process cluster (`init_distributed_from_env`)
                  and `LoopbackExchange` in a single process — or a
                  `ResilientExchange` when ``fault_tolerant`` is set.
    ``fault_tolerant``  survive worker failure: heartbeat-bounded
                  gathers, per-round membership verdicts, and re-slicing
                  over the surviving hosts (see `ResilientExchange`).
                  The failure epoch's un-gathered slices are the only
                  loss (their preds are reported as -1 and excluded from
                  accuracy accounting); from the next epoch on the
                  controller evolves bit-identically to a smaller
                  cluster seeded with the merged state.
    ``heartbeat_timeout`` / ``heartbeat_interval``  liveness knobs for
                  the default fault-tolerant exchange.
    ``init_state``  controller snapshot (`SplitEEController.snapshot`)
                  to restore before serving — the rejoin path.
    ``stream_offset``  number of stream samples the caller already
                  skipped (rejoin): keeps the rejoin acks this host may
                  write as acting arbiter in global stream coordinates.
    ``record_states``  append a post-fold snapshot of (q, n, t) plus a
                  wall-clock stamp per micro-batch under ``"states"`` —
                  the fault tests' bit-identity probe and the recovery
                  latency probe.
    """
    if overlap_depth < 1:
        raise ValueError(f"overlap_depth must be >= 1, got {overlap_depth}")
    if exchange is None:
        if fault_tolerant:
            exchange = make_resilient_exchange(
                heartbeat_timeout=heartbeat_timeout,
                heartbeat_interval=heartbeat_interval,
                pipeline_depth=overlap_depth if overlap else 0)
        else:
            exchange = (CoordinatorExchange()
                        if _CLUSTER and _CLUSTER[0].num_hosts > 1
                        else LoopbackExchange())
    ft = bool(getattr(exchange, "fault_tolerant", False))
    num_hosts = exchange.num_hosts
    host_id = exchange.host_id
    round_base = exchange.next_round if ft else 0

    # placement as in the sharded runtime: a call over the host's
    # replicas is one call per replica, one replica is one call; a
    # DeviceMesh runs the host's calls over its ranks (model parallelism)
    if mesh is None:
        mesh = make_serving_mesh(replicas, device=runtime.device)
    put, params, replicated = _placement(mesh, params, runtime)
    spmd = None if isinstance(mesh, ServingMesh) else mesh

    ctl = SplitEEController(cost, beta=beta, side_info=side_info,
                            **(controller_kwargs or {}))
    if init_state is not None:
        ctl.restore(init_state)
    queue = OffloadQueue(replicated, params, put=put, codec=codec)
    correct, preds = [], []
    states: List[Dict[str, Any]] = []
    n = 0
    overlapped = 0
    lost = 0
    next_round = [round_base]      # gather round of the next batch

    def process_batch(batch, start: int) -> _BatchCtx:
        """Select the full batch's arms; launch only my host's slice."""
        B = len(batch)
        arms = ctl.choose_splits(B)          # identical on every host
        # contiguous per-host slice of this batch — only my rows are
        # ever materialized (other hosts' samples stay untouched). In
        # fault-tolerant mode the slicing membership is per-round (it
        # shrinks on failure and grows on rejoin, identically on every
        # surviving host because membership only changes at verdicts).
        rnd = next_round[0]
        next_round[0] += 1
        members = (exchange.members_for(rnd) if ft
                   else list(range(num_hosts)))
        sizes = _shard_sizes(B, len(members))
        slot = members.index(host_id)
        lo = sum(sizes[:slot])
        hi = lo + sizes[slot]
        seq_len = int(np.asarray(batch[0]["tokens"]).shape[-1])
        if hi > lo:
            tokens = np.stack([np.asarray(s["tokens"])
                               for s in batch[lo:hi]])
        else:                        # batch smaller than the host count
            tokens = np.zeros((0, seq_len), np.int32)

        conf_paths, batch_preds = _edge_phase(
            replicated, params, tokens, arms[lo:hi], cost, queue,
            side_info=side_info, put=put, replicas=replicas)
        if spmd is not None:
            _check_lockstep(spmd, arms[lo:hi], conf_paths, cost)

        pending = queue.flush_async(
            min_rows=replicas, depth=overlap_depth if overlap else None)
        labels = [int(s["labels"]) if "labels" in s else None
                  for s in batch]
        return _BatchCtx(arms=arms[lo:hi], conf_paths=conf_paths,
                         batch_preds=batch_preds, labels=labels,
                         seq_len=seq_len, pending=pending, start=start,
                         members=members)

    def finalize(ctx: _BatchCtx):
        """Resolve the local flush, exchange summaries, fold all hosts."""
        nonlocal n, overlapped, lost
        B = len(ctx.labels)
        # my slice's cloud results (slots are slice-local indices)
        conf_Ls, obs = _resolve_cloud(ctx)
        # global stream position of the batch, agreed by every host (the
        # controller's own counter lags it whenever slices were lost)
        # (offload_scale is deterministic per codec+shape, so every host
        # prices its slice identically and the gathered folds agree)
        shard = ctl.prepare_shard_update(
            ctx.arms, ctx.conf_paths, conf_Ls, obs,
            round=stream_offset + ctx.start,
            offload_scale=_offload_scale(codec, runtime, ctx.seq_len))
        payload = _pack_host_update(
            shard, np.asarray(ctx.batch_preds, np.int64))
        if ft:
            # bounded gather + membership verdict; fold exactly the
            # verdict's shard set (identical on every surviving host)
            res = exchange.gather(payload)
            sizes = _shard_sizes(B, len(ctx.members))
            bounds, lo = {}, 0
            for h, size in zip(ctx.members, sizes):
                bounds[h] = (lo, lo + size)
                lo += size
            batch_preds = [-1] * B       # -1 = slice lost with its host
            per_host, kept = [], 0
            for h, raw in zip(res.fold, res.payloads):
                sh, host_preds = _unpack_host_update(raw)
                blo, bhi = bounds[h]
                assert len(host_preds) == bhi - blo
                batch_preds[blo:bhi] = [int(p) for p in host_preds]
                per_host.append([sh])
                kept += bhi - blo
            ctl.merge_cross_host(per_host)
            lost += B - kept
            # snapshot (not raw state): a windowed controller's ring must
            # ship with the KV state or a rejoiner could not evict
            exchange.post_fold(state_to_bytes(ctl.snapshot()),
                               stream_offset + ctx.start + B)
        else:
            # host-side all-gather, then the identical fold everywhere
            payloads = exchange.allgather_bytes(payload)
            unpacked = [_unpack_host_update(p) for p in payloads]
            ctl.merge_cross_host([[sh] for sh, _ in unpacked])
            batch_preds = [int(p) for _, host_preds in unpacked
                           for p in host_preds]
            assert len(batch_preds) == B
        preds.extend(batch_preds)
        if labels_for_accounting:
            for s in range(B):
                if ctx.labels[s] is not None and batch_preds[s] >= 0:
                    correct.append(int(batch_preds[s] == ctx.labels[s]))
        if record_states:
            snap = ctl.snapshot()
            snap["wall"] = time.monotonic()
            states.append(snap)
        if ctx.overlapped:
            overlapped += 1
        n += B

    try:
        batches = _drive_pipeline(
            stream, batch_size=batch_size, max_samples=max_samples,
            overlap=overlap, overlap_depth=overlap_depth,
            process_batch=process_batch, finalize=finalize)
    except BaseException:
        if ft:
            exchange.close()     # bounded cleanup; never wedges
        raise
    exchange.close()

    out = _serve_result(ctl, n=n, batch_size=batch_size, replicas=replicas,
                        preds=preds, correct=correct, overlap=overlap,
                        overlap_depth=overlap_depth, batches=batches,
                        overlapped=overlapped)
    out["distributed"] = {"num_hosts": num_hosts, "host_id": host_id,
                          "local_replicas": replicas}
    if ft:
        out["distributed"].update({
            "fault_tolerant": True,
            "members_final": exchange.members,
            "reconfigurations": exchange.reconfigurations,
            "lost_samples": lost,
        })
    if record_states:
        out["states"] = states
    return out


# --------------------------------------------------------------------------
# subprocess cluster driver (CPU hosts, processes sharing a card, tests)
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class WorkerIncident:
    """One supervisor observation: a worker died, hung, or was respawned."""
    kind: str                      # "exit" | "hung" | "respawn"
    slot: int                      # process id (cluster slot)
    returncode: Optional[int]
    at: float                      # seconds since cluster start


@dataclasses.dataclass
class ClusterReport:
    """What `run_supervised_cluster` observed and collected."""
    completed: List[subprocess.CompletedProcess]   # final incarnations
    incidents: List[WorkerIncident]
    respawns: Dict[int, int]                       # slot -> respawn count


class _Worker:
    """One worker incarnation: its process, pipe drain, and liveness."""

    def __init__(self, slot: int, proc: subprocess.Popen,
                 hb_path: Optional[str]):
        self.slot = slot
        self.proc = proc
        self.hb_path = hb_path
        self.spawned_wall = time.time()
        self.handled = False
        self.out: Optional[tuple] = None
        # all pipes drain concurrently — a worker stalled on a full pipe
        # would stop answering the exchange and wedge the whole cluster
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()

    def _drain(self):
        stdout, stderr = self.proc.communicate()
        self.out = (self.proc.returncode, stdout, stderr)

    def hb_stale(self, watchdog_timeout: float,
                 startup_grace: float) -> bool:
        try:
            mtime = os.path.getmtime(self.hb_path)
        except OSError:
            mtime = None
        now = time.time()
        if mtime is None:     # not stamping yet (still importing/booting)
            return now - self.spawned_wall > startup_grace
        return now - max(mtime, self.spawned_wall) > watchdog_timeout


def run_supervised_cluster(
        worker_src: str, num_processes: int, *,
        env: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = 900.0, cwd: Optional[str] = None,
        coordinator: bool = True, fail_fast: bool = True,
        watchdog_timeout: Optional[float] = None,
        startup_grace: float = 120.0,
        respawn: bool = False, max_respawns: int = 1,
        respawn_env: Optional[Dict[str, str]] = None) -> ClusterReport:
    """Spawn and supervise N python workers as one serving cluster.

    Each worker is a fresh ``sys.executable -c worker_src`` process (never
    a fork: a process that has started CUDA cannot fork a usable child)
    with the SPLITEE_* cluster vars set. The reference's forced host
    device count has no counterpart: a CPU worker serves on
    ``device="cpu"``, a card worker on ``cuda:0``.

    ``coordinator``       set `ENV_COORDINATOR` so workers open the
                          cluster's TCPStore in `init_distributed_from_env`
                          (process 0 serves it). False for FileKV
                          clusters — workers exchange through
                          `ENV_KV_DIR` (the caller puts it in ``env``).
    ``fail_fast``         kill the cluster as soon as any worker exits
                          non-zero (the survivors of a NON-fault-
                          tolerant run can never complete their
                          exchange). Turn off for fault-tolerant runs,
                          where survivors are expected to finish.
    ``watchdog_timeout``  liveness watchdog for HUNG workers: each
                          worker gets a heartbeat file (stamped by
                          `start_worker_heartbeat`); a running worker
                          whose stamps have frozen for this long is
                          killed (and then handled like any dead
                          worker). Without it a SIGSTOP'd or deadlocked
                          worker blocks the cluster until ``timeout`` —
                          exit-based fail-fast never fires for a
                          process that refuses to die.
    ``startup_grace``     how long a worker may take to produce its
                          first heartbeat stamp (imports, CUDA init)
                          before the watchdog treats it as hung.
    ``respawn``           supervisor mode: respawn a dead worker (up to
                          ``max_respawns`` times per slot) with
                          `ENV_REJOIN` set, so it takes the rejoin path
                          and re-enters the cluster at an epoch
                          boundary from the KV-store state.
    ``timeout``           per cluster, in seconds (None: no limit); on
                          expiry every worker is killed and
                          `subprocess.TimeoutExpired` raised.
    """
    port = _free_port() if coordinator else None
    hb_dir = (tempfile.mkdtemp(prefix="splitee-hb-")
              if watchdog_timeout is not None else None)
    t0 = time.monotonic()

    def spawn(slot: int, extra: Optional[Dict[str, str]] = None) -> _Worker:
        penv = dict(os.environ)
        penv.update(env or {})
        if coordinator:
            penv[ENV_COORDINATOR] = f"localhost:{port}"
        penv[ENV_NUM_PROCESSES] = str(num_processes)
        penv[ENV_PROCESS_ID] = str(slot)
        hb_path = None
        if hb_dir is not None:
            hb_path = os.path.join(hb_dir, f"hb-{slot}")
            # a dead incarnation's stale file must not cost the respawn
            # its startup grace (hb_stale's missing-file branch)
            try:
                os.unlink(hb_path)
            except OSError:
                pass
            penv[ENV_WORKER_HEARTBEAT] = hb_path
        penv.update(extra or {})
        proc = subprocess.Popen(
            [sys.executable, "-c", worker_src], env=penv, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return _Worker(slot, proc, hb_path)

    current: Dict[int, _Worker] = {s: spawn(s)
                                   for s in range(num_processes)}
    all_workers: List[_Worker] = list(current.values())
    incidents: List[WorkerIncident] = []
    respawns: Dict[int, int] = {s: 0 for s in range(num_processes)}

    deadline = None if timeout is None else t0 + timeout
    timed_out = False
    tearing_down = False
    while True:
        now = time.monotonic()
        if watchdog_timeout is not None and not tearing_down:
            for w in current.values():
                if (w.proc.poll() is None
                        and w.hb_stale(watchdog_timeout, startup_grace)):
                    incidents.append(WorkerIncident(
                        "hung", w.slot, None, round(now - t0, 3)))
                    w.proc.kill()      # SIGKILL works on stopped procs
        for w in list(current.values()):
            rc = w.proc.poll()
            if rc is None or w.handled:
                continue
            w.handled = True
            if rc == 0 or tearing_down:
                continue
            incidents.append(WorkerIncident(
                "exit", w.slot, rc, round(now - t0, 3)))
            if respawn and respawns[w.slot] < max_respawns:
                respawns[w.slot] += 1
                incidents.append(WorkerIncident(
                    "respawn", w.slot, rc, round(now - t0, 3)))
                extra = {ENV_REJOIN: "1"}
                extra.update(respawn_env or {})
                w2 = spawn(w.slot, extra)
                current[w.slot] = w2
                all_workers.append(w2)
            elif fail_fast:
                # a crashed worker of a lockstep cluster can never
                # answer the exchange; surface the crash in seconds
                tearing_down = True
                time.sleep(0.5)        # let its last writes flush
                for o in current.values():
                    if o.proc.poll() is None:
                        o.proc.kill()
        if all(w.proc.poll() is not None for w in current.values()):
            break
        if deadline is not None and now > deadline:
            timed_out = True
            for w in current.values():
                if w.proc.poll() is None:
                    w.proc.kill()
            break
        time.sleep(0.15)
    for w in all_workers:
        w.thread.join()
    if timed_out:
        raise subprocess.TimeoutExpired(
            current[0].proc.args, timeout or 0)
    completed = [subprocess.CompletedProcess(
        current[s].proc.args, *current[s].out)
        for s in range(num_processes)]
    return ClusterReport(completed=completed, incidents=incidents,
                         respawns=respawns)


def run_distributed_subprocesses(
        worker_src: str, num_processes: int, *,
        env: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = 900.0, cwd: Optional[str] = None,
        **supervisor_kwargs) -> List[subprocess.CompletedProcess]:
    """Spawn N python workers wired into one localhost store-backed run.

    Each worker executes ``worker_src`` (a `python -c` program that calls
    `init_distributed_from_env()` first) with the SPLITEE_* cluster vars
    set. Returns one CompletedProcess per worker, in process-id order.

    ``timeout`` is per cluster, in seconds; ``None`` waits indefinitely
    (interactive drivers). All workers' pipes are drained concurrently —
    a worker stalled on a full pipe would stop answering the KV-store
    exchange and wedge every other worker with it. A worker exiting
    non-zero fails fast by default: the survivors can never complete the
    exchange (they would block until their KV timeouts), so they are
    killed immediately and the crash surfaces in seconds, not minutes.

    Extra keyword arguments (``fail_fast=False``, ``watchdog_timeout``,
    ``respawn``, ``coordinator=False``, ...) select the supervisor
    behaviors of `run_supervised_cluster`, which this wraps.
    """
    report = run_supervised_cluster(
        worker_src, num_processes, env=env, timeout=timeout, cwd=cwd,
        **supervisor_kwargs)
    return report.completed


def respawn_distributed(num_processes: int, *,
                        timeout: Optional[float] = None,
                        env: Optional[Dict[str, str]] = None,
                        **supervisor_kwargs,
                        ) -> List[subprocess.CompletedProcess]:
    """Re-run the current program as an N-process distributed cluster.

    A driver-mode entry point: each worker re-executes ``sys.argv``
    verbatim (same flags, same deterministic setup) and detects worker
    mode via the SPLITEE_* env vars, so the program needs no separate
    worker entry point — a RESPAWNED worker rebuilds the same setup and
    rejoins via the fault-tolerant exchange. No timeout by default;
    interrupt the driver to kill the cluster instead. Supervisor
    behaviors (``coordinator=False``, ``fail_fast``, ``respawn``,
    ``watchdog_timeout``, ...) pass through to `run_supervised_cluster`.
    """
    argv = list(sys.argv)
    worker_src = (
        "import sys, runpy; "
        f"sys.argv = {argv!r}; "
        f"runpy.run_path({os.path.abspath(argv[0])!r}, "
        "run_name='__main__')")
    return run_distributed_subprocesses(
        worker_src, num_processes, timeout=timeout, env=env,
        **supervisor_kwargs)


def drive_respawned_cluster(num_processes: int, *,
                            env: Optional[Dict[str, str]] = None,
                            **supervisor_kwargs):
    """`respawn_distributed` + the standard driver epilogue.

    Host 0's output is echoed (workers gate their own prints to host 0).
    In the default lockstep mode any non-zero worker aborts the driver;
    in fault-tolerant runs (``fail_fast=False``) the cluster is expected
    to outlive individual workers, so the driver aborts only when host 0
    itself failed and otherwise reports casualties to stderr."""
    procs = respawn_distributed(num_processes, env=env, **supervisor_kwargs)
    failed = [(i, p) for i, p in enumerate(procs) if p.returncode != 0]
    fault_tolerant = supervisor_kwargs.get("fail_fast", True) is False
    if failed and (not fault_tolerant or procs[0].returncode != 0):
        # workers killed by the fail-fast sweep show a signal returncode;
        # the crashed worker's own stderr carries the root cause
        raise SystemExit("\n".join(
            f"worker {i} exited {p.returncode}:\n{p.stderr[-3000:]}"
            for i, p in failed))
    for i, p in failed:
        print(f"[driver] worker {i} exited {p.returncode} "
              f"(cluster continued without it)", file=sys.stderr)
    print(procs[0].stdout, end="")
