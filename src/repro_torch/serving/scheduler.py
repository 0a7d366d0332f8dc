"""Slot-based continuous-batching request scheduler.

The `Engine` push-session (api.py) is a thin incremental driver: it
buffers submitted samples and pushes a micro-batch the instant
``batch_size`` of them accumulate. That is the right schedule for a
steady offline replay, but production traffic is bursty, per-request,
and SLO-bound — requests arrive with different urgencies, queues grow
without bound under overload, and a half-full batch should not wait
forever for traffic that may never come.

This module adds the missing scheduling layer between ``submit`` and
the session push, extending SplitEE's accuracy-vs-cost trade to
*latency*:

* **Requests, not samples** — every submitted sample becomes a
  `Request` carrying its arrival timestamp, an optional *shed deadline*
  (``deadline_ms`` after arrival), and a priority. Service order is
  priority-major (higher first), FIFO within a priority.
* **Admission control & load shedding** — with ``max_queue`` set, a
  full queue sheds: ``shed_policy="reject"`` refuses the newcomer,
  ``"drop_oldest"`` evicts the oldest request of the lowest queued
  priority to admit a more important newcomer. A request whose shed
  deadline has passed while it queued is shed at batch-formation time —
  **no request is ever handed to the session past its deadline**.
* **Fill-or-deadline batch closing** — a micro-batch closes when it
  fills (padding-optimal) OR when the oldest waiting request has queued
  for ``batch_deadline_ms`` (latency-optimal): the knob that trades
  padding waste against queueing delay. ``batch_deadline_ms=0`` closes
  on fill only (plus the final `flush`), which is exactly the plain
  `Engine` schedule — a single-priority, no-deadline scheduler over a
  steady trace is therefore **bit-identical** to the unscheduled path.
* **Per-request latency** — completion is stamped when the request's
  batch has been pushed through the session; `snapshot()` reports
  p50/p99/mean/max latency, shed counts by reason, and mean batch fill.
* **Multi-tenant formation** — requests may carry a ``tenant`` label;
  batches are *tenant-pure* (the `MultiTenantEngine` routes each formed
  batch to that tenant's private session). Per-tenant batch-size caps
  and queued-request quotas (``tenant_quota``, shed reason
  ``tenant_quota``) bound each tenant's queue footprint, and when
  several tenants are ready at once the least-recently-served tenant
  goes first (tie: first-seen). Tenant-less traffic forms a single
  group, which is exactly the pre-tenant scheduler — the legacy suite
  pins that path unchanged.

Time comes from an injectable ``clock`` (monotonic seconds); tests pin
deadline behavior with a fake clock.

Invariants: conservation ``submitted == served + shed + pending``, FIFO
within priority, no served request past its shed deadline, and batch
size <= the configured cap. The module is pure host-side Python and
numpy, a copy of the reference's scheduler with the same behavior.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

SCHEDULERS = ("none", "fifo")
SHED_POLICIES = ("reject", "drop_oldest")

# shed reasons (keys of the snapshot's ``shed_reasons`` histogram)
SHED_QUEUE_FULL = "queue_full"   # admission refused: queue at max_queue
SHED_EVICTED = "evicted"         # evicted by drop_oldest to admit another
SHED_DEADLINE = "deadline"       # shed deadline passed while queued
SHED_TENANT_QUOTA = "tenant_quota"  # tenant's queued-request quota hit


@dataclasses.dataclass
class Request:
    """One queued unit of work: a sample plus its scheduling metadata."""

    sample: Dict[str, Any]
    arrival: float                     # clock seconds at admission
    seq: int                           # admission order (FIFO tiebreak)
    priority: int = 0                  # higher = served sooner
    deadline: Optional[float] = None   # absolute clock seconds; None = never
    tenant: Optional[str] = None       # multi-tenant routing label

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


def _latency_percentiles(lat_ms: List[float]) -> Dict[str, float]:
    if not lat_ms:
        return {"count": 0}
    arr = np.asarray(lat_ms)
    return {
        "count": int(arr.size),
        "p50": float(np.percentile(arr, 50)),
        "p99": float(np.percentile(arr, 99)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
    }


class RequestScheduler:
    """Priority/FIFO request queue with admission control and
    fill-or-deadline batch formation.

    Pure host-side data structure, with no runtime and no device. The `Engine` owns one and
    drives it: ``offer`` at submit, ``poll`` after every submit and on
    `Engine.tick()`, ``flush`` at drain, ``complete`` once a formed
    batch has been pushed through the serving session.
    """

    def __init__(self, *, batch_size: int, max_queue: int = 0,
                 batch_deadline_ms: float = 0.0,
                 shed_policy: str = "reject",
                 clock: Optional[Callable[[], float]] = None,
                 tenant_batch_size: Optional[Dict[str, int]] = None,
                 tenant_quota: Optional[Dict[str, int]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if batch_deadline_ms < 0:
            raise ValueError(
                f"batch_deadline_ms must be >= 0, got {batch_deadline_ms}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        self.batch_size = batch_size
        self.max_queue = max_queue
        self.batch_deadline_ms = batch_deadline_ms
        self.shed_policy = shed_policy
        self.clock = clock if clock is not None else time.monotonic
        self.tenant_batch_size = dict(tenant_batch_size or {})
        self.tenant_quota = dict(tenant_quota or {})
        for name, val in {**self.tenant_batch_size,
                          **self.tenant_quota}.items():
            if val < 1:
                raise ValueError(
                    f"per-tenant limits must be >= 1, got {val} for "
                    f"tenant {name!r}")
        self._queue: List[Request] = []
        self._seq = 0
        # conservation counters: submitted == served + shed + pending
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.shed_reasons: Dict[str, int] = {
            SHED_QUEUE_FULL: 0, SHED_EVICTED: 0, SHED_DEADLINE: 0,
            SHED_TENANT_QUOTA: 0}
        self.batches = 0
        self._batch_rows = 0            # sum of formed batch sizes
        self._batch_caps = 0            # sum of closing batches' size caps
        self._latency_ms: List[float] = []
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._last_served: Dict[Optional[str], int] = {}
        self._first_seen: Dict[Optional[str], int] = {}

    # ------------------------------------------------------------- state
    @property
    def pending(self) -> int:
        return len(self._queue)

    def _now(self, now: Optional[float]) -> float:
        return self.clock() if now is None else now

    def _tstats(self, tenant: str) -> Dict[str, int]:
        return self._tenant_stats.setdefault(
            tenant, {"submitted": 0, "served": 0, "shed": 0, "batches": 0})

    def _tenant_cap(self, tenant: Optional[str]) -> int:
        if tenant is None:
            return self.batch_size
        return int(self.tenant_batch_size.get(tenant, self.batch_size))

    def _shed_one(self, req: Request, reason: str):
        self.shed += 1
        self.shed_reasons[reason] += 1
        if req.tenant is not None:
            self._tstats(req.tenant)["shed"] += 1

    # --------------------------------------------------------- admission
    def offer(self, sample: Dict[str, Any], *, priority: int = 0,
              deadline_ms: Optional[float] = None,
              now: Optional[float] = None,
              tenant: Optional[str] = None) -> bool:
        """Admit one sample as a `Request`; returns False if it was shed.

        ``deadline_ms`` is the request's *shed deadline*, relative to
        arrival: once that long in the queue it will be shed, never
        served. Admission control runs first: a ``tenant`` at its
        queued-request quota sheds within that tenant (``reject`` sheds
        the newcomer; ``drop_oldest`` evicts the tenant's own
        lowest-priority oldest request), then with the whole queue at
        ``max_queue``, ``reject`` sheds the newcomer while
        ``drop_oldest`` evicts the oldest request of the lowest queued
        priority — unless the newcomer itself is lower-priority than
        everything queued, in which case rejecting it IS drop-lowest.
        """
        now = self._now(now)
        self.submitted += 1
        req = Request(
            sample=sample, arrival=now, seq=self._seq, priority=priority,
            deadline=(now + deadline_ms / 1000.0
                      if deadline_ms is not None else None),
            tenant=tenant)
        self._seq += 1
        if tenant is not None:
            self._tstats(tenant)["submitted"] += 1
            self._first_seen.setdefault(tenant, len(self._first_seen))
            quota = self.tenant_quota.get(tenant)
            if quota is not None:
                mine = [r for r in self._queue if r.tenant == tenant]
                if len(mine) >= quota:
                    if self.shed_policy == "reject":
                        self._shed_one(req, SHED_TENANT_QUOTA)
                        return False
                    victim = min(mine, key=lambda r: (r.priority, r.seq))
                    if victim.priority >= req.priority:
                        self._shed_one(req, SHED_TENANT_QUOTA)
                        return False
                    self._queue.remove(victim)
                    self._shed_one(victim, SHED_EVICTED)
        else:
            self._first_seen.setdefault(tenant, len(self._first_seen))
        if self.max_queue and len(self._queue) >= self.max_queue:
            if self.shed_policy == "reject":
                self._shed_one(req, SHED_QUEUE_FULL)
                return False
            victim = min(self._queue, key=lambda r: (r.priority, r.seq))
            if victim.priority >= req.priority:
                # newcomer is the least important request in sight
                self._shed_one(req, SHED_QUEUE_FULL)
                return False
            self._queue.remove(victim)
            self._shed_one(victim, SHED_EVICTED)
        self._queue.append(req)
        return True

    # --------------------------------------------------- batch formation
    def _prune_expired(self, now: float):
        """Shed every queued request whose shed deadline has passed."""
        live = []
        for r in self._queue:
            if r.expired(now):
                self._shed_one(r, SHED_DEADLINE)
            else:
                live.append(r)
        self._queue = live

    def _groups(self) -> Dict[Optional[str], List[Request]]:
        groups: Dict[Optional[str], List[Request]] = {}
        for r in self._queue:
            groups.setdefault(r.tenant, []).append(r)
        return groups

    def _pick_fair(self, tenants: List[Optional[str]]) -> Optional[str]:
        """Least-recently-served tenant first (never-served beats served);
        tie broken by first-seen admission order."""
        return min(tenants, key=lambda t: (self._last_served.get(t, -1),
                                           self._first_seen.get(t, 0)))

    def _take_tenant(self, tenant: Optional[str], k: int) -> List[Request]:
        """Pop the tenant's k most urgent live requests: priority-major
        (higher first), FIFO (admission order) within a priority."""
        mine = sorted((r for r in self._queue if r.tenant == tenant),
                      key=lambda r: (-r.priority, r.seq))
        batch = mine[:k]
        taken = {id(r) for r in batch}
        self._queue = [r for r in self._queue if id(r) not in taken]
        self.batches += 1
        self._batch_rows += len(batch)
        self._batch_caps += self._tenant_cap(tenant)
        self._last_served[tenant] = self.batches
        if tenant is not None:
            self._tstats(tenant)["batches"] += 1
        return batch

    def _deadline_due(self, reqs: List[Request], now: float) -> bool:
        if not reqs or not self.batch_deadline_ms:
            return False
        oldest = min(r.arrival for r in reqs)
        return (now - oldest) * 1000.0 >= self.batch_deadline_ms

    def poll(self, now: Optional[float] = None) -> List[List[Request]]:
        """Form every micro-batch that is ready at ``now``.

        Batches are tenant-pure. A tenant's batch closes on *fill* (>=
        its batch-size cap queued) or on *deadline* (its oldest waiting
        request has queued for ``batch_deadline_ms`` — the partial batch
        goes out, trading padding waste for bounded queueing delay).
        When several tenants are ready, the least-recently-served one
        forms first. Expired requests are shed before every formation,
        so no returned request is past its shed deadline at formation
        time. Tenant-less traffic is one group with the global
        ``batch_size`` cap — the original single-queue schedule.
        """
        now = self._now(now)
        batches = []
        while True:
            self._prune_expired(now)
            groups = self._groups()
            filled = [t for t, reqs in groups.items()
                      if len(reqs) >= self._tenant_cap(t)]
            if filled:
                t = self._pick_fair(filled)
                batches.append(self._take_tenant(t, self._tenant_cap(t)))
                continue
            due = [t for t, reqs in groups.items()
                   if self._deadline_due(reqs, now)]
            if due:
                t = self._pick_fair(due)
                batches.append(self._take_tenant(t, len(groups[t])))
                continue
            return batches

    def flush(self, now: Optional[float] = None) -> List[List[Request]]:
        """Drain-time formation: shed the expired, then emit everything
        still queued as tenant-pure batches of <= the tenant's cap
        (priority order, fair tenant rotation)."""
        now = self._now(now)
        self._prune_expired(now)
        batches = []
        while self._queue:
            groups = self._groups()
            t = self._pick_fair(list(groups))
            batches.append(self._take_tenant(
                t, min(self._tenant_cap(t), len(groups[t]))))
        return batches

    def next_fire(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest clock time at which waiting changes the schedule: the
        pending batch-deadline close or the next shed deadline, whichever
        is sooner (None when nothing is queued or nothing is timed).
        Event-loop drivers sleep or step to this instant instead of
        polling."""
        del now
        times = []
        if self._queue and self.batch_deadline_ms:
            oldest = min(r.arrival for r in self._queue)
            times.append(oldest + self.batch_deadline_ms / 1000.0)
        times.extend(r.deadline for r in self._queue
                     if r.deadline is not None)
        return min(times) if times else None

    # --------------------------------------------------------- accounting
    def complete(self, batch: List[Request],
                 now: Optional[float] = None):
        """Record a formed batch as served (its session push returned);
        per-request latency is completion minus arrival."""
        now = self._now(now)
        self.served += len(batch)
        self._latency_ms.extend((now - r.arrival) * 1000.0 for r in batch)
        for r in batch:
            if r.tenant is not None:
                self._tstats(r.tenant)["served"] += 1

    def snapshot(self) -> Dict[str, Any]:
        """The report's ``scheduler`` section. The ``tenants`` sub-dict
        (per-tenant conservation ledgers) appears only when tenant-labeled
        traffic was offered."""
        snap = {
            "policy": "fifo",
            "shed_policy": self.shed_policy,
            "max_queue": self.max_queue,
            "batch_deadline_ms": self.batch_deadline_ms,
            "submitted": self.submitted,
            "served": self.served,
            "shed": self.shed,
            "shed_reasons": dict(self.shed_reasons),
            "pending": len(self._queue),
            "batches": self.batches,
            "mean_batch_fill": (self._batch_rows / self._batch_caps
                                if self.batches else None),
            "latency_ms": _latency_percentiles(self._latency_ms),
        }
        if self._tenant_stats:
            pend: Dict[str, int] = {}
            for r in self._queue:
                if r.tenant is not None:
                    pend[r.tenant] = pend.get(r.tenant, 0) + 1
            snap["tenants"] = {
                t: {**st, "pending": pend.get(t, 0)}
                for t, st in self._tenant_stats.items()}
        return snap
