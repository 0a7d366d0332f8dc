"""Online edge/cloud controller — SplitEE wired to a real multi-exit model.

A copy of the reference controller (its body is numpy), with the same
arithmetic: the bandit state is host-side float32 (q, n) plus a round
counter, UCB ties go to the first index (``np.argmax``), and every
serving path folds rewards through `merge_shard_updates`, which replays
the sequential incremental-mean update sample by sample, so a batch of
size 1 is bit-identical to per-sample serving.

* ``choose_splits`` draws a micro-batch's arms from the state frozen at
  the batch boundary (delayed feedback);
* ``prepare_shard_update`` computes a shard's (B, L) eq.-(1) reward
  matrix, exits, costs and offload bytes without touching the state;
* ``merge_shard_updates`` folds shards in order; ``update_batch`` is
  prepare-then-merge of one shard;
* non-stationary modes (``sliding_window``, ``discounted``) and a
  ``cost_trace`` reuse the same fold.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import BanditState, init_state
from repro_torch.core.rewards import CostModel, CostTrace

CONTROLLER_MODES = ("stationary", "sliding_window", "discounted")


def state_to_bytes(state) -> bytes:
    """Serialize a bandit state (BanditState or snapshot dict) exactly.

    npz preserves array dtypes bit-for-bit, which the fault-tolerance
    invariant depends on: a host seeded from a shipped snapshot must
    evolve bit-identically to the host that produced it. A windowed
    snapshot's ring blocks ride along as ``ring{i}_arms``/
    ``ring{i}_rewards`` entries; stationary payloads are unchanged.
    """
    if isinstance(state, dict):
        q, n, t = state["q"], state["n"], state["t"]
        ring = state.get("ring")
    else:
        q, n, t = state.q, state.n, state.t
        ring = None
    arrays = {"q": np.asarray(q), "n": np.asarray(n),
              "t": np.asarray(int(t), np.int64)}
    if ring is not None:
        arrays["ring_len"] = np.asarray(len(ring), np.int64)
        for i, (arms, rewards) in enumerate(ring):
            arrays[f"ring{i}_arms"] = np.asarray(arms, np.int64)
            arrays[f"ring{i}_rewards"] = np.asarray(rewards, np.float64)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def state_from_bytes(raw: bytes) -> Dict[str, Any]:
    """Inverse of `state_to_bytes`; returns a snapshot dict for
    `SplitEEController.restore` (with a ``"ring"`` entry iff the payload
    carried one)."""
    z = np.load(io.BytesIO(raw))
    snap: Dict[str, Any] = {"q": z["q"], "n": z["n"], "t": int(z["t"])}
    if "ring_len" in z:
        snap["ring"] = [(z[f"ring{i}_arms"], z[f"ring{i}_rewards"])
                        for i in range(int(z["ring_len"]))]
    return snap


@dataclasses.dataclass(frozen=True)
class ShardUpdate:
    """One replica's micro-batch summary, computed from the frozen state.

    Pure data: everything ``merge_shard_updates`` needs to fold the shard
    into the global bandit state, with no reference back to the replica
    that produced it (so shards can be computed concurrently and merged
    at the batch boundary in replica order).
    """
    arms: np.ndarray           # (B_r,) chosen arms (0-indexed split layer)
    rewards: np.ndarray        # (B_r, L) full reward matrix, eq. (1)
    exited: np.ndarray         # (B_r,) bool — exited on the edge half
    costs: np.ndarray          # (B_r,) per-sample device cost
    offload_bytes: np.ndarray  # (B_r,) bytes shipped (0 when exited)


@dataclasses.dataclass
class SplitEEController:
    cost: CostModel
    beta: float = 1.0
    side_info: bool = False
    mode: str = "stationary"       # | "sliding_window" | "discounted"
    window: int = 0                # ring capacity in merge calls; 0 = inf
    discount: float = 1.0          # per-sample decay gamma (discounted)
    cost_trace: Optional[CostTrace] = None
    record_history: bool = True

    def __post_init__(self):
        if self.mode not in CONTROLLER_MODES:
            raise ValueError(f"mode={self.mode!r}: expected one of "
                             f"{CONTROLLER_MODES}")
        if self.window < 0:
            raise ValueError(f"window={self.window}: must be >= 0")
        if self.window and self.mode != "sliding_window":
            raise ValueError(f"window={self.window} needs "
                             f"mode='sliding_window', got {self.mode!r}")
        if not 0.0 < self.discount <= 1.0:
            raise ValueError(f"discount={self.discount}: must be in (0, 1]")
        if self.discount != 1.0 and self.mode != "discounted":
            raise ValueError(f"discount={self.discount} needs "
                             f"mode='discounted', got {self.mode!r}")
        self.state = init_state(self.cost.num_layers)
        # ring of per-merge-call blocks: (arms (m,), rewards (m, L));
        # maintained only in windowed mode with a finite window
        self._ring: List[Tuple[np.ndarray, np.ndarray]] = []
        self.history: Dict[str, list] = {
            "arm": [], "exited": [], "reward": [], "cost": [],
            "offload_bytes": [],
        }
        # O(1) aggregates maintained regardless of record_history, so
        # serving results never need the unbounded per-sample lists
        self.totals: Dict[str, float] = {
            "cost": 0.0, "offload_bytes": 0, "exited": 0, "served": 0,
        }

    def snapshot(self) -> Dict[str, Any]:
        """Copy of the policy-complete bandit state (q, n, t).

        Everything arm selection reads — restoring a fresh controller
        from a snapshot reproduces the donor's subsequent evolution
        bit-for-bit (history is bookkeeping, not policy state, and is
        deliberately NOT part of the snapshot: a rejoined host's history
        covers only post-rejoin samples). A finite-window controller's
        ring IS policy state (eviction recomputes (q, n) from it), so it
        rides along.
        """
        snap: Dict[str, Any] = {"q": np.asarray(self.state.q).copy(),
                                "n": np.asarray(self.state.n).copy(),
                                "t": int(self.state.t)}
        if self.mode == "sliding_window" and self.window:
            snap["ring"] = [(a.copy(), r.copy()) for a, r in self._ring]
        return snap

    def restore(self, snap: Dict[str, Any]):
        """Install a snapshot, preserving array dtypes exactly."""
        self.state = BanditState(np.asarray(snap["q"]).copy(),
                                 np.asarray(snap["n"]).copy(),
                                 int(snap["t"]))
        ring = snap.get("ring")
        self._ring = ([] if ring is None else
                      [(np.asarray(a, np.int64).copy(),
                        np.asarray(r, np.float64).copy()) for a, r in ring])

    # numpy mirror of policy.bandit_step for host-side streaming
    def choose_split(self) -> int:
        return int(self.choose_splits(1)[0])

    def choose_splits(self, batch_size: int) -> np.ndarray:
        """Delayed-feedback arm selection for a micro-batch of size B.

        Every arm is drawn from the bandit state *frozen at the batch
        boundary* (the batch's own updates land together afterwards via
        ``update_batch``). Sample k continues the round-robin sweep while
        t + k < L; all later samples take the frozen-state UCB argmax —
        with B = 1 this degenerates to the sequential per-sample policy.
        """
        L = self.cost.num_layers
        t = int(self.state.t)
        arms = np.empty(batch_size, np.int64)
        rr = min(max(L - t, 0), batch_size)
        for k in range(rr):
            arms[k] = (t + k) % L
        if rr < batch_size:
            q, n = np.asarray(self.state.q), np.asarray(self.state.n)
            ucb = q + self.beta * np.sqrt(
                np.log(max(t, 1)) / np.maximum(n, 1e-9))
            arms[rr:] = int(np.argmax(ucb))
        return arms

    def _offload_at(self, round: Optional[int]) -> float:
        """Offload cost in effect for a batch starting at stream position
        ``round`` (None: the controller's own round counter — correct for
        any path whose folds land in stream order)."""
        if self.cost_trace is None:
            return self.cost.offload
        if round is None:
            round = int(self.state.t)
        return float(self.cost_trace.offload_at(round))

    def _reward_matrix(self, conf: np.ndarray, chat: np.ndarray,
                       offload):
        """Vectorized eq. (1) over a (B, L) padded confidence matrix,
        against the offload cost in effect for this batch (scalar, or
        (L,) when the communication term is per-arm — it broadcasts).

        float64 throughout — elementwise the same IEEE ops as the scalar
        reward path, so the fold below reproduces per-sample serving
        bit-for-bit.
        """
        L = self.cost.num_layers
        layers1 = np.arange(1, L + 1, dtype=np.float64)
        g = self.cost.gamma(layers1, side_info=self.side_info)
        exit_j = (conf >= self.cost.alpha) | (layers1[None, :] == L)
        r_exit = conf - self.cost.mu * g[None, :]
        r_off = chat[:, None] - self.cost.mu * (g[None, :] + offload)
        return np.where(exit_j, r_exit, r_off)

    def prepare_shard_update(self, arms: Sequence[int],
                             conf_paths: Sequence[np.ndarray],
                             conf_Ls: Sequence[Optional[float]],
                             offload_bytes: Sequence[int],
                             round: Optional[int] = None,
                             offload_scale: float = 1.0) -> ShardUpdate:
        """Summarize one replica's shard of a micro-batch — pure.

        Rewards for all B_r samples (and, with side information, all
        their sub-`arm` exits) are computed as one vectorized (B_r, L)
        reduce against the cost model only; the controller state is not
        read or written, so R replicas can prepare their shards
        concurrently from the state frozen at the batch boundary.

        ``round`` is the global stream position of the batch's first
        sample; with a ``cost_trace`` it selects the offload cost in
        effect when the batch was served (rewards AND charged costs).
        Pipelined/fault-tolerant drivers must pass it explicitly — the
        default (the controller's round counter) is only correct when
        folds land in stream order and no samples were lost.

        ``offload_scale`` multiplies the communication term ``o`` for
        every arm (served and counterfactual): with a quantized offload
        codec it is the deterministic wire-bytes / full-dtype-bytes ratio,
        so the bandit optimizes the cost actually paid. The multiply is
        skipped entirely at the default 1.0, keeping the codec-free path
        bit-identical. Decode serving passes an (L,) *vector* — the
        offload payload there includes the per-step ≤ℓ cache slice, so
        deeper splits genuinely cost more wire — and the per-arm term
        broadcasts through eq. (1) and the charged costs.
        """
        L = self.cost.num_layers
        B = len(arms)
        offload = self._offload_at(round)
        scale_vec = None
        if np.ndim(offload_scale):
            scale_vec = np.asarray(offload_scale, np.float64)
            if scale_vec.shape != (L,):
                raise ValueError(
                    f"vector offload_scale must be ({L},), got "
                    f"{scale_vec.shape}")
            offload = offload * scale_vec
        elif offload_scale != 1.0:
            offload = offload * float(offload_scale)
        arms = np.asarray(arms, np.int64)
        conf = np.zeros((B, L), np.float64)
        conf_i = np.empty(B, np.float64)
        chat = np.empty(B, np.float64)
        exited = np.empty(B, bool)
        for k in range(B):
            path = np.asarray(conf_paths[k], np.float64).reshape(-1)
            arm = int(arms[k])
            conf_i[k] = path[-1]
            exited[k] = conf_i[k] >= self.cost.alpha or arm + 1 == L
            chat[k] = conf_i[k] if conf_Ls[k] is None else float(conf_Ls[k])
            if self.side_info:
                assert len(path) == arm + 1
                conf[k, :arm + 1] = path
            else:
                conf[k, arm] = conf_i[k]
        r_all = self._reward_matrix(conf, chat, offload)
        # per-sample device cost, one vectorized reduce (float32 arithmetic
        # matching jnp's weak-type promotion in CostModel.sample_cost)
        g_arm = self.cost.gamma((arms + 1).astype(np.float64),
                                side_info=self.side_info)
        if scale_vec is None:
            c_all = g_arm.astype(np.float32) + np.where(
                exited, np.float32(0.0), np.float32(offload))
        else:
            c_all = g_arm.astype(np.float32) + np.where(
                exited, np.float32(0.0), offload[arms].astype(np.float32))
        ob = np.where(exited, 0,
                      np.asarray(offload_bytes, np.int64))
        return ShardUpdate(arms=arms, rewards=r_all, exited=exited,
                           costs=c_all, offload_bytes=ob)

    def merge_shard_updates(
            self, shards: Sequence[ShardUpdate]) -> np.ndarray:
        """Fold per-replica shard summaries into the global state.

        The host-side all-reduce at the batch boundary: shards are folded
        in replica order, each replaying the sequential incremental-mean
        (q, n) update sample by sample — the identical arithmetic of the
        per-sample controller, so a single shard is bit-identical to
        ``update_batch`` and R shards are bit-identical to serving the
        concatenated samples unsharded. Advances t by the total sample
        count and returns the concatenated exit decisions.

        Non-stationary modes reuse the identical per-sample arithmetic:
        ``discounted`` decays every pull count by gamma before each
        sample's fold (gamma = 1.0 degenerates bitwise to stationary);
        ``sliding_window`` additionally appends this call's samples as
        one ring block and, once the ring exceeds W blocks, evicts the
        oldest and recomputes (q, n) by replaying the survivors from
        zero — equal to a fresh controller that served only them.
        """
        q = np.asarray(self.state.q).copy()
        n = np.asarray(self.state.n).copy()
        total = 0
        for shard in shards:
            B = len(shard.arms)
            total += B
            for k in range(B):
                arm = int(shard.arms[k])
                if self.mode == "discounted":
                    n *= self.discount
                self._fold_sample(q, n, arm, shard.rewards[k])
                self.totals["cost"] += float(shard.costs[k])
                self.totals["offload_bytes"] += int(shard.offload_bytes[k])
                self.totals["exited"] += int(bool(shard.exited[k]))
                self.totals["served"] += 1
                if self.record_history:
                    self.history["arm"].append(arm)
                    self.history["exited"].append(bool(shard.exited[k]))
                    self.history["reward"].append(
                        float(shard.rewards[k, arm]))
                    self.history["cost"].append(float(shard.costs[k]))
                    self.history["offload_bytes"].append(
                        int(shard.offload_bytes[k]))
        if self.mode == "sliding_window" and self.window and total:
            self._ring.append((
                np.concatenate([np.asarray(s.arms, np.int64)
                                for s in shards if len(s.arms)]),
                np.concatenate([np.asarray(s.rewards, np.float64)
                                for s in shards if len(s.arms)], axis=0)))
            if len(self._ring) > self.window:
                del self._ring[:len(self._ring) - self.window]
                q, n = self._replay_ring()
        self.state = BanditState(q, n, self.state.t + total)
        if not shards:
            return np.zeros(0, bool)
        return np.concatenate([s.exited for s in shards])

    def _fold_sample(self, q: np.ndarray, n: np.ndarray, arm: int,
                     rewards_row: np.ndarray):
        """One sample's incremental-mean update, in place — the single
        arithmetic shared by every path and every controller mode."""
        if self.side_info:
            for j in range(arm + 1):
                r = float(rewards_row[j])
                n[j] += 1
                q[j] += (r - q[j]) / n[j]
        else:
            r = float(rewards_row[arm])
            n[arm] += 1
            q[arm] += (r - q[arm]) / n[arm]

    def _replay_ring(self) -> Tuple[np.ndarray, np.ndarray]:
        """Recompute (q, n) from the surviving ring blocks, replaying the
        per-sample fold from zero (dtype-preserving: float32 state stays
        float32, so the result is bit-identical to a fresh controller
        that folded only these blocks)."""
        q = np.zeros_like(np.asarray(self.state.q))
        n = np.zeros_like(np.asarray(self.state.n))
        for arms, rewards in self._ring:
            for k in range(len(arms)):
                self._fold_sample(q, n, int(arms[k]), rewards[k])
        return q, n

    def merge_cross_host(
            self,
            per_host_shards: Sequence[Sequence[ShardUpdate]]) -> np.ndarray:
        """Fold every host's shard summaries into the global state.

        The cross-host level of the same all-reduce `merge_shard_updates`
        performs across replicas: ``per_host_shards[h]`` is host h's
        (possibly per-local-replica) shard summaries for one micro-batch,
        and the fold flattens them in host order then replica order — the
        same global sample order the single-process sharded runtime
        folds, so the policy is invariant to how samples are split across
        hosts AND replicas. Every host calls this with the identical
        gathered summaries (the distributed runtime, not ported yet,
        all-gathers them host-side), keeping all local controller
        mirrors bit-identical without any device collective: the bandit
        state is O(L) host-side scalars by design.

        Returns the concatenated exit decisions in global sample order.
        """
        return self.merge_shard_updates(
            [shard for host in per_host_shards for shard in host])

    def update_batch(self, arms: Sequence[int],
                     conf_paths: Sequence[np.ndarray],
                     conf_Ls: Sequence[Optional[float]],
                     offload_bytes: Sequence[int],
                     round: Optional[int] = None,
                     offload_scale: float = 1.0) -> np.ndarray:
        """Apply one micro-batch of delayed-feedback updates.

        Implemented as prepare-then-merge of a single shard, so the
        batched and sharded serving paths share one update code path.
        Returns the per-sample exit decisions.
        """
        return self.merge_shard_updates([self.prepare_shard_update(
            arms, conf_paths, conf_Ls, offload_bytes, round=round,
            offload_scale=offload_scale)])

    def update(self, arm: int, conf_path: np.ndarray, conf_L: Optional[float],
               offload_bytes: int = 0, offload_scale: float = 1.0):
        """conf_path: confidences observed on-device (length arm+1 for
        SplitEE-S, or just [C_arm] for SplitEE). conf_L: final-layer
        confidence if the sample was offloaded, else None."""
        return bool(self.update_batch(
            [arm], [conf_path], [conf_L], [offload_bytes],
            offload_scale=offload_scale)[0])
