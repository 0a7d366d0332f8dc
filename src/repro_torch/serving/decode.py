"""Decode serving runtime: per-token SplitEE decisions during generation.

The classifier runtimes decide once per *sample*; here the bandit decides
once per *token*: every decode step draws a splitting layer from the UCB
state (eq. 1 unchanged: confidence is the exit head's max-softmax on the
step's hidden), the edge runs layers ``0..ℓ`` with per-layer cache slots
frozen above each sample's depth (``transformer.decode_step_masked``),
and a token either

* **exits** at ℓ — the exit head's argmax becomes the generated token and
  layers > ℓ never advance their cache for this step (see
  serving/kvcache.py for the consistency contract; the edge runs no
  layer above the batch's deepest split), or
* **offloads** — the split-layer hidden ships through the
  :class:`OffloadCodec` round trip together with the per-step ≤ℓ
  cache-slice bytes; ``decode_step_resume`` completes layers > ℓ for
  exactly the offloaded samples, and its tree (bitwise the input
  everywhere it did not advance) re-syncs the edge cache on commit.

The cloud call blocks: step t+1 cannot start until t's token exists. One
bandit round per decode step; the communication term is per-arm (an
(L,) ``offload_scale``: deeper splits ship more cache slice).

``split_policy="final"`` forces arm L-1 every step, which collapses the
pipeline to plain full-depth ``decode_step`` generation: the same tokens,
per-step logits and final cache.

On the card each edge step makes one exit-confidence launch over the
(L·B, D) exit rows and reads its observables back in one transfer; the
prefill runs attention once a layer (dense, MoE) or once a shared-block
occurrence (hybrid), or WKV6 once a layer (ssm); the one-token layers,
Mamba2's SSD, the MoE dispatch and the cloud resume are plain PyTorch,
as the reference's are plain XLA outside any Pallas kernel.

Driven by `serving.api`: ``ServingConfig(workload="decode", ...)`` routes
`serve()`/`Engine` here; `_DecodeSession` keeps `_BatchedSession`'s
push/result contract so the scheduler and multi-tenant engine treat both
alike.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import SplitEEController
from repro_torch.core.rewards import CostModel
from repro_torch.data.stream import microbatches
from repro_torch.models import transformer
from repro_torch.serving.kvcache import DecodeCacheManager, offload_scale_vec
from repro_torch.serving.offload_codec import OffloadCodec


def _fetch(*tensors) -> List[np.ndarray]:
    """float32 and int32 device tensors to numpy in ONE device->host copy
    (the int32 bits ride as float32 and are viewed back, unchanged)."""
    flat = torch.cat([t.reshape(-1).view(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        part = host[i:i + t.numel()]
        if t.dtype == torch.int32:
            part = part.view(np.int32)
        out.append(part.reshape(tuple(t.shape)))
        i += t.numel()
    return out


def _final_head(logits):
    """The LM head's confidence (max softmax, float32) and token."""
    conf = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
    return conf, logits.argmax(dim=-1).to(torch.int32)


@dataclasses.dataclass
class DecodeRuntime:
    """Prefill + edge/cloud halves of one decode-serving step, on
    ``device`` (default cuda; raises without a GPU), without gradient.

    The decode analogue of `EdgeCloudRuntime`: `prefill_fn` builds the
    batch's caches for a total length, `edge_fn` is the masked edge pass
    returning every exit observable plus the offload payload, `cloud_fn`
    is the masked resume. The total sequence length is an argument: the
    attention window depends on it.
    """
    cfg: ModelConfig
    device: Any = None

    def __post_init__(self):
        cfg = self.cfg
        if cfg.encoder is not None:
            raise NotImplementedError(
                "decode serving covers decoder-only families; enc-dec decode"
                " goes through Model.decode_step")
        if cfg.modality != "text":
            raise NotImplementedError(
                "decode serving is token-in/token-out; stub-modality archs"
                " are not supported")
        transformer.check_family(cfg)
        self.device = resolve_device(self.device)

    def _check(self, params):
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params on {emb.device}, runtime on "
                             f"{self.device}")

    @torch.no_grad()
    def prefill_fn(self, params, tokens, cache_seq_len: int):
        """tokens (B, S) -> (logits (B, V), caches)."""
        self._check(params)
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        return transformer.prefill(params, self.cfg, {"tokens": tokens},
                                   cache_seq_len=cache_seq_len)

    @torch.no_grad()
    def edge_fn(self, params, caches, token, cur_index: int, depths,
                window_seq_len: int):
        """Returns (logits, conf (L, B), pred (L, B), conf_fin (B,),
        pred_fin (B,), hidden (B, 1, D), new_caches)."""
        self._check(params)
        logits, conf, pred, hidden, new_caches = \
            transformer.decode_step_masked(
                params, self.cfg, caches, token, cur_index, depths,
                window_seq_len=window_seq_len)
        conf_fin, pred_fin = _final_head(logits)
        return logits, conf, pred, conf_fin, pred_fin, hidden, new_caches

    @torch.no_grad()
    def cloud_fn(self, params, caches, hidden, cur_index: int, depths,
                 active, window_seq_len: int):
        """Returns (logits, conf_L (B,), pred_L (B,), new_caches)."""
        self._check(params)
        logits, new_caches = transformer.decode_step_resume(
            params, self.cfg, caches, hidden, cur_index, depths, active,
            window_seq_len=window_seq_len)
        conf_l, pred_l = _final_head(logits)
        return logits, conf_l, pred_l, new_caches


class _DecodeSession:
    """Incremental decode driver with `_BatchedSession`'s contract.

    One `push(batch)` prefills the batch's prompts, then runs
    ``max_new_tokens`` decode rounds, each an independent bandit round
    (select → masked edge → per-sample exit/offload → blocking cloud
    resume for the offloaders → vectorized fold). The prefill's argmax is
    round 0's input token; generated tokens are the rounds' outputs.
    `result()` is non-destructive and adds a ``decode`` section.
    """

    def __init__(self, runtime: DecodeRuntime, params, cost: CostModel, *,
                 batch_size: int = 8, max_new_tokens: int = 1,
                 split_policy: str = "bandit", beta: float = 1.0,
                 controller_kwargs: Optional[Dict[str, Any]] = None,
                 codec: Optional[OffloadCodec] = None):
        if not isinstance(runtime, DecodeRuntime):
            raise TypeError(
                f"workload='decode' needs a DecodeRuntime, got "
                f"{type(runtime).__name__} — build one with "
                f"DecodeRuntime(cfg)")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.runtime = runtime
        self.params = params
        self.cost = cost
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.split_policy = split_policy
        self.codec = codec
        self.ctl = SplitEEController(cost, beta=beta,
                                     **(controller_kwargs or {}))
        # per-arm wire/raw ratio; scalar 1.0 when nothing is compressed
        self._scale = (offload_scale_vec(runtime.cfg, codec)
                       if codec is not None else 1.0)
        self.n = 0
        self._wall = 0.0
        self._pushes: List[Dict[str, Any]] = []
        self._exits_hist = np.zeros((max_new_tokens, cost.num_layers),
                                    np.int64)

    def push(self, batch):
        """Generate ``max_new_tokens`` tokens for one batch of prompts.
        Samples are dicts with an int "tokens" prompt; prompts in one push
        must share a length (pad upstream or push per length bucket)."""
        if not batch:
            return
        B = len(batch)
        try:
            prompts = np.stack(
                [np.asarray(s["tokens"], np.int32) for s in batch])
        except ValueError as e:
            raise ValueError(
                "decode push needs equal-length prompts in one batch; "
                f"got lengths {[len(s['tokens']) for s in batch]}") from e
        S = prompts.shape[1]
        T = self.max_new_tokens
        total = S + T
        L = self.cost.num_layers
        rt, params = self.runtime, self.params
        dev = rt.device

        t0 = time.perf_counter()
        logits0, caches = rt.prefill_fn(params, prompts, total)
        mgr = DecodeCacheManager(rt.cfg, caches, codec=self.codec)
        tok = logits0.argmax(dim=-1)

        gen = np.zeros((B, T), np.int32)
        exited_steps = np.zeros((T, B), bool)
        for t in range(T):
            if self.split_policy == "final":
                arms = np.full(B, L - 1, np.int64)
            else:
                arms = np.asarray(self.ctl.choose_splits(B), np.int64)
            step = S + t
            # depths and the active mask stay host tensors: the model
            # reads the deepest (edge) and shallowest (cloud) split off
            # them without waiting for the card
            depths = torch.from_numpy(arms)
            (_, conf_all, pred_all, conf_fin, pred_fin, hidden,
             new_caches) = rt.edge_fn(params, mgr.caches, tok, step,
                                      depths, total)
            mgr.commit_edge(new_caches, arms)
            conf_np, pred_np, conf_fin_np, pred_fin_np = _fetch(
                conf_all, pred_all, conf_fin, pred_fin)

            # at the final arm there is no split: confidence and token come
            # from the LM head itself, so forced-final decode IS plain
            # full-depth generation
            conf_paths: List[np.ndarray] = []
            toks_next = np.empty(B, np.int32)
            offload_rows: List[int] = []
            conf_Ls: List[Optional[float]] = [None] * B
            obs: List[int] = [0] * B
            for b in range(B):
                arm = int(arms[b])
                ci = (float(conf_fin_np[b]) if arm + 1 == L
                      else float(conf_np[arm, b]))
                conf_paths.append(np.asarray([ci], np.float64))
                if ci >= self.cost.alpha or arm + 1 == L:
                    toks_next[b] = (pred_fin_np[b] if arm + 1 == L
                                    else pred_np[arm, b])
                else:
                    offload_rows.append(b)

            if offload_rows:
                rows = np.asarray(offload_rows, np.int64)
                rows_dev = torch.as_tensor(rows, device=dev)
                dec_rows, hid_wire = mgr.ship_hidden(hidden, rows_dev)
                hid_in = hidden.index_put((rows_dev,), dec_rows)
                active = np.zeros(B, bool)
                active[rows] = True
                _, conf_l, pred_l, new_caches = rt.cloud_fn(
                    params, mgr.caches, hid_in, step, depths,
                    torch.from_numpy(active), total)
                mgr.commit_cloud(new_caches, active)
                conf_l_np, pred_l_np = _fetch(conf_l, pred_l)
                bytes_rows = mgr.meter(rows, arms, hid_wire)
                for j, b in enumerate(rows):
                    conf_Ls[b] = float(conf_l_np[b])
                    obs[b] = int(bytes_rows[j])
                    toks_next[b] = pred_l_np[b]
            else:
                mgr.note_no_offload()

            exited = np.asarray(self.ctl.update_batch(
                arms, conf_paths, conf_Ls, obs,
                offload_scale=self._scale), bool)
            self._exits_hist[t] += np.bincount(arms[exited], minlength=L)
            exited_steps[t] = exited
            gen[:, t] = toks_next
            tok = torch.as_tensor(toks_next, device=dev)

        self._wall += time.perf_counter() - t0
        self.n += B * T
        self._pushes.append({
            "tokens": gen,
            "prompt_len": S,
            "realized_depths": np.stack(mgr.realized_depths, 0).T,  # (B, T)
            "exited_steps": exited_steps.T,                         # (B, T)
            "offloaded_steps": np.stack(mgr.offloaded, 0).T,        # (B, T)
            "offloads_per_seq": mgr.offloads_per_seq,
            "wire_bytes_per_seq": mgr.wire_bytes_per_seq,
        })

    def drain(self):
        """The cloud resume blocks inside push — nothing is in flight."""

    def result(self) -> Dict[str, Any]:
        ctl = self.ctl
        hist = {k: np.asarray(v) for k, v in ctl.history.items()}
        tot = ctl.totals
        T = self.max_new_tokens
        seqs = sum(p["tokens"].shape[0] for p in self._pushes)

        def cat(key):
            if not self._pushes:
                return np.zeros((0,) if key in ("offloads_per_seq",
                                                "wire_bytes_per_seq")
                                else (0, T), np.int64)
            return np.concatenate([p[key] for p in self._pushes], 0)

        return {
            "n": self.n,
            "batch_size": self.batch_size,
            # one pred per bandit round, step-major like the fold order
            "preds": (np.concatenate(
                [p["tokens"].T.reshape(-1) for p in self._pushes])
                if self._pushes else np.zeros(0, np.int32)),
            "cost_total": float(tot["cost"]),
            "offload_frac": (1.0 - tot["exited"] / tot["served"]
                             if tot["served"] else 0.0),
            "offload_bytes": int(tot["offload_bytes"]),
            "arms": hist["arm"],
            "rewards": hist["reward"],
            "exited": hist["exited"],
            "state": ctl.snapshot(),
            "decode": {
                "max_new_tokens": T,
                "split_policy": self.split_policy,
                "sequences": seqs,
                "tokens_generated": seqs * T,
                "decode_wall_s": self._wall,
                "tokens_per_sec": (seqs * T / self._wall
                                   if self._wall > 0 else 0.0),
                "exits_per_layer_per_step": self._exits_hist.copy(),
                "tokens": cat("tokens"),
                "realized_depths": cat("realized_depths"),
                "exited_steps": cat("exited_steps"),
                "offloaded_steps": cat("offloaded_steps"),
                "offloads_per_sequence": cat("offloads_per_seq"),
                "wire_bytes_per_sequence": cat("wire_bytes_per_seq"),
            },
        }


def _serve_stream_decode(runtime: DecodeRuntime, params, stream,
                         cost: CostModel, *, batch_size: int = 8,
                         max_new_tokens: int = 1,
                         split_policy: str = "bandit", beta: float = 1.0,
                         max_samples: int = 0,
                         controller_kwargs: Optional[Dict[str, Any]] = None,
                         codec: Optional[OffloadCodec] = None,
                         ) -> Dict[str, Any]:
    """Offline driver: replay a finite prompt stream through a decode
    session (the `serve()` facade's workload="decode" entry point)."""
    sess = _DecodeSession(runtime, params, cost, batch_size=batch_size,
                          max_new_tokens=max_new_tokens,
                          split_policy=split_policy, beta=beta,
                          controller_kwargs=controller_kwargs, codec=codec)
    for batch in microbatches(stream, batch_size, max_samples):
        sess.push(batch)
    return sess.result()
