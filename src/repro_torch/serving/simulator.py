"""Edge/cloud split-computing runtime (the paper's Figure 1, executable).

Two halves of the split, on one device:

  edge_fn(params, batch, depth)  — embed + layers 1..depth+1 + the exit
      at ``depth`` (0-indexed arm); the batch holds ``tokens`` (B, S), or
      a modality stub's ``embeds`` (B, S, D);
  cloud_fn(params, hidden, depth) — layers depth+2..L + the final head.

The offload payload between them is the (B, S, D) activation after the
split layer; its byte size is metered per sample and is what the paper's
`o` abstracts. ``edge_fn_s`` (SplitEE-S) also returns the confidences of
every exit below the split; ``edge_scan_fn`` runs a whole micro-batch
with a per-sample depth through the masked forward. The layer loop is a
Python loop over the stacked layer parameters; attention (dense and MoE
layers, a hybrid's shared block), the WKV6 recurrence (ssm family) and
the exit heads run the port's CUDA kernels on a CUDA device and their
plain versions on the CPU; Mamba2's SSD and the MoE dispatch are plain
PyTorch on both, as the reference's are plain XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import SplitEEController
from repro_torch.core.rewards import CostModel
from repro_torch.kernels.exit_confidence.ops import (exit_confidence,
                                                     exit_confidence_fused)
from repro_torch.models.common import apply_norm
from repro_torch.models.transformer import (check_family, _exit_w,
                                            _layer_full, _positions,
                                            embed_inputs,
                                            forward_exits_masked,
                                            grouped_exits, layer_params,
                                            pool_hidden)
from repro_torch.serving.offload_codec import OffloadCodec


@dataclasses.dataclass
class EdgeCloudRuntime:
    cfg: ModelConfig
    device: Any = None           # default "cuda"; raises without a GPU
    # run the exit decision as the fused epilogue (norm + head + online
    # softmax in one launch) instead of the norm then the plain head
    fused_exit: bool = False

    def __post_init__(self):
        check_family(self.cfg)
        self.device = resolve_device(self.device)

    # ---------------------------------------------------------------- parts

    def _inputs(self, params, batch):
        """The batch on the runtime's device: its token ids, or a modality
        stub's ``embeds`` (B, S, D)."""
        emb = params["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params on {emb.device}, runtime on "
                             f"{self.device}")
        if "embeds" in batch:
            return {"embeds": torch.as_tensor(batch["embeds"],
                                              device=self.device)}
        return {"tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                          device=self.device)}

    def _embed(self, params, batch):
        x = embed_inputs(params, self.cfg, self._inputs(params, batch))
        return x, _positions(self.cfg, x.shape[0], x.shape[1],
                             device=self.device)

    def _run_layers(self, params, x, positions, start: int, stop: int):
        for i in range(start, stop):
            x, _ = _layer_full(self.cfg, params,
                               layer_params(params["layers"], i), x,
                               positions, i, window=0)
        return x

    def _exit_at(self, params, x, depth: int):
        """Exit observables at 1-indexed layer depth+1. The exit norm is
        applied to the pooled row (the norm is per token, so pooling and
        norm commute)."""
        cfg = self.cfg
        lp = layer_params(params["layers"], depth)
        w = _exit_w(params, lp)
        pooled = pool_hidden(cfg, x)
        if self.fused_exit:
            return exit_confidence_fused(pooled, lp["exit_norm"], w,
                                         kind=cfg.norm)
        return exit_confidence(apply_norm(pooled, lp["exit_norm"], cfg.norm),
                               w)

    # ----------------------------------------------------------- the halves

    def edge_fn(self, params, batch, depth: int):
        """Layers 1..depth+1 (depth is the 0-indexed arm) and that exit.
        Returns conf (B,) f32, pred (B,) i32, hidden (B, S, D)."""
        x, pos = self._embed(params, batch)
        x = self._run_layers(params, x, pos, 0, int(depth) + 1)
        conf, pred = self._exit_at(params, x, int(depth))
        return conf, pred, x

    def cloud_fn(self, params, hidden, depth: int):
        """Layers depth+2..L and the final head (never fused). Returns
        conf (B,) f32, pred (B,) i32."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        pos = _positions(cfg, b, s, device=hidden.device)
        x = self._run_layers(params, hidden, pos, int(depth) + 1,
                             cfg.num_layers)
        lp_last = layer_params(params["layers"], cfg.num_layers - 1)
        pooled = apply_norm(pool_hidden(cfg, x), params["final_norm"],
                            cfg.norm)
        return exit_confidence(pooled, _exit_w(params, lp_last))

    def edge_fn_s(self, params, batch, depth: int):
        """SplitEE-S edge pass: conf/pred (L, B) of every exit; rows past
        ``depth`` come from the carry frozen at ``depth`` (as the
        reference's masked scan gives them) and serving reads only rows
        <= depth. Layers past ``depth`` are not run. One grouped
        confidence launch covers all L exits."""
        cfg = self.cfg
        depth = int(depth)
        x, pos = self._embed(params, batch)
        pooled = []
        for i in range(cfg.num_layers):
            if i <= depth:
                x, _ = _layer_full(cfg, params,
                                   layer_params(params["layers"], i), x,
                                   pos, i, window=0)
            pooled.append(pool_hidden(cfg, x))
        conf, pred = grouped_exits(params, cfg, torch.stack(pooled),
                                   fused=self.fused_exit)
        return conf, pred, x

    def edge_scan_fn(self, params, batch, depths):
        """Masked edge pass over a whole micro-batch: ``depths`` (B,) holds
        each sample's 0-indexed arm. Returns conf (L, B) f32 and pred (L,
        B) i32 of every exit, and hidden (B, S, D) at each row's own
        depth. The launch sequence depends only on the batch shape."""
        out = forward_exits_masked(params, self.cfg,
                                   self._inputs(params, batch),
                                   torch.as_tensor(depths,
                                                   device=self.device),
                                   window=0, fused_exit=self.fused_exit)
        return out["conf"], out["pred"], out["hidden"]

    def offload_bytes(self, batch_size: int, seq_len: int) -> int:
        return batch_size * seq_len * self.cfg.d_model \
            * torch_dtype(self.cfg.dtype).itemsize


def _serve_stream_sequential(runtime: EdgeCloudRuntime, params, stream,
                             cost: CostModel, *, side_info: bool = False,
                             beta: float = 1.0, max_samples: int = 0,
                             labels_for_accounting: bool = True,
                             controller_kwargs: Optional[Dict[str, Any]] = None,
                             codec: Optional[OffloadCodec] = None,
                             ) -> Dict[str, Any]:
    """Stream samples one by one through the online SplitEE controller and
    the edge/cloud runtime. Unsupervised: labels (if present) are used
    only for reporting.

    With a ``codec`` the offload payload is encoded and decoded at the
    edge->cloud handoff (the cloud sees the lossy reconstruction), and
    both the byte accounting and the bandit's communication cost use the
    wire bytes shipped."""
    cfg = runtime.cfg
    ctl = SplitEEController(cost, beta=beta, side_info=side_info,
                            **(controller_kwargs or {}))
    correct, preds = [], []
    n = 0
    for sample in stream:
        tokens = np.asarray(sample["tokens"])[None, :]
        batch = {"tokens": tokens}
        arm = ctl.choose_split()
        if side_info:
            conf_all, pred_all, hidden = runtime.edge_fn_s(params, batch, arm)
            conf_path = conf_all[: arm + 1, 0].cpu().numpy()
            pred_i = int(pred_all[arm, 0])
        else:
            conf, pred_v, hidden = runtime.edge_fn(params, batch, arm)
            conf_path = conf.cpu().numpy()
            pred_i = int(pred_v[0])
        conf_i = float(conf_path[-1])
        will_exit = (conf_i >= cost.alpha) or (arm + 1 == cost.num_layers)
        conf_L = None
        ob = 0
        # the scale applies to the communication term of EVERY arm's reward
        # (counterfactual offloads ship through the same codec), so it
        # depends only on the codec and the shape
        scale = (1.0 if codec is None else
                 codec.cost_ratio(tokens.shape[1], cfg.d_model,
                                  torch_dtype(cfg.dtype).itemsize))
        if not will_exit:
            if codec is None:
                ob = runtime.offload_bytes(1, tokens.shape[1])
            else:
                enc = codec.encode(hidden)
                hidden = codec.decode(enc)
                ob = enc.row_bytes
            conf_L_v, pred_L = runtime.cloud_fn(params, hidden, arm)
            conf_L = float(conf_L_v[0])
            pred_i = int(pred_L[0])
        ctl.update(arm, conf_path, conf_L, offload_bytes=ob,
                   offload_scale=scale)
        preds.append(pred_i)
        if labels_for_accounting and "labels" in sample:
            correct.append(int(pred_i == int(sample["labels"])))
        n += 1
        if max_samples and n >= max_samples:
            break
    hist = {k: np.asarray(v) for k, v in ctl.history.items()}
    tot = ctl.totals
    out = {
        "n": n,
        "batch_size": 1,
        "preds": np.asarray(preds),
        "cost_total": float(tot["cost"]),
        "offload_frac": (1.0 - tot["exited"] / tot["served"]
                         if tot["served"] else 0.0),
        "offload_bytes": int(tot["offload_bytes"]),
        "arms": hist["arm"],
        "rewards": hist["reward"],
        "exited": hist["exited"],
        "state": ctl.snapshot(),
    }
    if correct:
        out["accuracy"] = float(np.mean(correct))
    return out

