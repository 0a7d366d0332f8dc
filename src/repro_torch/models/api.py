"""Model facade of the port: decoder-only (dense, ssm, hybrid, MoE, VLM)
vs enc-dec dispatch behind one object, as the reference's
``models/api.py:Model``.

There is no ``backend`` string: every kernel dispatches by the device of
its tensors (plain PyTorch versions on the CPU, the CUDA kernels on the
card).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

_NO_MASKED_ENCDEC = ("masked decode serving covers decoder-only families; "
                     "enc-dec decode goes through decode_step")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        transformer.check_family(self.cfg)

    @property
    def is_encdec(self) -> bool:
        return self.cfg.encoder is not None

    @property
    def _mod(self):
        return encdec if self.is_encdec else transformer

    def init(self, *, seed: int = 0, device=None) -> transformer.ParamTree:
        """Random parameters from ``seed`` on ``device`` (default cuda),
        without gradient."""
        return self._mod.init_params(self.cfg, seed=seed, device=device)

    def train_loss(self, params, batch, *, remat: bool = True):
        return self._mod.train_loss(params, self.cfg, batch, remat=remat)

    def forward_exits(self, params, batch):
        if self.is_encdec:
            raise NotImplementedError(
                "streaming exits for enc-dec run through decode_step")
        return transformer.forward_exits(params, self.cfg, batch)

    def forward_exits_masked(self, params, batch, depths, *, window=None,
                             fused_exit: bool = False):
        if self.is_encdec:
            raise NotImplementedError(
                "streaming exits for enc-dec run through decode_step")
        return transformer.forward_exits_masked(
            params, self.cfg, batch, depths, window=window,
            fused_exit=fused_exit)

    def prefill(self, params, batch, *, cache_seq_len: int = 0):
        return self._mod.prefill(params, self.cfg, batch,
                                 cache_seq_len=cache_seq_len)

    def init_caches(self, batch: int, seq_len: int, *, device=None):
        return self._mod.init_caches(self.cfg, batch, seq_len, device=device)

    def decode_step(self, params, caches, token, cur_index: int, *,
                    extras=None, split_layer=None, all_exits: bool = False,
                    window_seq_len: int = 0):
        """One decode step; an enc-dec model takes its cross K/V as
        ``extras={"cross_kv": ...}`` (from `prefill`)."""
        if self.is_encdec:
            return encdec.decode_step(
                params, self.cfg, caches, extras["cross_kv"], token,
                cur_index, split_layer=split_layer, all_exits=all_exits,
                window_seq_len=window_seq_len)
        return transformer.decode_step(
            params, self.cfg, caches, token, cur_index,
            split_layer=split_layer, all_exits=all_exits,
            window_seq_len=window_seq_len)

    def decode_step_masked(self, params, caches, token, cur_index: int,
                           depths, *, window_seq_len: int = 0):
        """Edge half of a decode-serving step; see
        ``transformer.decode_step_masked``."""
        if self.is_encdec:
            raise NotImplementedError(_NO_MASKED_ENCDEC)
        return transformer.decode_step_masked(
            params, self.cfg, caches, token, cur_index, depths,
            window_seq_len=window_seq_len)

    def decode_step_resume(self, params, caches, hidden, cur_index: int,
                           depths, active, *, window_seq_len: int = 0):
        """Cloud half: layers > depth for active samples only; see
        ``transformer.decode_step_resume``."""
        if self.is_encdec:
            raise NotImplementedError(_NO_MASKED_ENCDEC)
        return transformer.decode_step_resume(
            params, self.cfg, caches, hidden, cur_index, depths, active,
            window_seq_len=window_seq_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
