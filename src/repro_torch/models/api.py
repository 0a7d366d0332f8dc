"""Model facade of the port: the dense, ssm, hybrid and MoE families of
the decoder stack behind one object, as the reference's
``models/api.py:Model``.

There is no ``backend`` string: every kernel dispatches by the device of
its tensors (plain PyTorch versions on the CPU, the CUDA kernels on the
card).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        transformer._check_family(self.cfg)

    def init(self, *, seed: int = 0, device=None) -> transformer.ParamTree:
        """Random parameters from ``seed`` on ``device`` (default cuda),
        without gradient."""
        return transformer.init_params(self.cfg, seed=seed, device=device)

    def train_loss(self, params, batch, *, remat: bool = True):
        return transformer.train_loss(params, self.cfg, batch, remat=remat)

    def forward_exits(self, params, batch):
        return transformer.forward_exits(params, self.cfg, batch)

    def forward_exits_masked(self, params, batch, depths, *, window=None,
                             fused_exit: bool = False):
        return transformer.forward_exits_masked(
            params, self.cfg, batch, depths, window=window,
            fused_exit=fused_exit)

    def prefill(self, params, batch, *, cache_seq_len: int = 0):
        return transformer.prefill(params, self.cfg, batch,
                                   cache_seq_len=cache_seq_len)

    def init_caches(self, batch: int, seq_len: int, *, device=None):
        return transformer.init_caches(self.cfg, batch, seq_len,
                                       device=device)

    def decode_step(self, params, caches, token, cur_index: int, *,
                    split_layer=None, all_exits: bool = False,
                    window_seq_len: int = 0):
        return transformer.decode_step(
            params, self.cfg, caches, token, cur_index,
            split_layer=split_layer, all_exits=all_exits,
            window_seq_len=window_seq_len)

    def decode_step_masked(self, params, caches, token, cur_index: int,
                           depths, *, window_seq_len: int = 0):
        """Edge half of a decode-serving step; see
        ``transformer.decode_step_masked``."""
        return transformer.decode_step_masked(
            params, self.cfg, caches, token, cur_index, depths,
            window_seq_len=window_seq_len)

    def decode_step_resume(self, params, caches, hidden, cur_index: int,
                           depths, active, *, window_seq_len: int = 0):
        """Cloud half: layers > depth for active samples only; see
        ``transformer.decode_step_resume``."""
        return transformer.decode_step_resume(
            params, self.cfg, caches, hidden, cur_index, depths, active,
            window_seq_len=window_seq_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
