"""Model facade of the port: the dense and ssm families of the decoder
stack behind one object, as the reference's ``models/api.py:Model``.

There is no ``backend`` string: every kernel dispatches by the device of
its tensors (plain PyTorch versions on the CPU, the CUDA kernels on the
card). Decode is not ported yet; its methods raise.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _decode_not_ported(*_, **__):
    raise NotImplementedError("decode (KV caches, decode_step*): not ported "
                              "yet")


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

    prefill = init_caches = decode_step = _decode_not_ported
    decode_step_masked = decode_step_resume = _decode_not_ported


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
