"""Model facade of the port: decoder-only (dense, ssm, hybrid, MoE, VLM)
vs enc-dec dispatch behind one object, as the reference's
``models/api.py:Model``.

There is no ``backend`` string: every kernel dispatches by the device of
its tensors (plain PyTorch versions on the CPU, the CUDA kernels on the
card). `abstract_params` and `input_specs` give meta tensors, the
stand-ins of the reference's ``jax.ShapeDtypeStruct`` trees that the dry
run (launch/dryrun.py) places on its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import InputShape, ModelConfig
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

    def abstract_params(self) -> transformer.ParamTree:
        """The parameter tree on the meta device (shapes, dtypes)."""
        return self._mod.abstract_params(self.cfg)

    def train_loss(self, params, batch, *, remat: bool = True,
                   seq_parallel: bool = True):
        """``seq_parallel`` (decoder-only models; the enc-dec loss has no
        such boundary) shards the training carry's sequence over "model"
        under a bound mesh; see ``transformer.train_loss``."""
        if self.is_encdec:
            return encdec.train_loss(params, self.cfg, batch, remat=remat)
        return transformer.train_loss(params, self.cfg, batch, remat=remat,
                                      seq_parallel=seq_parallel)

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

    # ----------------------------------------------------------- input specs
    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Meta-tensor stand-ins for every input of the step the shape
        exercises (train -> train step; prefill -> prefill; decode ->
        decode_step), leaf for leaf the shapes and dtypes of the
        reference's ``ShapeDtypeStruct``s. Nothing is allocated."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = torch_dtype(cfg.dtype)

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        def token_batch(with_labels: bool):
            batch: Dict[str, Any] = {}
            if cfg.modality == "vision_stub":
                batch["embeds"] = sds((b, s, cfg.d_model), dt)
            elif cfg.modality == "audio_stub":
                batch["frames"] = sds((b, cfg.encoder.source_len,
                                       cfg.encoder.d_model), dt)
                batch["tokens"] = sds((b, s), i32)
            else:
                batch["tokens"] = sds((b, s), i32)
            if with_labels:
                batch["labels"] = sds((b,) if cfg.num_classes else (b, s),
                                      i32)
            return batch

        if shape.kind == "train":
            return {"batch": token_batch(True)}
        if shape.kind == "prefill":
            return {"batch": token_batch(False)}
        # decode: one new token against a seq_len cache
        spec = {"caches": self.init_caches(b, s, device="meta"),
                "token": sds((b,), i32),
                "cur_index": sds((), i32)}
        if self.is_encdec:
            kv = (cfg.num_layers, b, cfg.encoder.source_len,
                  cfg.num_kv_heads, cfg.resolved_head_dim)
            spec["extras"] = {"cross_kv": (sds(kv, dt), sds(kv, dt))}
        if cfg.modality == "vision_stub":
            spec["token"] = sds((b, 1, cfg.d_model), dt)
        return spec


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
