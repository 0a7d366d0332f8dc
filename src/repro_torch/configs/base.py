"""Config dataclasses for the PyTorch port of the SplitEE framework.

A copy of the reference package's config classes: the port imports
nothing of the JAX package, so it keeps its own. The dataclasses are
plain and frozen, so a config built here compares equal field by field
to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space / RWKV parameters."""
    kind: str = "rwkv6"            # "rwkv6" | "mamba2"
    state_size: int = 64
    num_heads: int = 0             # 0 -> derive from d_model // state_size
    expand: int = 2
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) architectures."""
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    source_len: int = 4096


@dataclasses.dataclass(frozen=True)
class ExitConfig:
    """The paper's technique: exit head after every layer (or stride)."""
    enabled: bool = True
    stride: int = 1
    # LM archs tie all exits to one unembedding; classification testbeds
    # use one head per exit
    share_head: bool = True
    confidence: str = "maxprob"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    num_classes: int = 0           # classification exits; 0 -> LM head

    causal: bool = True            # False -> bidirectional (BERT-style)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False
    sliding_window: int = 0
    sliding_window_override: int = 0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0
    encoder: Optional[EncoderConfig] = None

    modality: str = "text"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "swiglu"     # swiglu | gelu_mlp
    tie_embeddings: bool = False

    exits: ExitConfig = ExitConfig()
    dtype: str = "bfloat16"

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def exit_layers(self) -> Tuple[int, ...]:
        """1-indexed layers with an exit head attached (always includes L)."""
        n = self.decoder_layers
        s = self.exits.stride
        layers = tuple(i for i in range(s, n + 1, s))
        if not layers or layers[-1] != n:
            layers = layers + (n,)
        return layers

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    def effective_window(self, seq_len: int) -> int:
        """Attention window for a given sequence length (0 = full)."""
        if self.sliding_window:
            return self.sliding_window
        if self.sliding_window_override and seq_len > self.sliding_window_override:
            return self.sliding_window_override
        return 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + decoder + exits +
        encoder); the norms are not counted."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        mlp = 3 * d * f if self.activation == "swiglu" else 2 * d * f
        if self.family == "ssm" and self.ssm is not None:
            # rwkv6: time-mix (~4.5 d^2 with lora decays) + channel-mix 2*d*f
            total_layers = self.num_layers * (int(5 * d * d) + 2 * d * f)
        elif self.family == "hybrid" and self.ssm is not None:
            # every layer is a mamba block (no per-layer MLP); one shared
            # attn+mlp block applied every k layers (weights counted once)
            d_in = self.ssm.expand * d
            conv_dim = d_in + 2 * self.ssm.state_size
            mamba = d * (d_in + conv_dim + d_in // 64) + d_in * d
            total_layers = self.num_layers * mamba + (attn + mlp)
        elif self.family == "moe" and self.moe is not None:
            moe_mlp = self.moe.num_experts * 3 * d * f \
                + d * self.moe.num_experts
            total_layers = self.num_layers * (attn + moe_mlp)
        else:   # dense, vlm (the text backbone), audio (the decoder)
            total_layers = self.num_layers * (attn + mlp)
        head_out = self.num_classes if self.num_classes else v
        n_heads_p = 1 if (not self.exits.enabled or self.exits.share_head) \
            else len(self.exit_layers)
        enc = 0
        if self.encoder is not None:
            e = self.encoder
            eq = e.num_heads * (e.d_model // e.num_heads)
            ekv = e.num_kv_heads * (e.d_model // e.num_heads)
            e_attn = e.d_model * eq + 2 * e.d_model * ekv + eq * e.d_model
            e_mlp = 2 * e.d_model * e.d_ff
            # each decoder layer adds a cross-attention block
            enc = e.num_layers * (e_attn + e_mlp) + self.num_layers * attn
        return v * d + total_layers + n_heads_p * d * head_out + enc

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        active_mlp = self.moe.top_k * 3 * d * f + d * self.moe.num_experts
        layers = self.num_layers * (attn + active_mlp)
        head_out = self.num_classes if self.num_classes else self.vocab_size
        n_heads_p = 1 if (not self.exits.enabled or self.exits.share_head) \
            else len(self.exit_layers)
        return self.vocab_size * d + layers + n_heads_p * d * head_out


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family: 2 layers, d_model<=128, <=4 experts."""
    d = min(cfg.d_model, 128)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    if cfg.num_kv_heads < cfg.num_heads:
        kv = max(1, heads // 2)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=min(4, cfg.moe.num_experts))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_size=min(16, cfg.ssm.state_size),
                                  chunk_size=16, num_heads=0)
    enc = None
    if cfg.encoder is not None:
        enc = dataclasses.replace(
            cfg.encoder, num_layers=2, d_model=d, num_heads=heads,
            num_kv_heads=kv, d_ff=4 * d, source_len=32)
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=0,
        d_ff=4 * d,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        moe=moe,
        ssm=ssm,
        encoder=enc,
    )
