"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,              # wkv heads = d_model / head_size(64)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", state_size=64, num_heads=40, chunk_size=128),
    norm="layernorm",
    activation="gelu_mlp",     # rwkv channel-mix (squared relu in paper; gated mlp here)
    source="arXiv:2404.05892 (RWKV-6 Finch); data-dependent decay, attn-free",
)
