"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", state_size=64, expand=2, chunk_size=128),
    hybrid_attn_every=6,       # one (shared) attention block every 6 mamba blocks
    source="arXiv:2411.15242 (Zamba2); Mamba2 + shared attn blocks, ssm_state=64",
)
