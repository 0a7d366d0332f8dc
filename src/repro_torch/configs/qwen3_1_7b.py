"""qwen3-1.7b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    sliding_window_override=8192,
    source="hf:Qwen/Qwen3-8B family card; qk_norm, GQA kv=8",
)
