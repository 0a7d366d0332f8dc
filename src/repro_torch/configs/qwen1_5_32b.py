"""qwen1.5-32b — dense, QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    sliding_window_override=8192,
    source="hf:Qwen/Qwen1.5 family card; QKV bias, kv=40 (MHA)",
)
