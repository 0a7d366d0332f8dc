"""deepseek-coder-33b — dense llama-arch GQA [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    sliding_window_override=8192,   # beyond-paper: enables long_500k decode
    source="arXiv:2401.14196 (DeepSeek-Coder); llama architecture, GQA kv=8",
)
