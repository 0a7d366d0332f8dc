"""qwen2-vl-2b — VLM decoder with M-RoPE, dynamic resolution [arXiv:2409.12191].

The ViT vision encoder + projector is the sanctioned stub: a batch holds
precomputed patch embeddings ``embeds`` (batch, seq, d_model); this
config describes the language-model backbone that consumes them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    rope_theta=1000000.0,
    modality="vision_stub",
    sliding_window_override=8192,
    source="arXiv:2409.12191 (Qwen2-VL); M-RoPE, GQA kv=2, QKV bias",
)
