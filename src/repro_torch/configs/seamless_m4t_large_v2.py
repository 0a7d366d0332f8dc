"""seamless-m4t-large-v2 — audio enc-dec, multimodal [arXiv:2308.11596].

The mel-spectrogram + conv feature extractor frontend is the sanctioned
stub: a batch holds precomputed frame embeddings ``frames`` (batch,
frames, d_model) for the encoder. This config describes the transformer
backbone (a text decoder with exits; the split point indexes decoder
layers).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,                 # decoder layers (exits attach here)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    modality="audio_stub",
    sliding_window_override=8192,   # decoder self-attn window for long_500k
    norm="layernorm",
    activation="gelu_mlp",
    encoder=EncoderConfig(num_layers=24, d_model=1024, num_heads=16,
                          num_kv_heads=16, d_ff=8192, source_len=4096),
    source="arXiv:2308.11596 (SeamlessM4T v2); enc-dec, GQA kv=16",
)
