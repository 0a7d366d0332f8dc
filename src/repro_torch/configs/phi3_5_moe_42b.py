"""phi3.5-moe-42b-a6.6b — MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    rope_theta=10000.0,
    sliding_window_override=8192,
    moe=MoEConfig(num_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct; 16 experts top-2, GQA kv=8",
)
