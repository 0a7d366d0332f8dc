"""elasticbert12 — the paper's own testbed geometry (BERT-base, 12 layers).

Classification exits, one head per layer; ``num_classes`` is set per task
at run time with ``dataclasses.replace``.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="elasticbert12",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    num_classes=2,
    causal=False,
    norm="layernorm",
    activation="gelu_mlp",
    exits=ExitConfig(enabled=True, stride=1, share_head=False),
    source="arXiv:2110.07038 (ElasticBERT); BERT-base backbone, exit/layer",
)
