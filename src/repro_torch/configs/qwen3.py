"""The paper's Qwen3 pair: draft 1.7B / target 14B (thinking mode disabled).

[Qwen Team 2025; paper §5]
"""
from repro_torch.config import ModelConfig, register_config

DRAFT = register_config(ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    source="hf:Qwen/Qwen3-1.7B (paper draft model)",
))

TARGET = register_config(ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-14B (paper target model)",
))
