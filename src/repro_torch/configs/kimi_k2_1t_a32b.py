"""Kimi K2 — trillion-parameter MoE (paper-table config).

[arXiv:2501.kimi2]  61L, d_model=7168, 64H (GQA kv=8), per-expert d_ff=2048,
vocab=163840, MoE 384 routed experts top-8 (+1 shared).  About 1T
parameters: one card cannot hold it, and the port has no expert
parallelism yet, so the port registers it and holds its reduced variant
to the reference on the CPU; serving it waits for several cards.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (Kimi K2)",
))
