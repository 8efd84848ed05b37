"""The paper's Qwen2.5-Math triple: draft 1.5B / target 7B / PRM 7B.

[Qwen Team 2024; paper §5]  The PRM shares the 7B architecture plus a scalar
reward head (process rewards in [0,1]).
"""
from repro_torch.config import ModelConfig, register_config

DRAFT = register_config(ModelConfig(
    name="qwen2.5-math-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    source="hf:Qwen/Qwen2.5-Math-1.5B-Instruct (paper draft model)",
))

TARGET = register_config(ModelConfig(
    name="qwen2.5-math-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    tie_embeddings=False,
    source="hf:Qwen/Qwen2.5-Math-7B-Instruct (paper target model)",
))

PRM = register_config(ModelConfig(
    name="qwen2.5-math-prm-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    tie_embeddings=False,
    reward_head=True,
    source="hf:Qwen/Qwen2.5-Math-PRM-7B (paper PRM)",
))

TRIPLE = (DRAFT, TARGET, PRM)
