"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B]  24L, d_model=2048, 16H (kv=16), per-expert
d_ff=1408, vocab=151936.  The HF card's shared-expert intermediate (5632) is
modelled as 4 shared experts of 1408.  The 60 routed experts are laid out
padded to 64 (``repro_torch.models.moe.padded_experts``), as the reference
lays them out; the padding experts get no traffic.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
