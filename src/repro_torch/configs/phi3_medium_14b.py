"""Phi-3-medium 14B — dense RoPE/SwiGLU/GQA decoder.

[arXiv:2404.14219]  40L, d_model=5120, 40H (GQA kv=10), d_ff=17920,
vocab=100352.  Pure full attention: long_500k is served with the
sliding-window variant (serve_window_override) per DESIGN.md §4.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    tie_embeddings=False,
    source="arXiv:2404.14219 (Phi-3)",
))
