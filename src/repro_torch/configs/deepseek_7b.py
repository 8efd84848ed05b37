"""DeepSeek-LLM 7B — llama-architecture dense decoder (MHA: kv = heads).

[arXiv:2401.02954]  30L, d_model=4096, 32H (kv=32), d_ff=11008, vocab=102400.
Canonical *target* model in our GSI pairings.  long_500k via sliding-window
variant.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    rope_theta=1.0e4,
    tie_embeddings=False,
    source="arXiv:2401.02954 (DeepSeek LLM)",
))
