"""RWKV6 "Finch" 3B: attention-free SSM with data-dependent decay.

[arXiv:2404.05892]  32L, d_model=2560, d_ff=8960, vocab=65536, 40 heads of
``rwkv_head_dim`` 64.  The decode state is O(1) per layer: a token-shift
vector for each mix and one (64, 64) fp32 WKV matrix per head.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # 2560 / rwkv_head_dim(64)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_dim=64,
    layer_pattern=("full",),  # unused by the ssm family (one block kind)
    tie_embeddings=False,
    source="arXiv:2404.05892 (RWKV-6 Finch)",
))
