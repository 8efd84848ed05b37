"""Llama-3.2-Vision 11B: a dense decoder with interleaved cross-attention
image layers.

[hf:meta-llama/Llama-3.2-11B-Vision]  40 layers, d_model 4096, 32 query
heads over 8 kv heads of 128, d_ff 14336, vocab 128,256.  A cross-attention
layer at every 5th position (pattern index 3: layers 3, 8, 13, ..., 38;
40 = 8 * 5).  The ViT vision encoder and its projector are stubbed: the
caller passes patch embeddings of shape (batch, cross_source_seq, d_model).
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    layer_pattern=("full", "full", "full", "cross", "full"),
    cross_source_seq=6404,      # 4 tiles x 1601 patch embeddings
    rope_theta=5.0e5,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
