"""Gemma-3 1B: a dense decoder with 5 sliding-window layers per global one.

[hf:google/gemma-3-1b-pt]  26 layers, d_model 1152, 4 query heads over 1
kv head of 256, d_ff 6912, vocab 262,144.  Pattern: 5 sliding-window (512)
layers per global layer; 26 = 4 * 6 + 2 remainder local layers.  The
vocabulary of 262,144 is the largest the fused log-prob gather serves.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    layer_pattern=("local", "local", "local", "local", "local", "full"),
    window_size=512,
    rope_theta=1.0e6,
    source="hf:google/gemma-3-1b-pt",
))
