"""SmolLM-135M — small llama-architecture dense decoder.

[hf:HuggingFaceTB/SmolLM-135M]  30L, d_model=576, 9H (GQA kv=3), d_ff=1536,
vocab=49152.  Canonical *draft* model in our GSI pairings; also the ~100M
scale used by the end-to-end training example.  long_500k via sliding-window
variant.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    rope_theta=1.0e4,
    source="hf:HuggingFaceTB/SmolLM-135M",
))
