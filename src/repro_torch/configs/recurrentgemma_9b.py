"""RecurrentGemma-9B (Griffin): RG-LRU recurrent blocks and local attention.

[arXiv:2402.19427]  38 layers, d_model 4096, 16 query heads over 1 kv head
(MQA) of 256, d_ff 12,288, vocab 256,000, RG-LRU width 4096.  Pattern:
(recurrent, recurrent, local attention over a 2048 window) repeated;
38 = 12 * 3 + 2 remainder recurrent layers.  Each recurrent layer's decode
state is O(1): an fp32 (lru_width,) vector and a 3-step conv tail.
"""
from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("recurrent", "recurrent", "local"),
    window_size=2048,
    lru_width=4096,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
))
