"""Architecture registry: importing this package registers every config."""
from repro_torch.configs import (  # noqa: F401
    deepseek_7b,
    gemma3_1b,
    kimi_k2_1t_a32b,
    llama32_vision_11b,
    phi3_medium_14b,
    qwen25_math,
    qwen2_moe_a27b,
    qwen3,
    recurrentgemma_9b,
    rwkv6_3b,
    seamless_m4t_medium,
    smollm_135m,
)

# The ten architectures assigned to this paper (public pool), as the
# reference lists them; the port registers all ten.
ASSIGNED = (
    "rwkv6-3b",
    "recurrentgemma-9b",
    "gemma3-1b",
    "kimi-k2-1t-a32b",
    "seamless-m4t-medium",
    "llama-3.2-vision-11b",
    "qwen2-moe-a2.7b",
    "phi3-medium-14b",
    "deepseek-7b",
    "smollm-135m",
)

# The paper's own model triples (draft / target / PRM).
PAPER_MODELS = (
    "qwen2.5-math-1.5b",
    "qwen2.5-math-7b",
    "qwen2.5-math-prm-7b",
    "qwen3-1.7b",
    "qwen3-14b",
)
