"""Architecture registry: importing this package registers every config."""
from repro_torch.configs import qwen25_math, rwkv6_3b  # noqa: F401

# The paper's own model triple (draft / target / PRM).
PAPER_MODELS = (
    "qwen2.5-math-1.5b",
    "qwen2.5-math-7b",
    "qwen2.5-math-prm-7b",
)
