"""Configuration dataclasses and the architecture registry.

A copy of ``repro.config`` for the port (the port never imports ``repro``):
:class:`ModelConfig` describes an architecture, :class:`GSIConfig` the GSI
algorithm, :class:`TrainConfig` the optimizer and its schedule, and configs
register themselves into ``CONFIG_REGISTRY`` when ``repro_torch.configs`` is
imported.  Field names and defaults match the
reference, so a config built on either side describes the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

LAYER_FULL = "full"            # full causal self-attention
LAYER_LOCAL = "local"          # sliding-window causal self-attention
LAYER_RECURRENT = "recurrent"  # RG-LRU recurrent block (hybrid family)
LAYER_CROSS = "cross"          # self-attention + cross-attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- layer pattern --------------------------------------------------------
    layer_pattern: tuple = (LAYER_FULL,)
    window_size: int = 4096          # for LAYER_LOCAL

    # --- cross-modal ----------------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_source_seq: int = 0

    # --- rwkv / hybrid --------------------------------------------------------
    rwkv_head_dim: int = 64
    lru_width: int = 0               # 0 -> d_model

    # --- misc -----------------------------------------------------------------
    rope_theta: float = 1.0e6
    norm_eps: float = 1.0e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    remat: str = "none"
    scan_layers: bool = True         # reference groups layers into scan blocks
    serve_window_override: int = 0   # 0 = use layer kinds as-is
    reward_head: bool = False        # PRM head (reward models)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def pattern_remainder(self) -> tuple:
        rem = self.num_layers % len(self.layer_pattern)
        return tuple(self.layer_pattern[:rem])

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + encoder),
        counted as the reference counts it (MoE: the real experts and the
        router, not the padding experts the layout adds; a recurrent block:
        3 d w + 8 w, though its specs hold 5 d w; a cross block: two
        attention blocks, its norms uncounted; an encoder layer: 4 d^2 +
        3 d d_ff, whatever the head layout)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        pattern = list(self.layer_pattern) * self.pattern_repeats \
            + list(self.pattern_remainder)
        for kind in pattern:
            if self.family == "ssm":
                # r,k,v,o projections + decay/mix params; channel-mix
                total += 4 * d * d + 6 * d + 2 * d * int(3.5 * d)
                continue
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if kind == "recurrent":
                w = self.lru_width
                total += 2 * d * w + w * d + 2 * w * 4
            elif kind == LAYER_CROSS:
                total += 2 * attn              # self + cross
            else:
                total += attn
            if self.num_experts:
                total += (self.num_experts + self.num_shared_experts) \
                    * 3 * d * self.moe_d_ff + d * self.num_experts
            else:
                total += 3 * d * ff
        if self.encoder_layers:
            total += self.encoder_layers * (4 * d * d + 3 * d * ff)
        return int(total)


@dataclass(frozen=True)
class GSIConfig:
    n: int = 4                  # samples per reasoning step (draft side)
    n_target: int = 0           # resampling-side n (0 = same as n)
    beta: float = 20.0          # inverse temperature (paper default)
    threshold_u: float = 0.5    # acceptance threshold on tilted reward
    temperature: float = 0.7    # sampling temperature
    top_p: float = 1.0
    max_step_tokens: int = 64   # max tokens per reasoning step
    max_steps: int = 16         # max reasoning steps
    sep_token_id: int = 1       # "\n\n" stand-in
    eos_token_id: int = 2
    min_step_reward: float = 0.1  # early-stop if all draft rewards below (B.2)
    use_rejection: bool = True  # False = "GSI w/o rejection" ablation


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"  # bf16 for the 1T config (DESIGN §5)
    seed: int = 0


CONFIG_REGISTRY: dict = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    CONFIG_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in CONFIG_REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(CONFIG_REGISTRY)}")
    return CONFIG_REGISTRY[name]


def list_configs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(CONFIG_REGISTRY)


def reduced_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
                   vocab: int = 512, max_experts: int = 4) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (as the reference)."""
    num_heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(cfg.num_kv_heads, num_heads))
    while num_heads % kv:
        kv -= 1
    pat = cfg.layer_pattern[:max(1, min(len(cfg.layer_pattern), layers))]
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=kv,
        head_dim=d_model // num_heads,
        d_ff=int(d_model * 8 // 3) // 16 * 16 or 64,
        vocab_size=vocab,
        layer_pattern=pat,
        window_size=min(cfg.window_size, 64),
        rwkv_head_dim=min(cfg.rwkv_head_dim, d_model // num_heads),
        lru_width=d_model,
        dtype="float32",
        param_dtype="float32",
        scan_layers=cfg.scan_layers,
    )
    if cfg.num_experts:
        e = min(cfg.num_experts, max_experts)
        changes.update(
            num_experts=e,
            experts_per_token=min(cfg.experts_per_token, 2),
            num_shared_experts=min(cfg.num_shared_experts, 1),
            moe_d_ff=d_model // 2,
            capacity_factor=float(e),
        )
    if cfg.encoder_layers:
        changes.update(encoder_layers=2,
                       encoder_seq=max(16, min(cfg.encoder_seq, 32)))
    if cfg.cross_source_seq:
        changes.update(cross_source_seq=32)
    return dataclasses.replace(cfg, **changes)
