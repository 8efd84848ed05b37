"""Model-level parity in bf16: the port's rounding drift against the
reference's.

Every other model test runs in fp32 (``reduced_config`` sets it).  Here a
reduced ``qwen2.5-math-7b`` and a reduced ``rwkv6-3b`` (d 256, 4 layers;
the RWKV model's ``decay_base`` overwritten as the RWKV tests do, so its
state carries) get weights rounded to bf16.  Each side then runs its
``forward`` twice on the same tokens: in bf16 (weights and activations)
and in fp32 over the same bf16-rounded weights.  The bf16 run's largest
logit difference from the fp32 run is that side's drift.  The port's may
be at most 1.5 times the reference's: the two round at different points
(fused ops, summation order), so the drifts differ; a fault in a bf16
path (a lost cast, a product in the wrong type) would multiply the
port's.  The fp32 runs must agree to 1e-5 of the logits' scale, so the
drift is measured from the same point on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config, reduced_config
from repro.models import build_model
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)
RATIO = 1.5


def to_port(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def bf16_rounded(params, seed, rwkv):
    """numpy fp32 leaves holding bf16 values; RWKV ``decay_base`` first
    overwritten with a seeded U[-6, -0.5] (decays in about (0.54, 0.9975))."""
    params = jax.tree.map(np.asarray, params)
    if rwkv:
        rng = np.random.default_rng(100 + seed)
        for group in ("blocks", "rem"):
            for blk in (params.get(group) or {}).values():
                base = blk["tm"]["decay_base"]
                blk["tm"]["decay_base"] = rng.uniform(
                    -6.0, -0.5, base.shape).astype(base.dtype)
    return jax.tree.map(lambda x: np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)), params)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["qwen2.5-math-7b", "rwkv6-3b"])
def test_bf16_drift_within_reference_drift(name, seed):
    cfg = reduced_config(get_config(name), layers=4, d_model=256)
    params = bf16_rounded(build_model(cfg).init(jax.random.PRNGKey(seed)),
                          seed, rwkv="rwkv" in name)
    toks = np.random.default_rng(seed).integers(
        3, cfg.vocab_size, (2, 16)).astype(np.int32)
    V = cfg.vocab_size
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16",
                                param_dtype="bfloat16")

    def reference(c, p):
        logits = build_model(c).forward(p, jnp.asarray(toks))[0]
        return np.asarray(logits.astype(jnp.float32))[..., :V]

    def port(c, p):
        logits = Model(to_port(c), p).forward(torch.from_numpy(toks))[0]
        return logits.float().numpy()[..., :V]

    ref32 = reference(cfg, params)
    ref16 = reference(cfg16, jax.tree.map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16), params))
    tp = params_from_numpy(to_port(cfg), params)
    port32 = port(cfg, tp)
    port16 = port(cfg16, {k: v.bfloat16() for k, v in tp.items()})

    scale = np.abs(ref32).max()
    assert np.abs(port32 - ref32).max() <= 1e-5 * max(scale, 1.0)
    ref_drift = np.abs(ref16 - ref32).max()
    port_drift = np.abs(port16 - port32).max()
    assert ref_drift > 1e-3 * scale          # bf16 really ran on both sides
    assert port_drift > 1e-3 * scale
    assert port_drift <= RATIO * ref_drift, (port_drift, ref_drift)
