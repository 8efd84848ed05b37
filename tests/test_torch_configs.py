"""The port's config registry against ``repro.configs``.

Every architecture the port registers equals the reference's field by
field, and a ``decode_step`` of its ``reduced_config`` on the reference's
weights (carried across by the numpy bridge) gives the reference's logits
within 1e-5 of their scale, dense cache, three steps.  The serving CLI's
triples name registered configs on one tokenizer; a family with no
tokenizer shared with the Qwen PRM serves one model's shape three times.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.models import build_model
import repro_torch.configs as tconfigs
from repro_torch.config import get_config, list_configs, reduced_config
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)
RTOL = 1e-5
PORTED = ("deepseek-7b", "gemma3-1b", "kimi-k2-1t-a32b",
          "llama-3.2-vision-11b", "phi3-medium-14b", "qwen2-moe-a2.7b",
          "qwen2.5-math-1.5b", "qwen2.5-math-7b", "qwen2.5-math-prm-7b",
          "qwen3-1.7b", "qwen3-14b", "recurrentgemma-9b", "rwkv6-3b",
          "seamless-m4t-medium", "smollm-135m")


def test_registry_and_tuples_match_reference():
    assert tuple(list_configs()) == PORTED
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert tconfigs.PAPER_MODELS == jconfigs.PAPER_MODELS
    for name in tconfigs.PAPER_MODELS:
        get_config(name)


@pytest.mark.parametrize("name", PORTED)
def test_config_and_reduced_decode_match_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    small, jsmall = reduced_config(cfg), jreduced_config(jcfg)
    assert dataclasses.asdict(small) == dataclasses.asdict(jsmall)
    jm = build_model(jsmall)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    model = Model(small, params_from_numpy(small, jax.tree.map(np.asarray,
                                                               params)))
    B, S = 2, 8
    jc, tc = jm.init_cache(B, S), model.init_cache(B, S)
    jstep = jax.jit(jm.decode_step)
    rng = np.random.default_rng(1)
    pos = np.array([0, 2])
    for _ in range(3):
        tok = rng.integers(3, small.vocab_size, size=(B, 1))
        lj, jc = jstep(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt = model.decode_step(tc, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        V = small.vocab_size
        want = np.asarray(lj)[:, :V]
        np.testing.assert_allclose(lt.numpy()[:, :V], want,
                                   atol=RTOL * np.abs(want).max(), rtol=0)
        pos = pos + 1


@pytest.mark.parametrize("triple,names", [
    ("qwen2-moe", ("qwen2.5-math-1.5b", "qwen2-moe-a2.7b",
                   "qwen2.5-math-prm-7b")),
    ("qwen3", ("qwen3-1.7b", "qwen3-14b", "qwen2.5-math-prm-7b"))])
def test_serve_triples(triple, names):
    cfgs = serve.build_triple(triple)
    assert tuple(c.name for c in cfgs) == names
    assert all(c == get_config(c.name) for c in cfgs)
    # one tokenizer: the PRM's larger vocabulary only pads the others'
    assert cfgs[0].vocab_size == cfgs[1].vocab_size == 151_936
    assert cfgs[2].vocab_size >= cfgs[1].vocab_size
    cut = serve.build_triple(triple, layers=2)
    assert all(c.num_layers == 2 and c.d_model == f.d_model
               for c, f in zip(cut, cfgs))


@pytest.mark.parametrize("triple,name", [("rwkv6-3b", "rwkv6-3b"),
                                         ("gemma3", "gemma3-1b"),
                                         ("recurrentgemma",
                                          "recurrentgemma-9b"),
                                         ("llama-vision",
                                          "llama-3.2-vision-11b"),
                                         ("seamless",
                                          "seamless-m4t-medium")])
def test_self_triples(triple, name):
    """One model's shape as draft, target and PRM (the reward head
    added): each family keeps its own vocabulary."""
    draft, target, prm = serve.build_triple(triple)
    assert draft == target == get_config(name)
    assert prm.name == f"{name}-prm" and prm.reward_head
    assert dataclasses.replace(prm, name=name, reward_head=False) == draft
