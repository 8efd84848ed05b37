"""The port's cross-attention and encoder families against ``repro`` on the
CPU.

``llama-3.2-vision-11b`` (a ``cross`` layer among ``full`` ones, over patch
embeddings) and ``seamless-m4t-medium`` (a bidirectional ``enc`` stack over
frame embeddings, every decoder layer ``cross``) at their ``reduced_config``
sizes (d 128, 2 encoder layers, sources of 32), fp32, from the reference's
own weights carried across by the numpy bridge and seeded numpy inputs:

* the configs and their full-width parameter specs, ``block_specs`` of the
  ``cross`` kind;
* flash attention's plain version with ``causal=False`` at Sq != Sk (the
  encoder's and the cross step's route) against the reference's
  ``gqa_attention``;
* ``encode``; ``forward``, ``hidden``, ``prefill`` (logits and every cache
  leaf, ``ck``/``cv`` included), decode steps from the prefilled cache,
  ``score`` and the PRM's ``reward`` with a source, for both configs;
* shared scoring (``score_candidates``) over a prefilled cache with cross
  layers;
* GSI engines over a cross triple for 3 steps at temperature 0 in all five
  modes, spread over dense and paged caches with shared scoring off and
  on, with a source's cross
  KV written into every slot after admission (the engine takes no source;
  its cross KV is otherwise zero, which a dropped cross layer would pass);
* a train step with a source (loss and gradients) against the reference's
  ``make_train_step(cfg, tcfg, with_source=True)``;
* ``serve.main(["--config", "seamless", "--device", "cpu", "--layers",
  "1", ...])`` over the reduced triple.

Each case holds a control: a second source moves the outputs by far more
than the tolerance.  fp32 values are held to 1e-5 of their scale; tokens,
accepts and positions must be identical, rewards within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig as JGSIConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config, reduced_config
from repro.models import blocks as jblocks
from repro.models import build_model
from repro.models import scoring as jscoring
from repro.models.attention import gqa_attention
from repro.rewards import PRM as JPRM
from repro.serving import GSIServingEngine as JEngine
from repro.train import make_train_step as jmake_train_step
from repro_torch.config import GSIConfig, ModelConfig, TrainConfig
from repro_torch.config import get_config as tget_config
from repro_torch.config import reduced_config as treduced_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve
from repro_torch.models import Model, blocks, layer_slots, param_specs
from repro_torch.models import scoring
from repro_torch.models.bridge import cache_to_numpy, params_from_numpy
from repro_torch.rewards import PRM
from repro_torch.serving import GSIServingEngine
from repro_torch.train import make_train_step

torch.set_num_threads(1)
RTOL = 1e-5
GREEDY = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
              temperature=0.0, min_step_reward=-1.0)
ARCHS = {"llama-vision": ("llama-3.2-vision-11b", 4),   # full x 3, cross
         "seamless": ("seamless-m4t-medium", 2)}        # cross x 2, enc x 2


def to_port(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1.0),
                               rtol=0)


def _moved(a, b, rtol=RTOL):
    """The control: ``a`` and ``b`` differ by far more than the tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() > 1e3 * rtol * max(np.abs(b).max(), 1.0)


def _reduced(which, reward_head=False):
    name, layers = ARCHS[which]
    cfg = reduced_config(get_config(name), layers=layers)
    return dataclasses.replace(cfg, reward_head=reward_head)


def _build(cfg, seed=0):
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(seed)))
    tcfg = to_port(cfg)
    return params, tcfg, Model(tcfg, params_from_numpy(tcfg, params))


def _tokens(cfg, B=2, S=20, seed=1):
    return np.random.default_rng(seed).integers(
        3, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _source(cfg, B=2, seed=2):
    """N(0, 1) frames (seamless) or patch embeddings (llama-vision)."""
    S = cfg.encoder_seq or cfg.cross_source_seq
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ----------------------------------------------------------------------
# Configs and specs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", list(ARCHS))
def test_config_and_full_width_specs_match_reference(which):
    """Field by field, ``param_count`` (a cross layer as two attention
    blocks, the encoder stack counted) and every parameter's name and
    shape at full width against ``jax.eval_shape`` of the reference's
    tree."""
    name = ARCHS[which][0]
    jcfg, cfg = get_config(name), tget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    want = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    got = param_specs(cfg)
    flat = {}
    for i, (_, group, key, index) in enumerate(layer_slots(cfg)):
        for leaf, s in jax.tree_util.tree_flatten_with_path(
                want[group][key])[0]:
            names = ".".join(p.key for p in leaf)
            flat[f"layers.{i}.{names}"] = tuple(
                s.shape[1:] if index is not None else s.shape)
    for leaf, s in jax.tree_util.tree_flatten_with_path(
            want.get("encoder", {}).get("blocks", {}))[0]:
        names = ".".join(p.key for p in leaf)
        for i in range(cfg.encoder_layers):
            flat[f"encoder.blocks.{i}.{names}"] = tuple(s.shape[1:])
    if cfg.encoder_layers:
        flat["encoder.final_ln"] = tuple(want["encoder"]["final_ln"].shape)
    flat["final_ln"] = tuple(want["final_ln"].shape)
    for k, s in want["embed"].items():
        flat[f"embed.{k}"] = tuple(s.shape)
    assert {k: s.shape for k, s in got.items()} == flat
    cross = [i for i, (kind, *_) in enumerate(layer_slots(cfg))
             if kind == "cross"]
    assert cross == ([3, 8, 13, 18, 23, 28, 33, 38]
                     if which == "llama-vision" else list(range(12)))


def test_block_specs_cross_match_reference():
    cfg = _reduced("llama-vision")
    want = jblocks.block_specs(cfg, "cross")
    got = blocks.block_specs(to_port(cfg), "cross")
    flat = {".".join(p.key for p in path): (tuple(s.shape), tuple(s.axes))
            for path, s in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {k: (s.shape, tuple(s.axes)) for k, s in got.items()} == flat
    assert "lnx" in got and "xattn.wq" in got


# ----------------------------------------------------------------------
# Non-causal flash attention (the plain version, the CPU's route)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,H,KV", [(7, 32, 4, 2), (32, 32, 4, 4),
                                        (9, 70, 8, 1)])
def test_noncausal_flash_plain_matches_gqa_attention(Sq, Sk, H, KV):
    rng = np.random.default_rng(Sq + Sk)
    hd = 16
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k, v, k2 = (rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
                for _ in range(3))
    want = gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.ones((1, Sq, Sk), bool), hd ** -0.5)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    _close(got.numpy(), want)
    other = flash_attention_plain(*map(torch.from_numpy, (q, k2, v)),
                                  causal=False)
    _moved(other.numpy(), want)


# ----------------------------------------------------------------------
# Models
# ----------------------------------------------------------------------

def test_encode_matches_reference():
    cfg = _reduced("seamless")
    params, tcfg, model = _build(cfg, seed=1)
    frames = _source(cfg, seed=3)
    want = build_model(cfg).encode(params, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    _close(got.numpy(), want)
    _moved(model.encode(torch.from_numpy(_source(cfg, seed=4))).numpy(),
           want)


@pytest.mark.parametrize("which", list(ARCHS))
def test_model_matches_reference(which):
    """forward, hidden, score, the PRM's reward; prefill's logits and
    caches (``k``/``v`` and ``ck``/``cv``, through ``cache_to_numpy``);
    then decode steps from the prefilled cache, each against the
    reference's and against forward."""
    cfg = _reduced(which, reward_head=True)
    params, tcfg, model = _build(cfg, seed=3)
    jm = build_model(cfg)
    B, S, S0 = 2, 20, 7
    V = cfg.vocab_size
    toks, src = _tokens(cfg, B, S, seed=4), _source(cfg, B, seed=5)
    jt, js = jnp.asarray(toks), jnp.asarray(src)
    tt, ts = torch.from_numpy(toks), torch.from_numpy(src)
    full = np.asarray(jm.forward(params, jt, source=js)[0])[..., :V]
    tl, _ = model.forward(tt, source=ts)
    _close(tl[..., :V].numpy(), full)
    # control: another source moves the logits (no cross layer dropped)
    _moved(model.forward(tt, source=torch.from_numpy(
        _source(cfg, B, seed=6)))[0][..., :V].numpy(), full)
    # hidden through the unembedding is forward's (held above)
    h = model.hidden(tt, source=ts)
    _close((h @ model.embed["unembed"])[..., :V].numpy(), full)
    _close(model.score(tt, source=ts).numpy(),
           jm.score(params, jt, source=js))
    lengths = np.array([S, 9], np.int32)
    want_r = JPRM(cfg, params).reward_at_end(jt, jnp.asarray(lengths),
                                              source=js)
    prm = PRM(tcfg, params_from_numpy(tcfg, params), device="cpu")
    _close(prm.reward_at_end(tt, torch.from_numpy(lengths),
                             source=ts).numpy(), want_r)
    _close(model.reward(tt, source=ts)[[0, 1], lengths - 1].numpy(), want_r)
    jl, jc = jm.prefill(params, jt[:, :S0], source=js, max_seq=S)
    tl, tc = model.prefill(tt[:, :S0], source=ts, max_seq=S)
    _close(tl[:, :V].numpy(), np.asarray(jl)[:, :V])
    want = jax.tree.map(np.asarray, jc)
    got = cache_to_numpy(tcfg, tc)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        _close(g, w)
    assert all("ck" in c for c, k in zip(tc, model.kinds) if k == "cross")
    step = jax.jit(jm.decode_step)
    for t in range(S0, S):
        lj, jc = step(params, jc, jt[:, t:t + 1], jnp.full((B,), t,
                                                           jnp.int32))
        lt = model.decode_step(tc, tt[:, t:t + 1],
                               torch.full((B,), t))[:, :V].numpy()
        _close(lt, np.asarray(lj)[:, :V])
        _close(lt, full[:, t])


def test_source_needed_and_ignored():
    """A cross stack without a source raises; a stack with no cross layer
    ignores one, as the reference does."""
    cfg = _reduced("seamless")
    _, _, model = _build(cfg)
    toks = torch.from_numpy(_tokens(cfg, S=6))
    with pytest.raises(ValueError):
        model.forward(toks)
    plain = dataclasses.replace(_reduced("llama-vision"), num_layers=2,
                                layer_pattern=("full", "full"))
    jparams, tcfg, m2 = _build(plain)
    src = torch.from_numpy(_source(_reduced("llama-vision")))
    _close(m2.forward(toks, source=src)[0].numpy(),
           m2.forward(toks)[0].numpy(), 0.0)


def test_fp32_source_over_bf16_activations_as_reference():
    """llama-vision with bf16 activations and an fp32 source (what
    ``Trainer`` hands over): the source keeps its dtype on both sides, so
    prefill's cross KV is fp32 and equal to the reference's, and the
    promoted cross step's logits agree within bf16's rounding.  Unscanned
    layers: the reference's layer scan refuses the promoted carry."""
    cfg = dataclasses.replace(_reduced("llama-vision"), dtype="bfloat16",
                              scan_layers=False)
    params, tcfg, model = _build(cfg, seed=7)
    jm = build_model(cfg)
    V = cfg.vocab_size
    toks, src = _tokens(cfg, 2, 9, seed=8), _source(cfg, 2, seed=9)
    jl, jc = jm.prefill(params, jnp.asarray(toks), source=jnp.asarray(src),
                        max_seq=12)
    tl, tc = model.prefill(torch.from_numpy(toks),
                           source=torch.from_numpy(src), max_seq=12)
    want = cache_to_numpy(tcfg, tc)
    for (kind, group, key, index), layer in zip(layer_slots(tcfg), tc):
        if kind != "cross":
            continue
        for leaf in ("ck", "cv"):
            ref = np.asarray(jc[group][key][leaf])
            ref = ref if index is None else ref[index]
            assert layer[leaf].dtype == torch.float32 and ref.dtype == \
                np.float32
            _close(layer[leaf].numpy(), ref)
    del want
    got, ref = tl[:, :V].float().numpy(), np.asarray(jl, np.float32)[:, :V]
    _close(got, ref, 2e-2)
    other = model.prefill(torch.from_numpy(toks), source=torch.from_numpy(
        _source(cfg, 2, seed=10)), max_seq=12)[0][:, :V].float().numpy()
    _moved(other, ref, 2e-2 / 1e2)


# ----------------------------------------------------------------------
# Shared scoring
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", list(ARCHS))
def test_score_candidates_with_cross_layers(which):
    """n candidates scored against one prefilled cache (its cross KV from a
    source, repeated n ways in every cross layer) against the
    reference's, with the PRM's rewards."""
    cfg = _reduced(which, reward_head=True)
    params, tcfg, model = _build(cfg, seed=7)
    jm = build_model(cfg)
    B, n, L, S0 = 2, 3, 5, 9
    toks = _tokens(cfg, B, S0, seed=8)
    cands = _tokens(cfg, B * n, L, seed=9).reshape(B, n, L)
    cands[0, 1, 3:] = 0                                  # PAD-padded
    pending = toks[:, -1]
    pos = np.full((B,), S0 - 1)

    def port(src):
        _, cache = model.prefill(torch.from_numpy(toks[:, :-1]),
                                 source=torch.from_numpy(src), max_seq=32)
        return scoring.score_candidates(
            model, cache, torch.from_numpy(pending).long(),
            torch.from_numpy(pos), torch.from_numpy(cands).long(),
            return_rewards=True)

    src = _source(cfg, B, seed=10)
    _, jc = jm.prefill(params, jnp.asarray(toks[:, :-1]),
                       source=jnp.asarray(src), max_seq=32)
    jlp, jr = jscoring.score_candidates(
        jm, params, jc, jnp.asarray(pending), jnp.asarray(pos),
        jnp.asarray(cands), return_rewards=True)
    lp, r = port(src)
    _close(lp.numpy(), jlp)
    _close(r.numpy(), jr, 1e-4)
    _moved(port(_source(cfg, B, seed=11))[0].numpy(), jlp)


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def triple():
    """A cross triple: a (full, cross) draft, a 3-layer target (the
    pattern plus a full remainder layer) and its PRM; d 64, 4 heads over 2
    kv heads of 16, sources of 12, vocab 64, fp32."""
    draft = JModelConfig(
        name="vx-draft", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64, head_dim=16,
        layer_pattern=("full", "cross"), cross_source_seq=12,
        tie_embeddings=False, dtype="float32", param_dtype="float32")
    target = dataclasses.replace(draft, name="vx-target", num_layers=3)
    prm = dataclasses.replace(target, name="vx-prm", reward_head=True)
    cfgs = (draft, target, prm)
    params = [jax.tree.map(np.asarray, build_model(c).init(
        jax.random.PRNGKey(10 + i))) for i, c in enumerate(cfgs)]
    tcfgs = [to_port(c) for c in cfgs]
    tparams = [params_from_numpy(tc, p) for tc, p in zip(tcfgs, params)]
    return cfgs, [jax.tree.map(jnp.asarray, p) for p in params], tcfgs, \
        tparams


def _prompts():
    rng = np.random.default_rng(0)
    prompts = np.zeros((3, 9), np.int32)
    for b, n in enumerate([9, 4, 6]):
        prompts[b, :n] = rng.integers(3, 64, n)
    return prompts


def _write_cross_kv(tcfg, tcache, jcache, seed):
    """Seeded N(0, 1) cross KV into every cross layer of both engines'
    committed caches (port: in place; returns the reference's tree)."""
    rng = np.random.default_rng(seed)
    if jcache is not None:
        jcache = jax.tree.map(np.array, jcache)
    for i, (kind, group, key, index) in enumerate(layer_slots(tcfg)):
        if kind != "cross":
            continue
        for leaf in ("ck", "cv"):
            val = rng.standard_normal(
                tuple(tcache[i][leaf].shape)).astype(np.float32)
            tcache[i][leaf].copy_(torch.from_numpy(val))
            if jcache is None:
                continue
            if index is None:
                jcache[group][key][leaf] = val
            else:
                jcache[group][key][leaf][index] = val
    return None if jcache is None else jax.tree.map(jnp.asarray, jcache)


# (mode, engine options): the five modes spread over the four layouts
# (dense or paged, shared scoring off or on), gsi in two of them
ENGINE_CASES = {
    "gsi-paged-shared": ("gsi", dict(paged=True, shared_scoring=True)),
    "gsi-dense": ("gsi", dict()),
    "gsi_norej-paged": ("gsi_norej", dict(paged=True)),
    "rsd-dense-shared": ("rsd", dict(shared_scoring=True)),
    "sbon_s-paged": ("sbon_s", dict(paged=True)),
    "sbon_b-paged-shared": ("sbon_b", dict(paged=True, shared_scoring=True)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_steps_match_reference(triple, case):
    cfgs, params, tcfgs, tparams = triple
    mode, opts = ENGINE_CASES[case]
    g = dict(GREEDY, threshold_u=0.5)
    kw = dict(mode=mode, max_seq=48, page_size=8, **opts)
    je = JEngine(*cfgs, *params, JGSIConfig(**g), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, GSIConfig(**g), device="cpu",
                          **kw)
    assert te.prefix_cache is False and je.prefix_cache is False
    prompts = _prompts()
    mask = np.ones(len(prompts), bool)
    assert te.cache_memory_report(3) == je.cache_memory_report(3)

    def run(seed, with_reference):
        js = je.admit(je.fresh_state(len(prompts)), mask, prompts) \
            if with_reference else None
        ts = te.admit(te.fresh_state(len(prompts)), mask, prompts)
        for name, tc in zip("SBP", tcfgs):
            jc = _write_cross_kv(tc, ts["caches"][name],
                                 js["caches"][name] if js else None, seed)
            if js:
                js["caches"][name] = jc
        key = jax.random.PRNGKey(0)
        gen = torch.Generator().manual_seed(0)
        out = []
        for _ in range(3 if with_reference else 1):
            ts, tr = te.step_decode(ts, gen)
            if js:
                key, k1, k2 = jax.random.split(key, 3)
                js, jr = je.step_decode(js, k1, k2)
                np.testing.assert_array_equal(tr.chosen,
                                              np.asarray(jr.chosen))
                np.testing.assert_array_equal(tr.accept, jr.accept)
                np.testing.assert_array_equal(tr.done, jr.done)
                np.testing.assert_array_equal(tr.pos, jr.pos)
                if jr.rewards is not None:
                    np.testing.assert_allclose(tr.rewards, jr.rewards,
                                               atol=1e-4, rtol=0)
            out.append(tr)
        return out, ts

    steps, ts = run(20, True)
    # the cross KV rides through admission, branching and commit
    for name, tc in zip("SBP", tcfgs):
        cache = ts["caches"][name]
        for (kind, *_), layer in zip(layer_slots(tc), cache):
            if kind == "cross":
                assert layer["ck"].shape == (3, 12, 2, 16) and \
                    layer["ck"].abs().max() > 0
    # control: other cross KV moves the first step's rewards or tokens
    other, _ = run(21, False)
    r0, r1 = steps[0], other[0]
    if r0.rewards is not None:
        assert np.abs(np.asarray(r0.rewards)
                      - np.asarray(r1.rewards)).max() > 1e-2
    else:
        assert not np.array_equal(r0.chosen, r1.chosen)


def test_serve_cli_seamless_on_cpu(capsys, monkeypatch):
    """The CLI's cross triple, its three models swapped for their reduced
    variants (the published triple is GB-sized): two text-only requests
    through the pipelined scheduler over pages, ``--layers 1`` cutting the
    decoder and the encoder alike."""
    full = serve.build_triple("seamless")
    small = tuple(treduced_config(c) for c in full)
    monkeypatch.setitem(serve.TRIPLES, "seamless", lambda: small)
    serve.main(["--config", "seamless", "--device", "cpu", "--layers", "1",
                "--requests", "2", "--max-steps", "1", "--max-step-tokens",
                "4", "--paged"])
    out = capsys.readouterr().out
    assert "seamless (1 layers)" in out and "finished=2/2" in out
    cfgs = serve.build_triple("seamless", layers=1)
    assert [c.layer_pattern for c in cfgs] == [("cross",)] * 3
    assert cfgs[2].reward_head and cfgs[0].encoder_layers == 1
    monkeypatch.undo()
    assert full[0].name == "seamless-m4t-medium" and full[2].reward_head
    vision = serve.build_triple("llama-vision")
    assert vision[0].name == "llama-3.2-vision-11b" and vision[2].reward_head
    cut = serve.build_triple("seamless", layers=3)
    assert cut[0].num_layers == 3 and cut[0].encoder_layers == 3


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", list(ARCHS))
def test_train_step_with_source_matches_reference(which):
    """One step of ``make_train_step(..., with_source=True)`` on both
    sides: loss, grad norm, every gradient (port: autograd through the
    encoder's and the cross layers' non-causal flash attention) and the
    updated parameters."""
    cfg = _reduced(which)
    params, tcfg, _ = _build(cfg, seed=12)
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=13)
    mask = np.ones((B, S), np.float32)
    mask[1, 8:] = 0
    src = _source(cfg, B, seed=14)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    jbatch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask),
              "source": jnp.asarray(src)}
    jstep = jax.jit(jmake_train_step(cfg, JTrainConfig(**kw),
                                     with_source=True))
    from repro.optim import AdamW as JAdamW
    jparams = jax.tree.map(jnp.asarray, params)
    _, _, jm = jstep(jparams, JAdamW(JTrainConfig(**kw)).init(jparams),
                        jbatch)
    from repro.train import lm_loss as jlm_loss
    jmodel = build_model(cfg)
    grads = jax.jit(jax.grad(lambda p: jlm_loss(
        jmodel, p, jbatch, source=jbatch["source"])[0]))(jparams)

    from repro_torch.optim import AdamW
    model = Model(tcfg, params_from_numpy(tcfg, params), trainable=True)
    named = dict(model.named_parameters())
    batch = {"tokens": torch.from_numpy(toks).long(),
             "loss_mask": torch.from_numpy(mask),
             "source": torch.from_numpy(src)}
    from repro_torch.train import lm_loss
    loss, _ = lm_loss(model, batch, source=batch["source"])
    tgrads = torch.autograd.grad(loss, list(named.values()))
    want_g = params_from_numpy(tcfg, jax.tree.map(np.asarray, grads))
    assert set(want_g) == set(named)
    for (k, _), gr in zip(named.items(), tgrads):
        _close(gr.numpy(), want_g[k].numpy())
    assert any(k.startswith("encoder.") for k in named) == (
        which == "seamless")
    # control: another source moves the loss
    other, _ = lm_loss(model, batch, source=torch.from_numpy(
        _source(cfg, B, seed=15)))
    assert abs(float(other.detach()) - float(loss.detach())) > 1e-3
    # the step itself: its loss and grad norm, and every parameter moved
    # (the updates are not compared: Adam's first m / sqrt(v) is the sign
    # of the gradient, which rounding flips where a gradient is near 0)
    start = {k: p.detach().clone() for k, p in named.items()}
    opt = AdamW(TrainConfig(**kw))
    step = make_train_step(model, TrainConfig(**kw), with_source=True)
    tparams, _, tm = step(named, opt.init(named), batch)
    _close(float(tm["loss"]), float(jm["loss"]))
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    assert all(not torch.equal(p.detach(), start[k])
               for k, p in tparams.items())
