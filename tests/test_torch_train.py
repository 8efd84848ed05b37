"""The port's training slice against ``repro`` on the CPU.

Same numpy-seeded inputs on both sides, fp32, held to 1e-5 of each
value's scale (the port's parity rule) unless a case says otherwise:

* flash attention's backward: ``flash_attention_bwd_plain``, the
  ``FlashAttention`` autograd Function's CPU backward (through
  ``ops.flash_attention``) and torch autograd of ``flash_attention_plain``
  against ``jax.vjp`` of the reference's ``gqa_attention`` over
  ``causal_mask`` (G 1, 2 and 7 at head_dim 16, G 4 and 16 at the Gemma
  families' 256; no window, one that binds and one of 8);
* ``lm_loss`` and ``prm_loss`` values and gradients on the toy dense
  triple's models, a reduced ``rwkv6-3b`` (the WKV6 scan's autograd
  Function, decays overwritten so the state carries), a reduced
  ``gemma3-1b`` at head_dim 256 (windows that bind), a reduced
  ``recurrentgemma-9b`` (``lam`` overwritten so the RG-LRU state carries)
  and a reduced ``qwen2-moe-a2.7b`` at a capacity factor that drops
  routed slots, against ``jax.value_and_grad``;
* ``AdamW`` over 3 updates (clipping engaged, warmup then the cosine
  phase), fp32 and bf16 moment state;
* ``Trainer`` for 3 steps against the reference's, from the same weights;
* checkpoints (round trip with bf16, mismatch errors, a failed write
  leaves nothing behind);
* the CLIs: ``launch.train --device cpu --reduced --steps 2`` and
  ``launch.serve --config toy --device cpu --train-steps 10``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget_config
from repro.config import reduced_config as jreduced_config
from repro.data import SyntheticReasoningTask
from repro.launch.serve import toy_triple as jtoy_triple
from repro.models import build_model
from repro.models.attention import causal_mask, gqa_attention
from repro.optim import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import lm_loss as jlm_loss
from repro.train import prm_loss as jprm_loss
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.config import TrainConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.models import Model, moe
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.train import Trainer, lm_loss, prm_loss

torch.set_num_threads(1)
RTOL = 1e-5


def to_port(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# ----------------------------------------------------------------------
# flash attention's backward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5, 8])      # 5 and 8 bind at S 23
@pytest.mark.parametrize("H,KV,hd", [
    pytest.param(4, 4, 16, id="4-4"), pytest.param(4, 2, 16, id="4-2"),
    pytest.param(14, 2, 16, id="14-2"),                  # G 1, 2, 7
    pytest.param(4, 1, 256, id="4-1-hd256"),             # gemma3's G 4
    pytest.param(16, 1, 256, id="16-1-hd256")])          # recurrentgemma's
def test_flash_backward_matches_jax_vjp(H, KV, hd, window):
    rng = np.random.default_rng(H + KV + window + hd)
    B, S = 2, 23
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    scale = hd ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: gqa_attention(
        a, b, c, causal_mask(S, S, window=window), scale), q, k, v)
    want = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    # the plain backward on the plain forward's output
    tout = flash_attention_plain(tq, tk, tv, window=window).detach()
    _close(tout, out)
    plain = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                      tout, tdo, window=window)
    # the autograd Function (what a train step runs) and torch autograd
    fn = torch.autograd.grad(ops.flash_attention(tq, tk, tv, window=window),
                             (tq, tk, tv), tdo)
    auto = torch.autograd.grad(flash_attention_plain(tq, tk, tv,
                                                     window=window),
                               (tq, tk, tv), tdo)
    for got in (plain, fn, auto):
        for g, w in zip(got, want):
            _close(g, w)


# ----------------------------------------------------------------------
# losses and gradients
# ----------------------------------------------------------------------

def _carry_decays(params, seed):
    """Every RWKV ``decay_base`` overwritten by a seeded uniform in
    [-6, -0.5], so the WKV state carries from token to token."""
    rng = np.random.default_rng(seed)
    for group in ("blocks", "rem"):
        for blk in (params.get(group) or {}).values():
            if "tm" not in blk:
                continue
            base = blk["tm"]["decay_base"]
            blk["tm"]["decay_base"] = rng.uniform(
                -6.0, -0.5, base.shape).astype(base.dtype)
    return params


def _carry_lru(params, seed):
    """Every RG-LRU ``lam`` overwritten by a seeded U[-9, -4], so the
    recurrent state carries (at the seeded init it forgets every step)."""
    rng = np.random.default_rng(seed)
    for group in ("blocks", "rem"):
        for blk in (params.get(group) or {}).values():
            if "rec" in blk:
                lam = blk["rec"]["lam"]
                blk["rec"]["lam"] = rng.uniform(-9.0, -4.0, lam.shape).astype(
                    lam.dtype)
    return params


def family_config(name):
    """The reduced reference config a family's loss and trainer cases
    train: rwkv6-3b (hd 32), gemma3-1b at its head_dim 256 with windows of
    8 that the 15-token inputs cross, recurrentgemma-9b (recurrent,
    recurrent, local; window 64), qwen2-moe-a2.7b at a capacity factor of
    1e-9 (8 slots an expert, fewer than the 30 tokens x top-2 over 4
    experts route to it on average, so slots drop)."""
    cfg = jreduced_config(jget_config(name))
    if name == "gemma3-1b":
        cfg = dataclasses.replace(
            cfg, num_layers=3, layer_pattern=("local", "local", "full"),
            window_size=8, d_model=64, num_heads=4, num_kv_heads=1,
            head_dim=256, d_ff=96, lru_width=64)
    if name == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=3)
    if name == "qwen2-moe-a2.7b":
        cfg = dataclasses.replace(cfg, capacity_factor=1e-9)
    return cfg


def family_params(cfg, seed):
    """Seeded reference parameters as numpy, with every RWKV decay and
    RG-LRU ``lam`` overwritten so that the recurrent states carry."""
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(seed)))
    return _carry_lru(_carry_decays(params, seed + 3), seed + 4)


FAMILIES = ("rwkv6-3b", "gemma3-1b", "recurrentgemma-9b", "qwen2-moe-a2.7b")


def _loss_case(name):
    """(reference cfg, numpy params, numpy batch, loss kind)."""
    draft, _, prm = jtoy_triple()
    task = SyntheticReasoningTask(seed=3)
    if name in FAMILIES:
        cfg = family_config(name)
        params = family_params(cfg, 2)
        toks = np.random.default_rng(4).integers(
            3, cfg.vocab_size, (2, 16)).astype(np.int32)
        batch = {"tokens": toks,
                 "loss_mask": np.ones(toks.shape, np.float32)}
        return cfg, params, batch, "lm"
    cfg = draft if name == "toy-draft" else prm
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(1)))
    if name == "toy-draft":
        return cfg, params, task.lm_batch(4, 24), "lm"
    return cfg, params, task.prm_batch(4, 24), "prm"


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["toy-draft", "toy-prm", *FAMILIES])
def test_loss_and_gradients_match_reference(name):
    cfg, params, batch, kind = _loss_case(name)
    if cfg.num_experts:     # more routed slots than the experts hold
        tokens = batch["tokens"][:, :-1].size
        assert tokens * cfg.experts_per_token > cfg.num_experts * \
            moe._capacity(cfg, tokens, cfg.num_experts)
    jloss = jlm_loss if kind == "lm" else jprm_loss
    model = build_model(cfg)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(model, p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
        has_aux=True))(params)
    tcfg = to_port(cfg)
    port = Model(tcfg, params_from_numpy(tcfg, params), trainable=True)
    loss_fn = lm_loss if kind == "lm" else prm_loss
    got, metrics = loss_fn(port, _torch_batch(batch))
    _close(got, want)
    assert float(metrics["tokens"]) == float(
        np.sum(batch["loss_mask"][:, :-1] if kind == "lm"
               else batch["reward_mask"]))
    named = dict(port.named_parameters())
    tgrads = torch.autograd.grad(got, list(named.values()), allow_unused=True)
    want_g = params_from_numpy(tcfg, jax.tree.map(np.asarray, grads))
    assert set(want_g) == set(named)
    for (k, p), g in zip(named.items(), tgrads):
        w = want_g[k].numpy()
        if g is None:       # not read by this loss: jax.grad gives zeros
            assert not np.any(w), k
            continue
        _close(g, w)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_three_updates_match_reference(state_dtype):
    """warmup 2 of 4 total steps: update 1 warms up, 2 starts the cosine at
    its peak, 3 is half way down; clip 0.5 engages on every update."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=4,
              grad_clip=0.5, weight_decay=0.1, opt_state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jopt = JAdamW(JTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    opt = AdamW(TrainConfig(**kw))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for g in grads:
        jp, jstate, jm = jopt.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, jstate, jp)
        tp, tstate, tm = opt.update({k: torch.from_numpy(v)
                                     for k, v in g.items()}, tstate, tp)
        _close(tm["lr"], jm["lr"])
        _close(tm["grad_norm"], jm["grad_norm"])
        assert float(jm["grad_norm"]) > kw["grad_clip"]
        # bf16 moments round once per update: a last-ulp flip moves
        # an update by 2^-8 of a moment's size
        tol = RTOL if state_dtype == "float32" else 1e-2
        for k in shapes:
            _close(tp[k], jp[k], tol)
            for mom in ("m", "v"):
                assert str(tstate[mom][k].dtype) == f"torch.{state_dtype}"
                _close(tstate[mom][k].float(),
                       np.asarray(jstate[mom][k], np.float32), tol)
    assert tstate["count"] == int(jstate["count"]) == 3


# ----------------------------------------------------------------------
# Trainer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("prm", [False, True])
def test_trainer_three_steps_match_reference(prm):
    draft, _, prm_cfg = jtoy_triple()
    cfg = prm_cfg if prm else draft
    tcfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=3,
                   seed=4)
    task = SyntheticReasoningTask(seed=9)
    batches = [task.prm_batch(8, 24) if prm else task.lm_batch(8, 24)
               for _ in range(3)]
    jtr = JTrainer(cfg, JTrainConfig(**tcfg_kw), prm=prm)
    tcfg = to_port(cfg)
    start = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtr.params))
    kept = {k: v.clone() for k, v in start.items()}
    tr = Trainer(tcfg, TrainConfig(**tcfg_kw), prm=prm, params=start,
                 device="cpu")
    want = jtr.fit(iter(batches), 3, log_every=1)
    got = tr.fit(iter(batches), 3, log_every=1)
    assert [h["step"] for h in got] == [0, 1, 2]
    for g, w in zip(got, want):
        _close(g["loss"], w["loss"])
        _close(g["grad_norm"], w["grad_norm"])
    # Adam divides by sqrt(v): where a gradient is near 0, summation-order
    # rounding moves m / sqrt(v) by up to O(1) and the step by up to its
    # lr, so parameters get 5% of the summed learning rates on top of the
    # parity rule (lr 5e-4, 1e-3 and 0 here)
    final = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtr.params))
    slack = 0.05 * sum(float(jtr.opt.lr_fn(i)) for i in (1, 2, 3))
    for k, p in tr.params.items():
        w = final[k].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=RTOL,
            atol=RTOL * max(float(np.abs(w).max()), 1.0) + slack)
    # the caller's start dict is copied, never trained in place
    assert all(torch.equal(start[k], v) for k, v in kept.items())


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def _ckpt_params():
    g = torch.Generator().manual_seed(0)
    return {"embed.embedding": torch.randn((5, 3), generator=g).bfloat16(),
            "final_ln": torch.randn((3,), generator=g),
            "layers.0.attn.wq": torch.randn((3, 2, 4), generator=g),
            "steps": torch.arange(6, dtype=torch.int32).reshape(2, 3)}


def test_checkpoint_round_trip_keeps_dtype_shape_and_bits(tmp_path):
    params = _ckpt_params()
    path = tmp_path / "sub" / "ck.npz"
    save_checkpoint(str(path), params)
    back = load_checkpoint(str(path), params)
    assert list(back) == list(params)
    for k, t in params.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert torch.equal(back[k], t), k
    assert sorted(p.name for p in path.parent.iterdir()) == ["ck.npz"]


def test_checkpoint_mismatches_raise(tmp_path):
    params = _ckpt_params()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params)
    fewer = dict(list(params.items())[:-1])
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, fewer)
    renamed = {("x" + k if k == "final_ln" else k): v
               for k, v in params.items()}
    with pytest.raises(KeyError):
        load_checkpoint(path, renamed)
    reshaped = {**params, "final_ln": torch.zeros(4)}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, reshaped)


def test_failed_checkpoint_write_leaves_no_file(tmp_path, monkeypatch):
    params = _ckpt_params()
    path = tmp_path / "ck.npz"
    save_checkpoint(str(path), params)
    before = path.read_bytes()

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(path), {k: v + 1 for k, v in params.items()})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    assert path.read_bytes() == before


# ----------------------------------------------------------------------
# the CLIs on the CPU
# ----------------------------------------------------------------------

def test_launch_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.config import get_config, reduced_config
    from repro_torch.launch import train
    path = tmp_path / "ck.npz"
    train.main(["--arch", "qwen2.5-math-1.5b", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "32", "--log-every", "1",
                "--device", "cpu", "--ckpt", str(path)])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    cfg = reduced_config(get_config("qwen2.5-math-1.5b"))
    from repro_torch.models import random_params
    like = random_params(cfg, 0, "cpu")
    back = load_checkpoint(str(path), like)
    assert any(not torch.equal(back[k], like[k]) for k in like)  # trained


def test_launch_serve_trains_the_toy_triple_on_cpu(capsys):
    """25 train steps at the reference's batch 32 x seq 64 are the bulk of
    this test: four threads for them, one again after."""
    from repro_torch.launch import serve
    torch.set_num_threads(4)
    try:
        serve.main(["--config", "toy", "--device", "cpu", "--train-steps",
                    "10", "--requests", "1", "--capacity", "1", "--n", "2",
                    "--sync"])
    finally:
        torch.set_num_threads(1)
    out = capsys.readouterr().out
    trained = [line for line in out.splitlines()
               if line.startswith("trained")]
    assert [line.split()[1] for line in trained] == [
        "sx-draft:", "sx-target:", "sx-prm:"]
    assert "steps=" in out and "accuracy=" in out
    with pytest.raises(ValueError, match="toy triple only"):
        serve.main(["--config", "qwen2.5-math", "--device", "cpu",
                    "--train-steps", "10"])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_training_entry_points_default_to_cuda(no_cuda):
    from repro_torch.core.toy import ToyEnv
    from repro_torch.launch import train
    draft, _, _ = jtoy_triple()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(to_port(draft), TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen2.5-math-1.5b", "--reduced",
                    "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        ToyEnv()
