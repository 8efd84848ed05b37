"""Training the RWKV and Gemma families in the port against ``repro``, on
the CPU.

Same numpy-seeded inputs on both sides, fp32, held to 1e-5 of each value's
scale (the port's parity rule) unless a case says otherwise:

* ``rwkv6_scan_bwd_plain``, the WKV6 recurrence's gradient, against
  ``jax.vjp`` of ``repro.kernels.ref.rwkv6_scan_ref`` for all six inputs,
  with cotangents on the output and on the final state: head dims 32 and
  64, B 2, H 2, T 1, 7 and 33, decays spread, at the model's clamp ends
  (``exp(-e^4)``, about 1.8e-24 a step, and ``exp(-e^-8)``, about 0.99966)
  and mixed, and a non-zero initial state;
* ``ops.rwkv6_scan`` under grad (the ``WKV6Scan`` autograd Function)
  against torch autograd of ``rwkv6_scan_plain``, with the cotangent on
  the output, on the final state or on both;
* :func:`scan_bwd_chunked`, a plain torch model of the backward kernel's
  order (``csrc/rwkv6_scan_bwd.cu``: fp32 state checkpoints every
  ``BWD_CHUNK`` steps, the chunks taken last to first, each chunk's states
  recomputed from its checkpoint, dS kept as rows for dr, dk, dw and du and
  as columns for dv, ``du`` summed over rows), against
  ``rwkv6_scan_bwd_plain``, every step visited once;
* ``Trainer`` for 3 steps against the reference's, from the same weights
  and batches, for a reduced ``rwkv6-3b`` (decays overwritten so the WKV
  state carries) and a reduced ``gemma3-1b`` at head_dim 256 (windows that
  bind).

The kernels themselves run on a card (``tests/test_torch_cuda.py``); the
loss and gradient cases of the Gemma and MoE families are in
``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.data import SyntheticReasoningTask
from repro.kernels.ref import rwkv6_scan_ref
from repro.train import Trainer as JTrainer
from repro_torch.config import TrainConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import (BWD_CHUNK, WKV6Scan,
                                            rwkv6_scan_bwd_plain,
                                            rwkv6_scan_plain)
from repro_torch.models.bridge import params_from_numpy
from repro_torch.train import Trainer
from test_torch_train import family_config, family_params, to_port

torch.set_num_threads(1)
RTOL = 1e-5
FAST = float(np.exp(-np.exp(4.0)))      # the clamp's ends (models/rwkv.py)
SLOW = float(np.exp(-np.exp(-8.0)))
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def scan_inputs(seed, *, B=2, T=7, H=2, hd=32, decays="spread"):
    """r, k, v N(0, 1), decays (spread in (0.45, 0.999), at a clamp end or
    mixed element by element), u N(0, 0.3^2), a non-zero initial state,
    and N(0, 1) cotangents on the output and the final state; float32
    numpy."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    r, k, v = (randn(B, T, H, hd) for _ in range(3))
    uni = rng.uniform(size=(B, T, H, hd))
    w = {"spread": 0.45 + 0.549 * uni,
         "fast": np.full(uni.shape, FAST),
         "slow": np.full(uni.shape, SLOW),
         "mixed": np.where(uni < 0.5, FAST, SLOW)}[decays].astype(np.float32)
    return (r, k, v, w, randn(H, hd, scale=0.3),
            randn(B, H, hd, hd, scale=0.1), randn(B, T, H, hd),
            randn(B, H, hd, hd))


@pytest.mark.parametrize("decays", ["spread", "fast", "slow", "mixed"])
@pytest.mark.parametrize("T", [1, 7, 33])
@pytest.mark.parametrize("hd", [32, 64])
def test_scan_backward_matches_jax_vjp(hd, T, decays):
    *args, dout, dstate = scan_inputs(hd + T, T=T, hd=hd, decays=decays)
    (out, final), vjp = jax.vjp(rwkv6_scan_ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))
    got = rwkv6_scan_bwd_plain(*map(torch.from_numpy, args),
                               torch.from_numpy(dout),
                               torch.from_numpy(dstate))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, what=name)
    # the forward the gradient belongs to
    tout, tfinal = rwkv6_scan_plain(*map(torch.from_numpy, args))
    _close(tout, out)
    _close(tfinal, final)


@pytest.mark.parametrize("cotangent", ["out", "state", "both"])
def test_scan_function_matches_autograd_of_plain(cotangent):
    """ops.rwkv6_scan under grad goes through WKV6Scan (its backward the
    plain version on the CPU); an output with no cotangent gets none."""
    *args, dout, dstate = scan_inputs(7, T=9, hd=32, decays="mixed")
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, final = ops.rwkv6_scan(*leaves)
    assert type(out.grad_fn).__name__ == WKV6Scan.__name__ + "Backward"
    want_out, want_final = rwkv6_scan_plain(*leaves)

    def loss(o, s):
        terms = []
        if cotangent in ("out", "both"):
            terms.append((o * torch.from_numpy(dout)).sum())
        if cotangent in ("state", "both"):
            terms.append((s * torch.from_numpy(dstate)).sum())
        return sum(terms)

    got = torch.autograd.grad(loss(out, final), leaves)
    # r reaches no final state: plain autograd finds no path from it
    want = torch.autograd.grad(loss(want_out, want_final), leaves,
                               allow_unused=True)
    for name, g, w, x in zip(NAMES, got, want, leaves):
        _close(g, np.zeros(x.shape) if w is None else w.numpy(), what=name)


def scan_bwd_chunked(r, k, v, w, u, state, dout, dstate=None,
                     chunk=BWD_CHUNK):
    """The backward kernel's order in plain torch, fp32: a forward sweep
    keeps the state before every ``chunk``-th step; the chunks are taken
    last to first, each recomputing its states from its checkpoint and
    walking them backwards, with dS held as rows (dr, dk, dw, du) and as a
    transposed copy (dv, a column a thread); ``du`` is summed over the
    batch rows from per-(row, head) partials.  Returns the six gradients
    and the steps in the order visited."""
    rf, kf, vf, wf, do = (a.float() for a in (r, k, v, w, dout))
    uf = u.float()
    B, T, H, hd = r.shape
    chunks = -(-T // chunk)
    S = state.float()
    cps = [S]
    for c in range(chunks - 1):
        for t in range(c * chunk, (c + 1) * chunk):
            S = wf[:, t, :, :, None] * S \
                + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        cps.append(S)
    rows = torch.zeros_like(S) if dstate is None else dstate.float()
    cols = rows.transpose(-1, -2).clone()          # cols[.., n, k]
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros((B, H, hd))
    visited = []
    for c in reversed(range(chunks)):
        t0 = c * chunk
        steps = range(t0, min(t0 + chunk, T))
        S, prev = cps[c], []
        for t in steps:
            prev.append(S)
            S = wf[:, t, :, :, None] * S \
                + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        for t, Sp in reversed(list(zip(steps, prev))):
            visited.append(t)
            rt, kt, vt, wt, ot = (a[:, t] for a in (rf, kf, vf, wf, do))
            vd = (vt * ot).sum(-1, keepdim=True)
            dr[:, t] = (Sp * ot[..., None, :]).sum(-1) + uf * kt * vd
            dk[:, t] = (rows * vt[..., None, :]).sum(-1) + uf * rt * vd
            dw[:, t] = (rows * Sp).sum(-1)
            du += rt * kt * vd
            dv[:, t] = (cols * kt[..., None, :]).sum(-1) \
                + (rt * uf * kt).sum(-1, keepdim=True) * ot
            rows = rt[..., None] * ot[..., None, :] + wt[..., None] * rows
            cols = ot[..., None] * rt[..., None, :] \
                + wt[..., None, :] * cols
    return (dr, dk, dv, dw, du.sum(0), rows), visited


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("T,decays", [(1, "mixed"), (4, "spread"),
                                      (5, "mixed"), (8, "fast"),
                                      (33, "mixed"), (35, "slow")])
def test_scan_backward_kernel_order_matches_plain(T, decays, with_dstate):
    *args, dout, dstate = scan_inputs(T + 40, T=T, hd=32, decays=decays)
    args = [torch.from_numpy(a) for a in (*args, dout)]
    ds = torch.from_numpy(dstate) if with_dstate else None
    got, visited = scan_bwd_chunked(*args, ds)
    want = rwkv6_scan_bwd_plain(*args, ds)
    assert visited == list(reversed(range(T)))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w.numpy(), what=name)


@pytest.mark.parametrize("name", ["rwkv6-3b", "gemma3-1b"])
def test_trainer_three_steps_match_reference(name):
    """The reference's Trainer and the port's from the same weights (RWKV
    decays overwritten) over the same 3 batches: losses and grad norms at
    the parity rule, parameters with 5% of the summed learning rates on
    top (Adam's m / sqrt(v) turns near-zero gradients' rounding into
    steps of up to the rate, as in test_torch_train.py)."""
    cfg = family_config(name)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=3, seed=4)
    task = SyntheticReasoningTask(seed=11)
    batches = [task.lm_batch(4, 24) for _ in range(3)]
    for b in batches:
        b["tokens"] = b["tokens"] % cfg.vocab_size
    jtr = JTrainer(cfg, JTrainConfig(**kw))
    jtr.params = jax.tree.map(jnp.asarray, family_params(cfg, 6))
    tcfg = to_port(cfg)
    start = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtr.params))
    tr = Trainer(tcfg, TrainConfig(**kw), params=start, device="cpu")
    want = jtr.fit(iter(batches), 3, log_every=1)
    got = tr.fit(iter(batches), 3, log_every=1)
    assert [h["step"] for h in got] == [0, 1, 2]
    assert want[-1]["loss"] < want[0]["loss"]
    for g, w in zip(got, want):
        _close(g["loss"], w["loss"])
        _close(g["grad_norm"], w["grad_norm"])
    final = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtr.params))
    slack = 0.05 * sum(float(jtr.opt.lr_fn(i)) for i in (1, 2, 3))
    for k, p in tr.params.items():
        w = final[k].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=RTOL,
            atol=RTOL * max(float(np.abs(w).max()), 1.0) + slack,
            err_msg=k)
