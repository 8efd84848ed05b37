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
  ``BWD_SEGMENT`` steps, the segments taken last to first, each
  recomputing its sub-chunk starts and then each ``BWD_SUB``-step (4)
  sub-chunk's states from them, rows and columns of per-thread partials
  reduced in the kernel's fixed orders, ``du`` summed over column quads
  and then rows), against ``rwkv6_scan_bwd_plain`` (also at the first
  design's 4-step interval) and ``jax.vjp`` of ``rwkv6_scan_ref`` (head
  dims 32 and 64; T 3, 16 and 37; decays at both clamp ends and mixed),
  every step visited once;
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
from repro_torch.kernels.rwkv6_scan import (BWD_SEGMENT, WKV6Scan,
                                            bwd_scratch_bytes,
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
# steps per sub-chunk whose states a thread of the backward kernel
# recomputes into registers and walks backwards between two reductions
# (csrc/rwkv6_scan_bwd.cu's kSub)
BWD_SUB = 4


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


def _quad_sum(x):
    """The 4 lanes of a quad summed as the xor-1-then-xor-2 shuffles add
    them: (x0 + x1) + (x2 + x3) over the last axis."""
    return (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])


def _in_order(x):
    """Sum over the last axis one term at a time, first to last (the
    kernels' fixed orders across warps and across a cluster's blocks)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _rows_sum(part):
    """A row's sum over its column quads as the kernel takes it:
    ``part`` (B, H, hd rows, hd / 4 column quads), each quad a thread's 4
    columns; the 4 quads of a warp reduce-scattered by shuffles, then the
    hd / 16 warps (column groups) in order."""
    B, H, hd, _ = part.shape
    return _in_order(_quad_sum(part.reshape(B, H, hd, hd // 16, 4)))


def _cols_sum(part):
    """A column's sum over its row quads as the kernel takes it: ``part``
    (B, H, hd / 4 row quads, hd columns); the 8 row quads of a block (32
    rows) reduce-scattered over the lanes (xor 16, 8, then 4: row-quad
    bits 2, 1, 0), then the hd / 32 blocks of the cluster in rank order."""
    B, H, nq, hd = part.shape
    x = part.reshape(B, H, nq // 8, 8, hd)
    x = x[:, :, :, :4] + x[:, :, :, 4:]
    x = x[:, :, :, :2] + x[:, :, :, 2:]
    x = x[:, :, :, 0] + x[:, :, :, 1]
    return _in_order(x.permute(0, 1, 3, 2))


def scan_bwd_chunked(r, k, v, w, u, state, dout, dstate=None,
                     segment=BWD_SEGMENT, sub=BWD_SUB):
    """The backward kernel's order in plain torch, fp32: a forward sweep
    keeps only the state before every ``segment``-th step; the segments
    are taken last to first, each recomputing from its checkpoint the
    starts of its ``sub``-step sub-chunks, then per sub-chunk, last to
    first, its states, walked backwards.  A step forms per-thread partials
    (4 columns of a row for dk, dw, dr with the u terms on (v . dO) over
    those columns; 4 rows of a column for dv, with sum r u k over those
    rows) and reduces them in the kernel's order (:func:`_rows_sum`,
    :func:`_cols_sum`); ``du`` per (row, head) and column quad, summed the
    same way at the end, then over the batch rows.  Returns the six
    gradients, the steps in the order visited and the checkpoints kept."""
    rf, kf, vf, wf, do = (a.float() for a in (r, k, v, w, dout))
    uf = u.float()
    B, T, H, hd = r.shape

    def advance(S, t):
        return wf[:, t, :, :, None] * S \
            + kf[:, t, :, :, None] * vf[:, t, :, None, :]

    def quads(x):                      # (..., hd) -> (..., hd / 4, 4)
        return x.reshape(*x.shape[:-1], hd // 4, 4)

    NS = -(-T // segment)
    S = state.float()
    cps = [S]
    for g in range(NS - 1):
        for t in range(g * segment, (g + 1) * segment):
            S = advance(S, t)
        cps.append(S)
    dS = torch.zeros_like(S) if dstate is None else dstate.float()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros((B, H, hd, hd // 4))
    visited = []
    for g in reversed(range(NS)):
        t0 = g * segment
        length = min(segment, T - t0)
        nq = -(-length // sub)
        starts, S = [cps[g]], cps[g]
        for ls in range(sub * (nq - 1)):
            S = advance(S, t0 + ls)
            if ls % sub == sub - 1:
                starts.append(S)
        for q in reversed(range(nq)):
            q0 = t0 + q * sub
            St = [starts[q]]
            for t in range(q0, min(q0 + sub, t0 + length) - 1):
                St.append(advance(St[-1], t))
            for m in reversed(range(len(St))):
                t = q0 + m
                visited.append(t)
                Sp = St[m]
                rt, kt, vt, wt, ot = (a[:, t] for a in (rf, kf, vf, wf, do))
                vdp = quads(vt * ot).sum(-1)                  # (B,H,hd/4)
                pk = (uf * rt)[..., None] * vdp[:, :, None] \
                    + quads(dS * vt[:, :, None]).sum(-1)
                pw = quads(dS * Sp).sum(-1)
                pd = (uf * kt)[..., None] * vdp[:, :, None] \
                    + quads(Sp * ot[:, :, None]).sum(-1)
                ruk = quads(uf * rt * kt).sum(-1)             # per row quad
                pv = (dS * kt[..., None]).reshape(B, H, hd // 4, 4,
                                                  hd).sum(3) \
                    + ruk[..., None] * ot[:, :, None]
                du = du + (rt * kt)[..., None] * vdp[:, :, None]
                dk[:, t] = _rows_sum(pk)
                dw[:, t] = _rows_sum(pw)
                dr[:, t] = _rows_sum(pd)
                dv[:, t] = _cols_sum(pv)
                dS = rt[..., None] * ot[..., None, :] + wt[..., None] * dS
    return ((dr, dk, dv, dw, _rows_sum(du).sum(0), dS), visited,
            len(cps) - 1)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("T,decays", [(1, "mixed"), (4, "spread"),
                                      (5, "mixed"), (8, "fast"),
                                      (33, "mixed"), (35, "slow")])
def test_scan_backward_kernel_order_matches_plain(T, decays, with_dstate):
    """The kernel's order at its checkpoint interval and sub-chunk
    (BWD_SEGMENT, BWD_SUB), and at the first design's 4-step interval,
    against rwkv6_scan_bwd_plain; every step visited once, last to first,
    and one checkpoint per segment after the first (the scratch the
    wrapper allocates)."""
    *args, dout, dstate = scan_inputs(T + 40, T=T, hd=32, decays=decays)
    args = [torch.from_numpy(a) for a in (*args, dout)]
    ds = torch.from_numpy(dstate) if with_dstate else None
    want = rwkv6_scan_bwd_plain(*args, ds)
    for segment, sub in ((BWD_SEGMENT, BWD_SUB), (4, 4)):
        got, visited, kept = scan_bwd_chunked(*args, ds, segment=segment,
                                              sub=sub)
        assert visited == list(reversed(range(T)))
        assert kept == -(-T // segment) - 1
        for name, g, w in zip(NAMES, got, want):
            _close(g, w.numpy(), what=f"{name} segment={segment}")
    assert bwd_scratch_bytes(2, T, 2, 32) == \
        (-(-T // BWD_SEGMENT) - 1) * 2 * 2 * 32 * 32 * 4


@pytest.mark.parametrize("segment,sub", [(BWD_SEGMENT, BWD_SUB), (4, 4),
                                         (8, 2)])
@pytest.mark.parametrize("decays", ["fast", "slow", "mixed"])
@pytest.mark.parametrize("T", [3, 16, 37])
@pytest.mark.parametrize("hd", [32, 64])
def test_scan_backward_kernel_order_matches_jax_vjp(hd, T, decays, segment,
                                                    sub):
    """The kernel's order (two blocks of 32 rows a head at hd 64, one at
    32) against ``jax.vjp`` of ``rwkv6_scan_ref`` and the plain backward,
    with a non-zero initial state and final-state cotangent: T shorter
    than a segment (3), one segment (16), and ragged against the segment
    and the sub-chunk (37); decays at both clamp ends and mixed."""
    *args, dout, dstate = scan_inputs(hd + T + 3, T=T, hd=hd, decays=decays)
    _, vjp = jax.vjp(rwkv6_scan_ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))
    targs = [torch.from_numpy(a) for a in (*args, dout)]
    got, visited, _ = scan_bwd_chunked(*targs, torch.from_numpy(dstate),
                                       segment=segment, sub=sub)
    plain = rwkv6_scan_bwd_plain(*targs, torch.from_numpy(dstate))
    assert visited == list(reversed(range(T)))
    for name, g, w, p in zip(NAMES, got, want, plain):
        _close(g, w, what=name)
        _close(g, p.numpy(), what=name)


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
