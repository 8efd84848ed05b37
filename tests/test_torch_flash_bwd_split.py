"""Flash attention's Hopper backward, its order of operations modelled on
the CPU.

``csrc/flash_attention_bwd_hopper.cu`` takes the base-2 log-sum-exp that
the forward kernel saved (``flash_attention_cuda(..., return_lse=True)``),
computes dQ per block of (position, head) rows over 64-key tiles in order
with ``D = rowsum(dO * O)`` of those rows, then dK and dV per 128-key tile
over runs of (query head, 64-query tile) items cut by the host's plan
(``flash_attention.bwd_split_plan``), the runs of a split tile summed in
run order from fp32 partials by a second pass.  At head_dim 256 the dQ
sweep takes 32-key tiles, the dK/dV blocks hold 64 keys (the plan at a
64-key tile), and a block's two warpgroups split each item: S^T and dP^T
over the full 256 dims, P^T and dS^T exchanged in bf16 through shared
memory, then dV and dK for each warpgroup's 128-wide half of the dims.
:func:`model_bwd` and :func:`model_bwd_256` below are plain torch models
of those orders of operations, in fp32 (the latter optionally rounding
P^T, dS^T and dS to bf16 where the kernels do).  The first is held, on
seeded numpy inputs, to ``flash_attention_bwd_plain`` and to ``jax.vjp``
of the reference's ``gqa_attention`` over ``causal_mask`` (or the same
band without the causal edge), at 1e-5 of each gradient's scale: GQA
groups 1, 6, 7 and 64, windows shorter than every tile, Sq = Sk = 511
(ragged against both tiles), ragged Sq != Sk, causal and not, under the
plans for cards of 1, 132 (an H100's) and unboundedly many SMs: the
fewest and longest runs, the H100's, and one item a run.  The host's
plan is checked to be a pure function of the shapes and the SM count
that covers every (key tile, query head, query tile) item holding a live
pair once;
the forward's base-2 log-sum-exp (modelled in its 128-key online order)
and the plain forward's natural one against ``jax.nn.logsumexp`` of the
reference's masked scores; and ``flash_attention_bwd_plain`` given the
log-sum-exp against the same call without it.  The kernels themselves run
on a card (``tests/test_torch_cuda.py``).  At head_dim 256 the model is
held the same way at GQA groups 4 and 16 (gemma3's and recurrentgemma's),
windows 8 and one that binds, ragged Sq and Sk, causal and not, under the
64-key plans for 1, 132 and unboundedly many SMs; rounded to bf16 as the
kernels round, it stays within ``BWD_TOL`` of the plain version; the
hd-256 forward's base-2 log-sum-exp in its 64-key online order is held to
``jax.nn.logsumexp``; the plan covers every live item at the 64-key tile
as at 128; and bf16 at 256 routes to the Hopper backward, fp32 at 256 and
bf16 at the toy head dims 16 and 40 do not, while on the CPU the autograd
Function takes the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import causal_mask, gqa_attention
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)
RTOL = 1e-5
# SM counts of the plans under test: the fewest and longest runs, an
# H100's, and one item a run (the most partials)
PLAN_SMS = (1, 132, 10 ** 9)
FWD_KEYS = 128        # the forward kernel's key tile (online softmax order)
DQ_KEYS = 64          # the dQ kernel's key tile
FWD_KEYS_256, DQ_KEYS_256 = 64, 32     # the same at head_dim 256
BWD_TOL_BF16 = 2e-2   # chip_smoke.BWD_TOL in bf16: P and dS rounded


def _live(Sq, Sk, causal, window):
    return fa._live(Sq, Sk, causal, window, "cpu")


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def forward_lse2(q, k, *, causal, window, scale, keys=FWD_KEYS):
    """The forward kernel's base-2 log-sum-exp, (B, H, Sq): per row a
    running max m of the live scores times scale * log2(e) and a sum l of
    exp2(score - m), ``keys`` keys at a time (128; 64 at head_dim 256);
    lse2 = m + log2(l)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    live = _live(Sq, Sk, causal, window)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    m = torch.full((B, KV, G, Sq), -1e30)
    l = torch.zeros((B, KV, G, Sq))
    for k0 in range(0, Sk, keys):
        kt = k[:, k0:k0 + keys].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kt) * (scale * fa.LOG2E)
        s = torch.where(live[:, k0:k0 + keys], s, -torch.inf)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp2(m - mn) + torch.exp2(s - mn[..., None]).sum(-1)
        m = mn
    return (m + torch.log2(l)).reshape(B, H, Sq)


def plan_runs(plan, G):
    """The dK/dV blocks of one (batch row, kv head) in launch order:
    (key tile, run, [(head, query tile), ...]), as the kernel cuts them."""
    _, tiles = plan
    runs = []
    for t, (jlo, n, splits) in enumerate(tiles):
        N = G * n
        for s in range(splits):
            lo, hi = s * N // splits, (s + 1) * N // splits
            runs.append((t, s, [(i // n, jlo + i % n)
                                for i in range(lo, hi)]))
    return runs


def model_bwd(q, k, v, out, dout, lse2, *, causal, window, scale, plan):
    """(dq, dk, dv) in the kernels' order of operations, fp32."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    live = _live(Sq, Sk, causal, window)
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.float()
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)      # (B, H, Sq)
    sl2 = scale * fa.LOG2E
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)
    # dK, dV: each run of a key tile sums its items in order into its own
    # fp32 partial; the partials are summed in run order
    for b in range(B):
        for kvh in range(KV):
            parts = {}
            for t, s, items in plan_runs(plan, G):
                k0 = t * fa.BWD_KEYS
                keys = slice(k0, min(k0 + fa.BWD_KEYS, Sk))
                K, V = kf[b, keys, kvh], vf[b, keys, kvh]
                pk = torch.zeros(K.shape)
                pv = torch.zeros(V.shape)
                for g, j in items:
                    h = kvh * G + g
                    qs = slice(j * fa.BWD_QUERIES,
                               min((j + 1) * fa.BWD_QUERIES, Sq))
                    Q, dO = qf[b, qs, h], do[b, qs, h]
                    st = K @ Q.T                          # S^T, keys x queries
                    pt = torch.where(live[qs, keys].T,
                                     torch.exp2(st * sl2 - lse2[b, h, qs]),
                                     0.0)
                    dpt = V @ dO.T
                    dst = pt * (dpt - delta[b, h, qs])
                    pv = pv + pt @ dO
                    pk = pk + dst @ Q
                parts.setdefault(t, []).append((pk, pv))
            for t, runs in parts.items():
                k0 = t * fa.BWD_KEYS
                keys = slice(k0, min(k0 + fa.BWD_KEYS, Sk))
                sk, sv = runs[0]
                for pk, pv in runs[1:]:
                    sk, sv = sk + pk, sv + pv
                dk[b, keys, kvh] = sk * scale
                dv[b, keys, kvh] = sv
    # dQ: blocks of 2 x (64 // G) positions of one kv group, each row
    # summing 64-key tiles in order from its block's first to its last
    dq = torch.zeros(qf.shape)
    qt = 64 // G
    for b in range(B):
        for kvh in range(KV):
            heads = slice(kvh * G, (kvh + 1) * G)
            for q0 in range(0, Sq, 2 * qt):
                pos = slice(q0, min(q0 + 2 * qt, Sq))
                qlast = pos.stop - 1
                first = (max(0, q0 - window + 1) if window else 0) // DQ_KEYS
                last = (min(qlast, Sk - 1) if causal else Sk - 1) // DQ_KEYS
                Q = qf[b, pos, heads]                     # (P, G, hd)
                dO = do[b, pos, heads]
                L = lse2[b, heads, pos].T                 # (P, G)
                D = delta[b, heads, pos].T
                acc = torch.zeros(Q.shape)
                for tile in range(first, last + 1):
                    keys = slice(tile * DQ_KEYS,
                                 min((tile + 1) * DQ_KEYS, Sk))
                    K, V = kf[b, keys, kvh], vf[b, keys, kvh]
                    s = torch.einsum("pgh,sh->pgs", Q, K)
                    p = torch.where(live[pos, keys][:, None],
                                    torch.exp2(s * sl2 - L[..., None]), 0.0)
                    dp = torch.einsum("pgh,sh->pgs", dO, V)
                    acc = acc + torch.einsum("pgs,sh->pgh",
                                             p * (dp - D[..., None]), K)
                dq[b, pos, heads] = acc * scale
    return dq, dk, dv


def model_bwd_256(q, k, v, out, dout, lse2, *, causal, window, scale, plan,
                  round_bf16=False):
    """(dq, dk, dv) in the head_dim-256 kernels' order of operations, fp32;
    with ``round_bf16``, P^T and dS^T of the dK/dV blocks and dS of the dQ
    sweep rounded to bf16 where the kernels round them."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_bf16 \
        else (lambda x: x)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    keys = fa.BWD_KEYS_256
    live = _live(Sq, Sk, causal, window)
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.float()
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)      # (B, H, Sq)
    sl2 = scale * fa.LOG2E
    halves = (slice(0, hd // 2), slice(hd // 2, hd))         # warpgroups
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)
    for b in range(B):
        for kvh in range(KV):
            parts = {}
            for t, s, items in plan_runs(plan, G):
                ks = slice(t * keys, min((t + 1) * keys, Sk))
                K, V = kf[b, ks, kvh], vf[b, ks, kvh]
                pk = torch.zeros(K.shape)
                pv = torch.zeros(V.shape)
                for g, j in items:
                    h = kvh * G + g
                    qs = slice(j * fa.BWD_QUERIES,
                               min((j + 1) * fa.BWD_QUERIES, Sq))
                    Q, dO = qf[b, qs, h], do[b, qs, h]
                    # warpgroup 0: S^T -> P^T in bf16; warpgroup 1: dP^T,
                    # then dS^T from the P^T it reads back
                    pt = rnd(torch.where(live[qs, ks].T,
                                         torch.exp2(K @ Q.T * sl2
                                                    - lse2[b, h, qs]), 0.0))
                    dst = rnd(pt * (V @ dO.T - delta[b, h, qs]))
                    for half in halves:
                        pv[:, half] = pv[:, half] + pt @ dO[:, half]
                        pk[:, half] = pk[:, half] + dst @ Q[:, half]
                parts.setdefault(t, []).append((pk, pv))
            for t, runs in parts.items():
                ks = slice(t * keys, min((t + 1) * keys, Sk))
                sk, sv = runs[0]
                for pk, pv in runs[1:]:
                    sk, sv = sk + pk, sv + pv
                dk[b, ks, kvh] = sk * scale
                dv[b, ks, kvh] = sv
    dq = torch.zeros(qf.shape)
    qt = 64 // G
    for b in range(B):
        for kvh in range(KV):
            heads = slice(kvh * G, (kvh + 1) * G)
            for q0 in range(0, Sq, 2 * qt):
                pos = slice(q0, min(q0 + 2 * qt, Sq))
                qlast = pos.stop - 1
                first = (max(0, q0 - window + 1) if window else 0) \
                    // DQ_KEYS_256
                last = (min(qlast, Sk - 1) if causal else Sk - 1) \
                    // DQ_KEYS_256
                Q, dO = qf[b, pos, heads], do[b, pos, heads]
                L, D = lse2[b, heads, pos].T, delta[b, heads, pos].T
                acc = torch.zeros(Q.shape)
                for tile in range(first, last + 1):
                    ks = slice(tile * DQ_KEYS_256,
                               min((tile + 1) * DQ_KEYS_256, Sk))
                    K, V = kf[b, ks, kvh], vf[b, ks, kvh]
                    p = torch.where(live[pos, ks][:, None],
                                    torch.exp2(torch.einsum("pgh,sh->pgs", Q,
                                                            K) * sl2
                                               - L[..., None]), 0.0)
                    ds = rnd(p * (torch.einsum("pgh,sh->pgs", dO, V)
                                  - D[..., None]))
                    for half in halves:
                        acc[..., half] = acc[..., half] + torch.einsum(
                            "pgs,sh->pgh", ds, K[:, half])
                dq[b, pos, heads] = acc * scale
    return dq, dk, dv


def _case(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
             (B, Sq, H, hd))]


def _mask(Sq, Sk, causal, window):
    """The reference's boolean mask (1, Sq, Sk): ``causal_mask``, or its
    window band without the causal edge."""
    if causal:
        return causal_mask(Sq, Sk, window=window)
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool) if not window else kpos > qpos - window
    return jnp.asarray(m[None])


# (B, Sq, Sk, H, KV, causal, window): G 1, 6, 7, 64; windows shorter than
# every tile; 511 ragged against the 64-query items and the 128-key tiles;
# Sq != Sk both ways
CASES = [
    (1, 511, 511, 12, 2, True, 0),
    (1, 511, 511, 14, 2, True, 5),
    (2, 150, 150, 4, 4, True, 0),
    (1, 70, 70, 64, 1, True, 9),
    (2, 70, 130, 6, 1, True, 0),
    (1, 300, 200, 7, 1, True, 0),
    (2, 150, 333, 6, 1, False, 0),
    (1, 90, 90, 7, 1, False, 33),
]


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES)
def test_model_matches_plain_and_jax_vjp(sms, B, Sq, Sk, H, KV, causal,
                                         window):
    hd = 16
    q, k, v, do = _case(Sq + Sk + H + window, B, Sq, Sk, H, KV, hd)
    scale = hd ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: gqa_attention(
        a, b, c, _mask(Sq, Sk, causal, window), scale), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tout = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                    window=window)
    _close(tout, out)
    lse2 = forward_lse2(tq, tk, causal=causal, window=window, scale=scale)
    plan = fa.bwd_split_plan(B, Sq, Sk, H, KV, causal=causal, window=window,
                             sms=sms)
    got = model_bwd(tq, tk, tv, tout, tdo, lse2, causal=causal,
                    window=window, scale=scale, plan=plan)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tout, tdo,
                                         causal=causal, window=window)
    for g, p, w in zip(got, plain, want):
        _close(g, p)
        _close(g, w)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES)
def test_forward_lse_matches_jax_logsumexp(B, Sq, Sk, H, KV, causal,
                                           window):
    """The plain forward's natural log-sum-exp and the forward kernel's
    base-2 one (modelled) against ``jax.nn.logsumexp`` of the reference's
    masked scores; the plain backward given it equals the call without."""
    hd = 16
    q, k, v, do = _case(Sq + Sk + H + window + 1, B, Sq, Sk, H, KV, hd)
    scale = hd ** -0.5
    G = H // KV
    qg = jnp.asarray(q).reshape(B, Sq, KV, G, hd)
    scores = jnp.einsum("bqkgh,bskh->bkgqs", qg, jnp.asarray(k)) * scale
    scores = scores + jnp.where(_mask(Sq, Sk, causal, window)[:, None, None],
                                0.0, -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(B, H, Sq)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window, return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(lse, want)
    _close(forward_lse2(tq, tk, causal=causal, window=window, scale=scale)
           / fa.LOG2E, want)
    given = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, causal=causal,
                                         window=window, lse=lse)
    alone = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, causal=causal,
                                         window=window)
    for g, a in zip(given, alone):
        assert torch.equal(g, a)


@pytest.mark.parametrize("keys", [fa.BWD_KEYS, fa.BWD_KEYS_256])
@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES + [
    (4, 512, 512, 28, 4, True, 0), (4, 511, 511, 12, 2, True, 0),
    (4, 1000, 1000, 28, 4, True, 8), (1, 5, 5, 1, 1, True, 0),
    (2, 1024, 1024, 4, 1, True, 512), (1, 4096, 4096, 16, 1, True, 2048)])
def test_split_plan_covers_every_live_item_once(keys, sms, B, Sq, Sk, H, KV,
                                                causal, window):
    """The plan is a pure function of the shapes and the SM count; its runs
    take every (key tile, query head, query tile) item of a tile's range
    exactly once, in runs of at most ``chunk`` items that differ by at most
    one, the range holds every query tile with a live pair for a key of the
    tile, and the launch has one block per run.  The table the kernels read
    lists each tile's first block.  At both key tiles: 128 keys, and 64
    at head_dim 256 (gemma3's and recurrentgemma's training shapes among
    the cases)."""
    G = H // KV
    plan = fa.bwd_split_plan(B, Sq, Sk, H, KV, causal=causal, window=window,
                             sms=sms, keys=keys)
    assert plan == fa.bwd_split_plan(B, Sq, Sk, H, KV, causal=causal,
                                     window=window, sms=sms, keys=keys)
    chunk, tiles = plan
    assert chunk >= 1
    assert len(tiles) == -(-Sk // keys)
    table = fa._plan_table(tiles, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (len(tiles), 4)
    assert table[:, :3].tolist() == [list(t) for t in tiles]
    assert table[:, 3].tolist() == np.cumsum(
        [0] + [splits for _, _, splits in tiles[:-1]]).tolist()
    live = _live(Sq, Sk, causal, window).numpy()
    runs = plan_runs(plan, G)
    assert len(runs) == sum(splits for _, _, splits in tiles)
    for t, (jlo, n, splits) in enumerate(tiles):
        taken = [it for tt, _, items in runs if tt == t for it in items]
        assert sorted(taken) == [(g, j) for g in range(G)
                                 for j in range(jlo, jlo + n)]
        cols = live[:, t * keys:(t + 1) * keys]
        needed = {p // fa.BWD_QUERIES for p in np.nonzero(cols.any(1))[0]}
        assert needed <= set(range(jlo, jlo + n))
        sizes = [len(items) for tt, _, items in runs if tt == t]
        assert len(sizes) == splits
        assert max(sizes) - min(sizes) <= 1 and max(sizes) <= chunk


# head_dim 256 (B, Sq, Sk, H, KV, causal, window): G 4 and 16; a window of
# 8, shorter than every tile, and 70 binding at S 130; ragged Sq != Sk;
# causal and not
CASES_256 = [
    (1, 150, 150, 4, 1, True, 0),
    (1, 150, 150, 16, 1, True, 8),
    (1, 130, 130, 4, 1, True, 70),
    (1, 70, 130, 4, 1, True, 0),
    (1, 100, 77, 16, 1, False, 0),
    (1, 90, 90, 4, 1, False, 33),
]


def _hd256_case(B, Sq, Sk, H, KV, causal, window):
    hd = 256
    q, k, v, do = _case(Sq + Sk + H + window + 256, B, Sq, Sk, H, KV, hd)
    scale = hd ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tout = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                    window=window)
    lse2 = forward_lse2(tq, tk, causal=causal, window=window, scale=scale,
                        keys=FWD_KEYS_256)
    return (q, k, v, do), (tq, tk, tv, tout, tdo), lse2, scale


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES_256)
def test_model_256_matches_plain_and_jax_vjp(sms, B, Sq, Sk, H, KV, causal,
                                             window):
    """The head_dim-256 order in fp32 (no rounding) against the plain
    backward and jax.vjp of the reference, at 1e-5 of each gradient's
    scale, under the 64-key plans."""
    (q, k, v, do), (tq, tk, tv, tout, tdo), lse2, scale = _hd256_case(
        B, Sq, Sk, H, KV, causal, window)
    out, vjp = jax.vjp(lambda a, b, c: gqa_attention(
        a, b, c, _mask(Sq, Sk, causal, window), scale), q, k, v)
    want = vjp(jnp.asarray(do))
    _close(tout, out)
    plan = fa.bwd_split_plan(B, Sq, Sk, H, KV, causal=causal, window=window,
                             sms=sms, keys=fa.bwd_keys(256))
    got = model_bwd_256(tq, tk, tv, tout, tdo, lse2, causal=causal,
                        window=window, scale=scale, plan=plan)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tout, tdo,
                                         causal=causal, window=window)
    for g, p, w in zip(got, plain, want):
        _close(g, p)
        _close(g, w)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES_256)
def test_model_256_rounded_stays_within_bwd_tol(B, Sq, Sk, H, KV, causal,
                                                window):
    """Rounding P^T, dS^T and dS to bf16 where the kernels do moves each
    gradient by less than ``BWD_TOL`` in bf16 (2e-2 of its scale) from the
    plain fp32 backward, and does move it (the rounding is modelled)."""
    _, (tq, tk, tv, tout, tdo), lse2, scale = _hd256_case(
        B, Sq, Sk, H, KV, causal, window)
    plan = fa.bwd_split_plan(B, Sq, Sk, H, KV, causal=causal, window=window,
                             sms=132, keys=fa.bwd_keys(256))
    got = model_bwd_256(tq, tk, tv, tout, tdo, lse2, causal=causal,
                        window=window, scale=scale, plan=plan,
                        round_bf16=True)
    exact = model_bwd_256(tq, tk, tv, tout, tdo, lse2, causal=causal,
                          window=window, scale=scale, plan=plan)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tout, tdo,
                                         causal=causal, window=window)
    for g, e, p in zip(got, exact, plain):
        _close(g, p, rtol=BWD_TOL_BF16)
        assert not torch.equal(g, e)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", CASES_256)
def test_forward_lse_256_matches_jax_logsumexp(B, Sq, Sk, H, KV, causal,
                                               window):
    """The head_dim-256 forward's base-2 log-sum-exp, modelled in its
    64-key online order, against ``jax.nn.logsumexp`` of the reference's
    masked scores."""
    (q, k, _, _), (tq, tk, _, _, _), lse2, scale = _hd256_case(
        B, Sq, Sk, H, KV, causal, window)
    G = H // KV
    qg = jnp.asarray(q).reshape(B, Sq, KV, G, 256)
    scores = jnp.einsum("bqkgh,bskh->bkgqs", qg, jnp.asarray(k)) * scale
    scores = scores + jnp.where(_mask(Sq, Sk, causal, window)[:, None, None],
                                0.0, -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(B, H, Sq)
    _close(lse2 / fa.LOG2E, want)


def test_routing_by_dtype_and_head_dim():
    """bf16 at head_dims 64, 128 and 256 takes the Hopper backward (which
    needs the forward's log-sum-exp); fp32 at 256 and bf16 at the toy head
    dims 16 and 40 do not.  The key tile of a dK/dV block is 64 at 256 and
    128 below.  On the CPU the autograd Function runs the plain versions
    and saves the plain natural log-sum-exp."""
    for hd in (64, 128, 256):
        assert fa.uses_hopper_bwd_kernel(torch.bfloat16, hd)
    assert not fa.uses_hopper_bwd_kernel(torch.float32, 256)
    for hd in (16, 40):
        assert not fa.uses_hopper_bwd_kernel(torch.bfloat16, hd)
    assert fa.bwd_keys(256) == 64 and fa.bwd_keys(128) == fa.bwd_keys(64) \
        == 128
    (_, _, _, _), (tq, tk, tv, _, tdo), _, _ = _hd256_case(
        1, 40, 40, 4, 1, True, 8)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.FlashAttention.apply(*leaves, True, 8, None)
    got = torch.autograd.grad(out, leaves, tdo)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, out.detach(), tdo,
                                        causal=True, window=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
