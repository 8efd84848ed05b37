"""The paged decode kernels' split-and-combine, modelled on the CPU.

``csrc/paged_decode.cuh`` splits a row's page sweep across blocks: block
(row, kv head, split) covers a fixed range of logical blocks, its warp ``w``
takes the range's blocks ``w, w + WARPS, ...`` one unit of rows at a time
with an online softmax, the block merges its warps in order, and a second
kernel merges the splits in order.  :func:`split_combine` below is a plain
torch model of that order of operations.  It is held, on seeded numpy
inputs, to ``paged_attention_plain``, to ``repro.kernels.ref``'s oracles
and to the Pallas kernels in interpret mode, at 1e-5: GQA groups 1, 7 and
16, sliding windows that leave splits with no live position, one-block
splits, a row at the trash column's first position and one past the table,
several pages per warp, units of half a page, fp32 queries over bf16
pools, and int8 / fp8 code pools.  The host's split plan is checked to be
a pure function of the shapes that covers every logical block once.  The
kernels themselves run on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import (paged_attention_pallas,
                                           paged_attention_quant_pallas)
from repro_torch.kernels import quant
from repro_torch.kernels.paged_attention import (WARPS, paged_attention_plain,
                                                 paged_attention_quant_plain,
                                                 split_plan)

torch.set_num_threads(1)
ATOL = 1e-5
NEG = -1e30


def live_blocks(p, window, ps, nblk1):
    """The logical blocks first .. last holding a live position
    (``paged::live_blocks``; a pos past the table clamps to its last)."""
    last = min(p // ps, nblk1 - 1)
    first = (p - window + 1) // ps if window and p - window + 1 > 0 else 0
    return min(first, last), last


def merge(parts):
    """Merge (m, l, acc) partials in list order, as the kernels do."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        al = torch.exp(m - M)
        L = L + al * l
        A = A + al[:, None] * a
    return M, L, A


def split_combine(q, kp, vp, pt, pos, *, window=0, ks=None, vs=None,
                  plan=None, rows=None):
    """The kernels' split-and-combine in plain torch, fp32.

    ``ks``/``vs`` given: kp/vp are code pools and the K scale multiplies
    the score, the V scale the probability (as the kernel folds them).
    ``plan`` defaults to the host's :func:`split_plan`; ``rows`` (default
    the page size) is the unit a warp computes at a time."""
    B, _, H, hd = q.shape
    _, ps, KV, _ = kp.shape
    nblk1 = pt.shape[1]
    G = H // KV
    splits, bps = plan or split_plan(B, KV, nblk1, ps)
    rows = rows or ps
    scale = hd ** -0.5
    out = torch.empty(B, 1, H, hd, dtype=q.dtype)
    for b in range(B):
        p = int(pos[b])
        first, last = live_blocks(p, window, ps, nblk1)
        for h in range(KV):
            qg = q[b, 0, h * G:(h + 1) * G].float()
            partials = []
            for s in range(splits):
                lo, hi = s * bps, min(s * bps + bps, nblk1) - 1
                empty = (torch.full((G,), NEG), torch.zeros(G),
                         torch.zeros(G, hd))
                if hi < first or lo > last:     # contributes nothing
                    partials.append(empty)
                    continue
                warps = []
                for w in range(WARPS):
                    m, l, acc = empty
                    for j in range(lo + w, hi + 1, WARPS):
                        if not first <= j <= last:
                            continue
                        page = int(pt[b, j])
                        kscale = scale * (float(ks[page, h]) if ks is not None
                                          else 1.0)
                        vscale = float(vs[page, h]) if vs is not None else 1.0
                        for r0 in range(0, ps, rows):
                            kk = kp[page, r0:r0 + rows, h].float()
                            vv = vp[page, r0:r0 + rows, h].float()
                            kpos = j * ps + r0 + torch.arange(kk.shape[0])
                            live = kpos <= p
                            if window:
                                live &= kpos > p - window
                            x = torch.where(live, (qg @ kk.T) * kscale, NEG)
                            m_new = torch.maximum(m, x.max(dim=1).values)
                            e = torch.exp(x - m_new[:, None])
                            alpha = torch.exp(m - m_new)
                            l = l * alpha + e.sum(dim=1)
                            acc = acc * alpha[:, None] + (e * vscale) @ vv
                            m = m_new
                    warps.append((m, l, acc))
                partials.append(merge(warps))
            _, L, A = merge(partials)
            out[b, 0, h * G:(h + 1) * G] = (
                A * (1.0 / torch.clamp(L, min=1e-30))[:, None]).to(q.dtype)
    return out


def make_case(seed, *, B=3, H=14, KV=2, hd=16, ps=16, nblk=8):
    """Random (stale) content in every page, rows 0 and 1 sharing their
    first page, the trash column last, and the last row at its first
    position."""
    rng = np.random.default_rng(seed)
    P = B * nblk + 2
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pt = rng.permutation(P - 1)[:B * nblk].reshape(B, nblk)
    pt[1, 0] = pt[0, 0]
    pt = np.concatenate([pt, np.full((B, 1), P - 1)], axis=1).astype(np.int32)
    pos = np.linspace(0, nblk * ps - 2, B).astype(np.int32)
    pos[-1] = nblk * ps
    return q, kp, vp, pt, pos


def quant_pools(kp, vp, kv_dtype):
    """Per-page per-kv-head codes and scales, as the engine writes them."""
    out = []
    for pool in (torch.from_numpy(kp), torch.from_numpy(vp)):
        sc = pool.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) \
            / quant.QMAX[kv_dtype]
        out += [quant.quantize_codes(pool / sc[:, None, :, None],
                                     quant.pool_dtype(kv_dtype,
                                                      torch.float32)), sc]
    return out[0], out[2], out[1], out[3]


def jax_codes(t):
    """A torch code pool as the jnp array the reference takes."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


# ----------------------------------------------------------------------
# the host's plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,KV,nblk1,ps", [
    (16, 4, 33, 16), (16, 2, 33, 16), (4, 4, 33, 16), (1, 1, 33, 16),
    (3, 2, 9, 4), (64, 8, 129, 16), (2, 1, 5000, 32), (1, 1, 1, 1)])
def test_split_plan_is_pure_and_covers_every_block_once(B, KV, nblk1, ps):
    splits, bps = split_plan(B, KV, nblk1, ps)
    split_plan.cache_clear()
    assert split_plan(B, KV, nblk1, ps) == (splits, bps)
    assert bps % WARPS == 0 and bps // WARPS <= 32
    seen = np.zeros(nblk1, int)
    for s in range(splits):
        for w in range(WARPS):
            for k in range(bps // WARPS):
                j = s * bps + w + WARPS * k
                if j < nblk1:
                    seen[j] += 1
    assert (seen == 1).all()
    assert (splits - 1) * bps < nblk1 <= splits * bps


@pytest.mark.parametrize("B,KV", [(16, 4), (16, 2), (4, 4)])
def test_split_plan_fills_the_card_at_main_path_shapes(B, KV):
    """The engine's 33-column tables of 16-row pages (max_seq 512): one
    page per warp and at least one block per SM of an H100."""
    splits, bps = split_plan(B, KV, 33, 16)
    assert (splits, bps) == (9, 4)
    assert B * KV * splits >= 132


# ----------------------------------------------------------------------
# the model against the plain version, the oracle and the Pallas kernel
# ----------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(2, 2), (14, 2), (16, 1)])  # G = 1, 7, 16
@pytest.mark.parametrize("window", [0, 8])
def test_split_combine_matches_plain_oracle_and_pallas(H, KV, window):
    """ps 16 over a 9-column table: 3 splits of 4 blocks, the last holding
    the trash column alone; with the window, rows whose early splits hold
    no live position and a row whose live blocks straddle two splits."""
    case = make_case(H * 10 + window, H=H, KV=KV)
    got = split_combine(*[torch.from_numpy(a) for a in case], window=window)
    plain = paged_attention_plain(*[torch.from_numpy(a) for a in case],
                                  window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    jcase = [jnp.asarray(a) for a in case]
    want = np.asarray(ref.paged_attention_ref(*jcase, window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    kern = np.asarray(paged_attention_pallas(*jcase, window=window,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=0)


@pytest.mark.parametrize("plan,rows", [((1, 12), None), ((3, 4), 8),
                                       ((2, 8), 5), ((1, 36), 16)])
def test_split_combine_other_plans_and_units(plan, rows):
    """Several pages per warp (online softmax across pages), units of part
    of a page (the layout for pages too large for shared memory), and one
    warp holding the whole table."""
    case = [torch.from_numpy(a) for a in make_case(3, H=14, KV=2)]
    for window in (0, 8):
        got = split_combine(*case, window=window, plan=plan, rows=rows)
        want = paged_attention_plain(*case, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("window", [0, 8])
def test_split_combine_fp32_queries_over_bf16_pools(window):
    """The kernel's dtype code 2: bf16 K and V widened to fp32 as read."""
    q, kp, vp, pt, pos = make_case(11 + window, H=14, KV=2)
    kpb, vpb = (torch.from_numpy(a).bfloat16() for a in (kp, vp))
    tq, tpt, tpos = (torch.from_numpy(a) for a in (q, pt, pos))
    got = split_combine(tq, kpb, vpb, tpt, tpos, window=window)
    assert got.dtype == torch.float32
    plain = paged_attention_plain(tq, kpb, vpb, tpt, tpos, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    want = np.asarray(ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp).astype(jnp.bfloat16),
        jnp.asarray(vp).astype(jnp.bfloat16), jnp.asarray(pt),
        jnp.asarray(pos), window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("window", [0, 8])
def test_split_combine_code_pools(kv_dtype, window):
    """Scales folded as the quantized kernel folds them (K scale into the
    score, V scale into the probability)."""
    q, kp, vp, pt, pos = make_case(21 + window, H=14, KV=2)
    kc, vc, ks, vs = quant_pools(kp, vp, kv_dtype)
    tq, tpt, tpos = (torch.from_numpy(a) for a in (q, pt, pos))
    got = split_combine(tq, kc, vc, tpt, tpos, window=window, ks=ks, vs=vs)
    plain = paged_attention_quant_plain(tq, kc, vc, ks, vs, tpt, tpos,
                                        window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    jcase = [jnp.asarray(q), jax_codes(kc), jax_codes(vc),
             jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
             jnp.asarray(pt), jnp.asarray(pos)]
    want = np.asarray(ref.paged_attention_quant_ref(*jcase, window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    kern = np.asarray(paged_attention_quant_pallas(*jcase, window=window,
                                                   interpret=True))
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=0)


def test_split_combine_pos_past_the_table():
    """A stale row whose pos lies past the table: every table position is
    live, and the kernels clamp the sweep to the table's last block."""
    q, kp, vp, pt, pos = make_case(5, H=14, KV=2)
    pos[0] = pt.shape[1] * 16 + 7
    case = [torch.from_numpy(a) for a in (q, kp, vp, pt, pos)]
    got = split_combine(*case)
    want = paged_attention_plain(*case)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_empty_partials_change_no_bit():
    """A split with no live position (m = -1e30, l = 0, acc = 0) leaves the
    merge bitwise unchanged, wherever it stands in the order."""
    rng = np.random.default_rng(0)
    parts = [(torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
              torch.from_numpy(rng.random(7).astype(np.float32) + 1),
              torch.from_numpy(rng.standard_normal((7, 16)).astype(
                  np.float32))) for _ in range(3)]
    empty = (torch.full((7,), NEG), torch.zeros(7), torch.zeros(7, 16))
    want = merge(parts)
    for i in range(4):
        got = merge(parts[:i] + [empty] + parts[i:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
