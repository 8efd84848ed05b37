"""The WKV6 scan kernel's order of operations, modelled on the CPU.

``csrc/rwkv6_scan.cu`` splits each state column's k-sum over four lanes
(group g keeps the row quads g, g + 4, ...; the column's output is their
partial sums reduce-scattered in a fixed order, plus the step's
``sum_k r u k`` times ``v[n]``), and cuts long sequences into segments:
segment 0 scans from the initial state, every other from zero while the
segment's decay product ``D = prod_t w_t`` is kept; a second pass chains
the boundary states in segment order, ``S_{j+1} = D_j * S_j + S_local_j``,
and adds ``(r_t * P_t) . S_j`` to each output of segment j, ``P_t`` the
product of the segment's decays before t.  :func:`scan_split` below is a
plain torch model of that order.  It is held, on seeded numpy inputs, to
``rwkv6_scan_plain``, to ``repro.kernels.ref.rwkv6_scan_ref`` and to the
Pallas kernel in interpret mode at 1e-5 of each output's scale: decays at
the model's clamp ends (``exp(-e^4)``, about 1.8e-24 a step, and
``exp(-e^-8)``, about 0.99966) and mixed, T not a multiple of the segment,
T = 0 and 1, one-step segments, and B * H large enough that the plan
picks one segment.  The host's plan is checked to be a pure function of
the shapes that covers every step once, and the in-place form of a decode
step on the CPU to leave frozen rows bitwise unchanged and give live rows
bitwise the out-of-place result.  The kernel itself runs on a card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import (MAX_SEGMENTS, rwkv6_scan_plain,
                                            scan_plan)

torch.set_num_threads(1)
RTOL = 1e-5
GROUPS = 4
FAST = float(np.exp(-np.exp(4.0)))      # the clamp's ends (models/rwkv.py)
SLOW = float(np.exp(-np.exp(-8.0)))


def group_rows(hd, g):
    """The state rows group ``g`` keeps (``row_of`` in the kernel)."""
    return [4 * (g + GROUPS * (i // 4)) + i % 4 for i in range(hd // GROUPS)]


def column_sum(x, S, hd):
    """sum_k x[k] S[k, n] as the kernel adds it: each group's partial sum,
    then the reduce-scatter's (g0 + g2) + (g1 + g3)."""
    p = [torch.einsum("bhk,bhkn->bhn", x[:, :, group_rows(hd, g)],
                      S[:, :, group_rows(hd, g)]) for g in range(GROUPS)]
    return (p[0] + p[2]) + (p[1] + p[3])


def scan_split(r, k, v, w, u, state, *, plan=None):
    """The kernel's scan, chain and fix-up in plain torch, fp32.  Returns
    ``(out, final state)``."""
    B, T, H, hd = r.shape
    segs, L = plan or scan_plan(B, T, H, hd)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    out = torch.zeros(B, T, H, hd)
    local, decay = [], []
    for s in range(segs):
        t0, t1 = s * L, min(T, s * L + L)
        S = state.float().clone() if s == 0 else torch.zeros(B, H, hd, hd)
        for t in range(t0, t1):
            dot = (rf[:, t] * uf * kf[:, t]).sum(-1)          # (B, H)
            out[:, t] = dot[..., None] * vf[:, t] + column_sum(rf[:, t], S,
                                                               hd)
            S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] \
                * vf[:, t, :, None, :]
        local.append(S)
        decay.append(torch.prod(wf[:, t0:t1], dim=1))        # (B, H, hd)
    S = local[0]
    for s in range(1, segs):
        P = torch.ones(B, H, hd)
        for t in range(s * L, min(T, s * L + L)):
            out[:, t] += column_sum(rf[:, t] * P, S, hd)
            P = P * wf[:, t]
        S = decay[s][..., None] * S + local[s]
    return out, S


def make_case(seed, *, B, T, H, hd, decays="spread", dtype=torch.float32):
    """r, k, v N(0, 1) in ``dtype``; u N(0, 0.3^2); a non-zero initial
    state; decays spread in (0.45, 0.999), at one clamp end, or mixed
    element by element between the two ends."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    shape = (B, T, H, hd)
    w = {"spread": lambda: 0.45 + 0.549 * rng.uniform(size=shape),
         "fast": lambda: np.full(shape, FAST),
         "slow": lambda: np.full(shape, SLOW),
         "mixed": lambda: np.where(rng.uniform(size=shape) < 0.5, FAST,
                                   SLOW)}[decays]().astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    tr, tk, tv = (torch.from_numpy(a).to(dtype) for a in (r, k, v))
    return (tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u),
            torch.from_numpy(s0))


def jax_args(args):
    return [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
        for a in args]


def close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=RTOL * max(np.abs(want).max(initial=0),
                                               1.0), rtol=0)


def check_against_all(args, *, plan=None, pallas=True):
    out, final = scan_split(*args, plan=plan)
    wants = [rwkv6_scan_plain(*args),
             ref.rwkv6_scan_ref(*jax_args(args))]
    if pallas:
        wants.append(rwkv6_scan_pallas(*jax_args(args), chunk=16,
                                       interpret=True))
    for want_out, want_final in wants:
        close(out.numpy(), np.asarray(want_out))
        close(final.numpy(), np.asarray(want_final))


# ----------------------------------------------------------------------
# the host's plan
# ----------------------------------------------------------------------

def covered(T, segs, seg_len):
    """Each step's count of segments holding it; every segment non-empty."""
    seen = np.zeros(T, int)
    for s in range(segs):
        lo, hi = s * seg_len, min(T, s * seg_len + seg_len)
        assert hi > lo or T == 0
        seen[lo:hi] += 1
    return seen


@pytest.mark.parametrize("B,T,H,hd", [
    (16, 1, 40, 64), (16, 17, 40, 64), (4, 1024, 40, 64), (1, 4096, 1, 64),
    (4, 300, 4, 32), (3, 100, 2, 32), (2, 0, 3, 64), (1, 63, 1, 64),
    (33, 64, 40, 32)])
def test_scan_plan_is_pure_and_covers_every_step_once(B, T, H, hd):
    plan = scan_plan(B, T, H, hd)
    scan_plan.cache_clear()
    assert scan_plan(B, T, H, hd) == plan
    segs, seg_len = plan
    assert 1 <= segs <= MAX_SEGMENTS
    assert (covered(T, segs, seg_len) == 1).all()


@settings(database=None, deadline=None, max_examples=200)
@given(B=st.integers(1, 64), T=st.integers(0, 5000), H=st.integers(1, 64),
       hd=st.sampled_from([32, 64]))
def test_scan_plan_covers_any_shape(B, T, H, hd):
    segs, seg_len = scan_plan(B, T, H, hd)
    assert 1 <= segs <= MAX_SEGMENTS
    assert (covered(T, segs, seg_len) == 1).all()


def test_scan_plan_at_main_path_shapes():
    """rwkv6-3b's decode step and shared scoring (16 rows x 40 heads) run
    one segment; its full sequence (4 rows) is split, and then fills every
    SM of an H100."""
    assert scan_plan(16, 1, 40, 64) == (1, 1)
    assert scan_plan(16, 17, 40, 64) == (1, 17)
    segs, seg_len = scan_plan(4, 1024, 40, 64)
    assert segs > 1 and 4 * 40 * segs >= 132
    assert scan_plan(33, 64, 40, 32) == (1, 64)       # B * H fills the card


# ----------------------------------------------------------------------
# the model against the plain version, the oracle and the Pallas kernel
# ----------------------------------------------------------------------

@pytest.mark.parametrize("decays", ["spread", "fast", "slow", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matches_plain_oracle_and_pallas(decays, dtype):
    """B 2, H 2, hd 32, T 100: the plan's 3 segments of 34 steps (T not a
    multiple of the segment)."""
    args = make_case(7, B=2, T=100, H=2, hd=32, decays=decays, dtype=dtype)
    assert scan_plan(2, 100, 2, 32) == (3, 34)
    check_against_all(args)


@pytest.mark.parametrize("decays", ["spread", "mixed"])
@pytest.mark.parametrize("plan", [(9, 1), (3, 4), (2, 5), (1, 9)])
def test_split_other_plans(decays, plan):
    """T 9 at hd 64: one-step segments, a short last segment, one step
    over, one segment."""
    args = make_case(11, B=2, T=9, H=2, hd=64, decays=decays)
    check_against_all(args, plan=plan)


@pytest.mark.parametrize("T", [0, 1])
def test_split_short_sequences(T):
    """T 0 copies the state through; T 1 is one decode step."""
    args = make_case(13, B=3, T=T, H=2, hd=32)
    assert scan_plan(3, T, 2, 32) == (1, T)
    check_against_all(args, pallas=T > 0)


def test_split_one_segment_when_rows_fill_the_card():
    """B * H = 1320 pairs at hd 32 (past the plan's threshold): one
    segment of 64 steps, which the split cuts at fewer rows."""
    args = make_case(17, B=33, T=64, H=40, hd=32, decays="mixed")
    assert scan_plan(33, 64, 40, 32) == (1, 64)
    assert scan_plan(8, 64, 40, 32)[0] > 1
    check_against_all(args, pallas=False)


def test_fast_decays_underflow_without_nan():
    """At exp(-e^4) a step every segment's decay product underflows to
    zero; the chain multiplies by it and never divides."""
    args = make_case(19, B=1, T=40, H=1, hd=32, decays="fast")
    _, _, _, w, _, _ = args
    assert torch.prod(w[:, :8], dim=1).max().item() == 0.0
    check_against_all(args, plan=(5, 8))


# ----------------------------------------------------------------------
# the in-place form of a decode step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("live", [None, [True, False, True, False]])
def test_in_place_form_freezes_rows_bitwise(T, live):
    """``ops.rwkv6_scan_`` on the CPU: frozen rows keep their state bit for
    bit, live rows get bitwise the out-of-place result, and ``out`` is the
    out-of-place ``out`` for every row."""
    args = make_case(23 + T, B=4, T=T, H=3, hd=32, dtype=torch.bfloat16)
    want_out, want_final = ops.rwkv6_scan(*args)
    before = args[5].clone()
    state = args[5].clone()
    mask = None if live is None else torch.tensor(live)
    out = ops.rwkv6_scan_(*args[:5], state, mask)
    assert torch.equal(out, want_out)
    for b in range(4):
        if live is None or live[b]:
            assert torch.equal(state[b], want_final[b])
        else:
            assert torch.equal(state[b], before[b])
    assert not torch.equal(state, before)
