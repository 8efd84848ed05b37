"""WKV6 recurrence (RWKV-6 time-mix inner loop): plain version and kernel.

Per (batch row, head), with an fp32 state ``S`` of shape (hd, hd), at every
step t::

    out_t[n] = sum_k r_t[k] * (S[k, n] + u[k] * k_t[k] * v_t[n])
    S[k, n] <- w_t[k] * S[k, n] + k_t[k] * v_t[n]

* :func:`rwkv6_scan_plain` mirrors ``repro.kernels.ref.rwkv6_scan_ref``
  (and the model's ``_wkv_scan``): the sequential recurrence in fp32, one
  step at a time.  The CPU path, and the yardstick the kernel is held to.
* :func:`rwkv6_scan_cuda` launches ``csrc/rwkv6_scan.cu`` (the Hopper
  kernel that replaces ``rwkv6_scan_pallas``) and counts its calls in
  ``rwkv6_scan_cuda.launches``: one per call, whether the C entry point
  ran its scan kernel alone or with the fix-up kernel.  Called directly
  it is forward-only: an input that requires a gradient raises.
* :func:`rwkv6_scan_bwd_plain` is the recurrence's gradient, in reverse
  step by step in fp32 (the yardstick on the card, the backward on the
  CPU); :func:`rwkv6_scan_bwd_cuda` launches ``csrc/rwkv6_scan_bwd.cu``
  (a 4 x 4 tile of S and dS a thread; fp32 state checkpoints every
  :data:`BWD_SEGMENT` steps, each segment's states recomputed from its
  checkpoint, a 4-step sub-chunk at a time, and walked backwards; rows
  and columns reduced in a fixed order; no atomics) and
  counts its calls in ``rwkv6_scan_bwd_cuda.launches``.
* :class:`WKV6Scan` binds the two directions as a
  ``torch.autograd.Function`` returning ``(out, final state)``;
  ``ops.rwkv6_scan`` goes through it whenever an input requires a
  gradient.
* :func:`rwkv6_scan_plain_` and :func:`rwkv6_scan_cuda_` are the in-place
  forms a decode step uses: the new state is written over ``state`` in the
  rows where ``live`` is True, and the other rows keep theirs bit for bit.
* :func:`scan_plan` is the host's half of the kernel's split of long
  sequences across blocks: how many segments, of how many steps, from the
  shapes alone, so that no call reads a tensor's values on the host.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, streams

HEAD_DIMS = (32, 64)          # the kernel's template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The plan: blocks of (row, head, segment) wanted at hd 64, about four
# scan blocks a SM of an H100 (132 SMs): with five (the most that its
# registers allow) a T = 1024 call of 4 x 40 heads ran slower than with
# four, in chip runs of several plans; twice as many at hd 32, whose
# blocks are half the size.
# Segments shorter than MIN_SEGMENT steps cost more in the fix-up than
# their parallelism buys; MAX_SEGMENTS bounds the fix-up's chain (segment
# j chains j boundary states).
WANT_BLOCKS = 4 * 132
MIN_SEGMENT = 32
MAX_SEGMENTS = 32
# the backward kernel's steps per fp32 state checkpoint: its scratch holds
# ceil(T / BWD_SEGMENT) - 1 states of every (row, head).  csrc's kSeg; the
# C entry refuses a scratch of any other size
BWD_SEGMENT = 16


def rwkv6_scan_plain(r, k, v, w, u, state):
    """r, k, v, w: (B,T,H,hd); u: (H,hd); state: (B,H,hd,hd).

    Returns ``(out (B,T,H,hd) fp32, final state (B,H,hd,hd) fp32)``.
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkn->bhn", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    if not outs:
        return rf.new_zeros(rf.shape), S.clone()
    return torch.stack(outs, dim=1), S


def rwkv6_scan_bwd_plain(r, k, v, w, u, state, dout, dstate=None):
    """Gradients of :func:`rwkv6_scan_plain` with respect to all six
    inputs, ``(dr, dk, dv, dw, du, dstate)`` in their dtypes, computed in
    fp32 in reverse step by step.  ``dout`` (B,T,H,hd) is the output's
    cotangent, ``dstate`` (B,H,hd,hd) the final state's (zero when None).
    Per (row, head), with S_{t-1} the state before step t and dS the
    cotangent of the state after it::

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dO_t
        dk_t = dS v_t + u * r_t (v_t . dO_t)
        dv_t = dS^T k_t + (sum_k r_t u k_t) dO_t
        dw_t = rowsum(dS * S_{t-1});  du += r_t * k_t (v_t . dO_t)
        dS  <- r_t dO_t^T + diag(w_t) dS
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    S = state.float()
    prev = []
    for t in range(r.shape[1]):
        prev.append(S)
        S = wf[:, t, :, :, None] * S \
            + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    do = dout.float()
    dS = torch.zeros_like(S) if dstate is None else dstate.float()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, ot = (a[:, t] for a in (rf, kf, vf, wf, do))
        vd = (vt * ot).sum(-1, keepdim=True)                 # (B,H,1)
        dr[:, t] = torch.einsum("bhkn,bhn->bhk", prev[t], ot) + uf * kt * vd
        dk[:, t] = torch.einsum("bhkn,bhn->bhk", dS, vt) + uf * rt * vd
        dv[:, t] = torch.einsum("bhkn,bhk->bhn", dS, kt) \
            + (rt * uf * kt).sum(-1, keepdim=True) * ot
        dw[:, t] = (dS * prev[t]).sum(-1)
        du += (rt * kt * vd).sum(0)
        dS = rt[..., None] * ot[..., None, :] + wt[..., None] * dS
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), dS.to(state.dtype))


def rwkv6_scan_plain_(r, k, v, w, u, state, live=None):
    """:func:`rwkv6_scan_plain` writing the final state over ``state``
    (fp32) where ``live`` (B,) bool is True, or in every row when it is
    None, with ``torch.where`` semantics (``repro``'s ``_freeze``).
    Returns ``out``."""
    out, S = rwkv6_scan_plain(r, k, v, w, u, state)
    if live is not None:
        S = torch.where(live.reshape(-1, 1, 1, 1), S, state)
    state.copy_(S)
    return out


@functools.lru_cache(maxsize=None)
def scan_plan(B: int, T: int, H: int, hd: int) -> tuple:
    """``(segments, seg_len)``: the T steps of every (row, head) are cut
    into ``segments`` runs of ``seg_len`` steps (the last may be shorter,
    none is empty), one block of the scan kernel's grid per (row, head,
    segment).  A pure function of the shapes.

    One segment when B * H already fills the card or T is short: the
    decode step (B 16 x H 40, T 1) and shared scoring (T 17) of
    rwkv6-3b.  Otherwise as many as keep B * H * segments within
    ``WANT_BLOCKS`` (x 64 / hd), one wave of blocks, within
    ``MIN_SEGMENT`` steps a segment and ``MAX_SEGMENTS``: a full sequence
    of B 4 x H 40, T 1024 runs in 3 segments of 342 steps."""
    want = WANT_BLOCKS * 64 // hd
    pairs = B * H
    if pairs * 2 > want or T < 2 * MIN_SEGMENT:
        return 1, T
    segs = min(MAX_SEGMENTS, T // MIN_SEGMENT, want // pairs)
    seg_len = -(-T // segs)
    return -(-T // seg_len), seg_len


def _library():
    lib = build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(who, r, k, v, w, u, state, live):
    """Devices, gradients, dtypes, shapes and the current device; raises
    on anything the kernel does not take.  Returns the device's index."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state)) + ((("live", live),) if live is not None
                                  else ())
    dev = r.get_device()                       # -1 off the card
    if dev < 0 or any(t.get_device() != dev for _, t in named):
        name, t = next((n, t) for n, t in named
                       if not t.is_cuda or t.device != r.device)
        raise ValueError(f"{who}: {name} must be on {r.device} (CUDA), "
                         f"got {t.device}")
    if any(t.requires_grad for _, t in named):
        raise RuntimeError(f"{who} is forward-only: call it under "
                           f"torch.no_grad() on tensors that do not require "
                           f"a gradient, or train through ops.rwkv6_scan "
                           f"(the WKV6Scan autograd Function)")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"{who} takes float32 or bfloat16 r/k/v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 \
            or state.dtype != torch.float32:
        raise TypeError(f"{who}: w, u and state must be float32, got "
                        f"{w.dtype}, {u.dtype}, {state.dtype}")
    if live is not None and live.dtype != torch.bool:
        raise TypeError(f"{who}: live must be bool, got {live.dtype}")
    if r.dim() != 4:
        raise ValueError(f"{who}: r must be (B,T,H,hd), got "
                         f"{tuple(r.shape)}")
    B, T, H, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, hd) or state.shape != (B, H, hd, hd) \
            or (live is not None and live.shape != (B,)):
        raise ValueError(f"{who}: bad shapes " + " ".join(
            f"{name} {tuple(t.shape)}" for name, t in named))
    if hd not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {hd} not in {HEAD_DIMS}")
    if dev != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {r.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return dev


def _ready(t):
    """Contiguous and 16-byte aligned (the kernel's vector loads and
    stores): a contiguous view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(who, r, k, v, w, u, state, final, live):
    """Run the kernel(s) from ``state`` into ``final`` (``state`` itself for
    the in-place form) under :func:`scan_plan`'s plan; returns ``out``."""
    dev = _check(who, r, k, v, w, u, state, live)
    B, T, H, hd = r.shape
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return out
    segs, seg_len = scan_plan(B, T, H, hd)
    r, k, v, w = (_ready(t) for t in (r, k, v, w))
    u = u.contiguous()
    stream = streams.current(dev)
    part = streams.scratch(dev, stream,
                           0 if segs == 1 else B * H * segs * (hd + 1) * hd)
    err = _library()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), out.data_ptr(), final.data_ptr(),
        None if live is None else live.data_ptr(),
        None if part is None else part.data_ptr(), B, T, H, hd,
        _DTYPE_CODE[r.dtype], segs, seg_len, stream)
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    streams.launched(rwkv6_scan_cuda)
    return out


def rwkv6_scan_cuda(r, k, v, w, u, state):
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`rwkv6_scan_plain`.  r, k and v are float32 or bfloat16 of one
    dtype; w, u and state float32; hd is 32 or 64.  Inputs are made
    contiguous; the final state goes to a fresh buffer.  Raises on
    anything the kernel does not take, on an input that requires a
    gradient, and on a failed launch."""
    final = torch.empty(state.shape, dtype=torch.float32,
                        device=state.device)
    out = _launch("rwkv6_scan_cuda", r, k, v, w, u, _ready(state), final,
                  None)
    return out, final


def rwkv6_scan_cuda_(r, k, v, w, u, state, live=None):
    """The in-place form of :func:`rwkv6_scan_cuda`: the final state is
    written over ``state`` (contiguous float32) in the rows where ``live``
    (B,) bool is True, or every row when it is None; the other rows keep
    their state bit for bit.  Returns ``out``; counts on
    ``rwkv6_scan_cuda.launches``."""
    who = "rwkv6_scan_cuda_"
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError(f"{who}: state must be contiguous and 16-byte "
                         f"aligned (it is written in place)")
    if live is not None:
        live = live.contiguous()
    return _launch(who, r, k, v, w, u, state, state, live)


rwkv6_scan_cuda.launches = 0


def _library_bwd():
    lib = build.load("rwkv6_scan_bwd")
    fn = lib.rwkv6_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_bwd_cuda(r, k, v, w, u, state, dout, dstate=None):
    """Launch the backward kernel on the current stream; same contract as
    :func:`rwkv6_scan_bwd_plain`, the forward's limits (r, k and v float32
    or bfloat16 of one dtype, w, u and state float32, hd 32 or 64), and
    ``dout`` and ``dstate`` (or None) float32.  ``du`` is the sum over the
    batch rows of the kernel's per-(row, head) partials, taken in a fixed
    order.  Scratch: ``ceil(T / BWD_SEGMENT) - 1`` fp32 states of every
    (row, head), :func:`bwd_scratch_bytes`: 81.3 MB at rwkv6-3b's training
    shape (B 4, T 512, H 40, hd 64); ``rwkv6_scan_bwd_cuda.scratch_bytes``
    holds the last launch's.  Raises on anything the kernel does not take
    and on a failed launch."""
    who = "rwkv6_scan_bwd_cuda"
    dev = _check(who, r, k, v, w, u, state, None)
    B, T, H, hd = r.shape
    for name, t, shape in (("dout", dout, r.shape),
                           ("dstate", dstate, state.shape)):
        if t is not None and (t.device != r.device or t.dtype != torch.float32
                              or t.shape != shape):
            raise ValueError(f"{who}: {name} must be float32 "
                             f"{tuple(shape)} on {r.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if B == 0 or H == 0 or T == 0:
        ds0 = torch.zeros_like(state) if dstate is None else dstate.clone()
        return (dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(),
                torch.zeros_like(u), ds0)
    r, k, v, w, dout, state = (_ready(t) for t in (r, k, v, w, dout, state))
    if dstate is not None:
        dstate = _ready(dstate)
    u = _ready(u)
    du = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    nbytes = bwd_scratch_bytes(B, T, H, hd)
    cp = torch.empty((nbytes // 4,), dtype=torch.float32,
                     device=r.device) if nbytes else None
    err = _library_bwd()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), dout.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), None if cp is None else cp.data_ptr(), nbytes // 4,
        B, T, H, hd, _DTYPE_CODE[r.dtype], streams.current(dev))
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    streams.launched(rwkv6_scan_bwd_cuda)
    rwkv6_scan_bwd_cuda.scratch_bytes = nbytes
    return dr, dk, dv, dw, du.sum(0), ds0


rwkv6_scan_bwd_cuda.launches = 0
rwkv6_scan_bwd_cuda.scratch_bytes = 0   # the last launch's checkpoints


def bwd_scratch_bytes(B: int, T: int, H: int, hd: int) -> int:
    """Bytes of :func:`rwkv6_scan_bwd_cuda`'s checkpoint scratch: the fp32
    state before every :data:`BWD_SEGMENT`-th step but the first, of every
    (row, head)."""
    return max(0, -(-T // BWD_SEGMENT) - 1) * B * H * hd * hd * 4


class WKV6Scan(torch.autograd.Function):
    """Differentiable WKV6 recurrence returning ``(out, final state)``: the
    forward kernel on detached inputs and the backward kernel on CUDA
    tensors, :func:`rwkv6_scan_plain` and :func:`rwkv6_scan_bwd_plain` on
    CPU tensors.  Saves the six inputs; the backward recomputes the states
    from them.  A cotangent that autograd does not supply (an unused
    output) is zero: a missing final-state one is passed on as None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        args = tuple(t.detach() for t in (r, k, v, w, u, state))
        fwd = rwkv6_scan_cuda if r.is_cuda else rwkv6_scan_plain
        out, final = fwd(*args)
        ctx.save_for_backward(*args)
        return out, final

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        bwd = rwkv6_scan_bwd_cuda if r.is_cuda else rwkv6_scan_bwd_plain
        return bwd(r, k, v, w, u, state, dout, dstate)
