"""Full-sequence (flash) attention: the plain PyTorch version and the kernel.

Causal or sliding-window GQA attention of ``q (B, Sq, H, hd)`` over
``k, v (B, Sk, KV, hd)``; query head ``h`` reads kv head ``h // (H // KV)``.
Positions start at 0 on both sides: key ``kpos`` is live for query ``qpos``
iff ``kpos <= qpos`` (when causal) and ``kpos > qpos - window`` (with a
window).  The train and prefill passes of every attention layer go through
it.

* :func:`flash_attention_plain` mirrors ``repro.kernels.ref.
  flash_attention_ref``: fp32 scores, the -1e30 mask, one softmax, and the
  probabilities cast to q's dtype before the P.V product.  The CPU path,
  and the yardstick the kernel is held to.
* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (the
  Hopper kernels that replace ``flash_attention_pallas``) and counts its
  launches in ``flash_attention_cuda.launches``.  bf16 at head_dim 64 or
  128 (every Qwen2.5-Math layer) goes to the TMA/wgmma kernel, bf16 at 256
  (the Gemma families) to its 256-wide variant; other bf16 head dims to
  the ``mma.sync`` kernel and fp32 to the CUDA-core kernel,
  chosen from dtype and shape before the launch.  Called directly it is
  forward-only: an input that requires a gradient raises.
  With ``return_lse`` the TMA/wgmma kernel also returns each row's
  log-sum-exp in base 2 (:data:`LOG2E` times the natural one), the unit
  the Hopper backward uses.
* :func:`flash_attention_bwd_plain` is the backward of the plain version
  as the kernels compute it: the log-sum-exp (given, natural log, or
  recomputed), ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``, dK and dV
  summed over the query heads of a kv group, P kept in fp32 (the forward's
  bf16 cast of P gets no gradient path of its own).
  :func:`flash_attention_bwd_cuda` launches, for bf16 at head_dim 64,
  128 or 256 (:func:`uses_hopper_bwd_kernel`), ``csrc/
  flash_attention_bwd_hopper.cu`` (TMA/wgmma: dQ and D, then dK/dV over
  the plan of :func:`bwd_split_plan`, then the split tiles' partials
  summed in order; at 256 a dK/dV block's two warpgroups split each item's
  products and exchange P^T and dS^T through shared memory) from the
  forward's log-sum-exp, and otherwise ``csrc/flash_attention_bwd.cu``
  (three mma.sync / CUDA-core kernels that rebuild it; fp32 and the toy
  head dims 16 and 40, and fp32 at head_dim 256, where they split the
  output's head dims over two blocks and a kv group's query heads over G,
  summing the heads' fp32 partials in order); no atomics either way.
  It counts its calls in ``flash_attention_bwd_cuda.launches``.
* :class:`FlashAttention` binds the two as a ``torch.autograd.Function``:
  the forward kernel on detached inputs, saving the log-sum-exp where the
  Hopper backward takes it, and the backward kernels for the gradients
  (the plain versions, with the plain log-sum-exp, for CPU tensors).
  ``ops.flash_attention`` goes through it whenever an input requires a
  gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, streams

NEG = -1e30
MAX_GROUP = 64        # query heads per kv head (the kernel's 64 query rows)
MAX_HEAD_DIM = 256    # forward and backward
# the widest dK/dV/dQ register tile of flash_attention_bwd.cu: above it
# (fp32 at head_dim 256) the output's head dims are split over blocks, and
# so are a kv group's query heads, whose fp32 partials the kernels sum
BWD_DIM_TILE = 128
LOG2E = 1.4426950408889634
# the Hopper backward's dK/dV blocks: 128 keys (64 at head_dim 256, where
# a block's two warpgroups split each item's products), swept in 64-query
# items; the plan packs them into waves of one block per SM of the card,
# and sums the runs of a split key tile from fp32 partials.  csrc's kBKeys
# and kWBKeys: the C entry refuses a plan or partials sized for others
BWD_KEYS, BWD_KEYS_256, BWD_QUERIES = 128, 64, 64
# a dK/dV block's own cost (its K/V load, start and epilogue) in items,
# fitted to `tools/compare_flash_bwd.py --plans` on an H100: runs of one
# item a block took twice as long as runs of nine
BWD_BLOCK_COST = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _live(Sq: int, Sk: int, causal, window: int, device):
    """(Sq, Sk) bool: key kpos is live for query qpos."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window: int = 0,
                          scale=None, return_lse: bool = False):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd).  With
    ``return_lse`` also the natural-log log-sum-exp of each row's masked
    scaled scores, float32 (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    s = torch.where(_live(Sq, Sk, causal, window, q.device), s, NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    dt = torch.promote_types(p.dtype, v.dtype)       # as jnp promotes
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(dt), v.to(dt))
    out = out.reshape(B, Sq, H, hd)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal=True,
                              window: int = 0, scale=None, lse=None):
    """Gradients of :func:`flash_attention_plain` -> (dq, dk, dv) in the
    dtypes of q, k and v, computed in fp32 as the backward kernels do.

    ``out`` is the forward's output, ``dout`` its gradient (both
    (B,Sq,H,hd)); ``lse``, if given, the forward's natural-log log-sum-exp
    (B, H, Sq) (``flash_attention_plain(..., return_lse=True)``), else it
    is recomputed.  Masked scores are -1e30, so P = exp(s - lse) is exactly
    0 there.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
    s = torch.where(_live(Sq, Sk, causal, window, q.device), s, NEG)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
    else:
        lse = lse.float().reshape(B, KV, G, Sq, 1)
    p = torch.exp(s - lse)
    do = dout.float().reshape(B, Sq, KV, G, hd)
    delta = (do * out.float().reshape(B, Sq, KV, G, hd)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


HOPPER_HEAD_DIMS = (64, 128, 256)  # bf16 head dims of the TMA/wgmma kernels
HOPPER_BWD_HEAD_DIMS = (64, 128, 256)   # and of the TMA/wgmma backward


def _library():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        hop = lib.flash_attention_hopper_fwd
        hop.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        hop.restype = ctypes.c_int
    return lib


def uses_hopper_kernel(dtype, head_dim: int) -> bool:
    """Whether :func:`flash_attention_cuda` sends these inputs to the
    TMA/wgmma kernel (else the ``mma.sync`` or CUDA-core one)."""
    return dtype == torch.bfloat16 and head_dim in HOPPER_HEAD_DIMS


def uses_hopper_bwd_kernel(dtype, head_dim: int) -> bool:
    """Whether :func:`flash_attention_bwd_cuda` sends these inputs to the
    TMA/wgmma backward, which takes the forward's log-sum-exp (else the
    ``mma.sync`` or CUDA-core kernels, which rebuild it)."""
    return dtype == torch.bfloat16 and head_dim in HOPPER_BWD_HEAD_DIMS


def bwd_keys(head_dim: int) -> int:
    """Keys of one dK/dV block (one key tile of the plan) of the Hopper
    backward at ``head_dim``."""
    return BWD_KEYS_256 if head_dim == 256 else BWD_KEYS


def bwd_split_plan(B: int, Sq: int, Sk: int, H: int, KV: int, *,
                   causal=True, window: int = 0, sms: int,
                   keys: int = BWD_KEYS):
    """The Hopper backward's dK/dV plan on a card of ``sms`` SMs, a pure
    function of its arguments: ``(chunk, tiles)``, ``tiles[t] = (jlo, n,
    splits)`` for each key tile of ``keys`` keys (:func:`bwd_keys`:
    :data:`BWD_KEYS`, or :data:`BWD_KEYS_256` at head_dim 256).

    Query tiles ``jlo .. jlo + n - 1`` of :data:`BWD_QUERIES` positions hold
    a live pair for some key of tile t; its ``N = G * n`` items (query head,
    query tile), in that order, are cut into ``splits`` near-equal
    contiguous runs of at most ``chunk`` items, one block each (run s takes
    items ``s * N // splits`` to ``(s + 1) * N // splits``), for all (batch
    row, kv head) pairs.  The runs' fp32 partials are summed in run order
    by a second pass.  ``chunk`` minimises the waves of ``sms`` blocks
    times the longest run plus :data:`BWD_BLOCK_COST` (the larger on a tie:
    fewer partials).  The wrapper hands the kernels this plan as a table
    (:func:`_plan_table`); they do not recompute it.
    """
    return _bwd_split_plan(B, Sq, Sk, H, KV, bool(causal), int(window),
                           int(sms), int(keys))


@functools.lru_cache(maxsize=256)
def _bwd_split_plan(B, Sq, Sk, H, KV, causal, window, sms, keys):
    G = H // KV
    tiles = []
    for t in range(-(-Sk // keys)):
        k0, klast = t * keys, min((t + 1) * keys, Sk) - 1
        qlo = k0 if causal else 0
        qhi = min(Sq - 1, klast + window - 1) if window else Sq - 1
        jlo = qlo // BWD_QUERIES
        tiles.append((jlo, qhi // BWD_QUERIES - jlo + 1 if qlo <= qhi
                      else 0))
    items = [G * n for _, n in tiles]
    best = None
    for chunk in range(max(items + [1]), 0, -1):
        runs = [max(1, -(-N // chunk)) for N in items]
        longest = max(-(-N // r) for N, r in zip(items, runs))
        cost = -(-B * KV * sum(runs) // sms) * (longest + BWD_BLOCK_COST)
        if best is None or cost < best[0]:
            best = cost, chunk
    chunk = best[1]
    return chunk, tuple((jlo, n, max(1, -(-N // chunk)))
                        for (jlo, n), N in zip(tiles, items))


@functools.lru_cache(maxsize=256)
def _plan_table(tiles, device):
    """The plan's tiles as the kernels read them: int32 (tiles, 4) on
    ``device``, row t = (jlo, n, splits, the tile's first block)."""
    rows, slot0 = [], 0
    for jlo, n, splits in tiles:
        rows.append((jlo, n, splits, slot0))
        slot0 += splits
    return torch.tensor(rows, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(who, q, k, v):
    """Device, dtype and shape checks shared by both directions; returns
    (B, Sq, Sk, H, KV, hd)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{who}: {name} must be on {q.device} (CUDA), "
                             f"got {t.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{who} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{who}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or KV == 0 or H % KV:
        raise ValueError(f"{who}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    return B, Sq, Sk, H, KV, hd


def _check_limits(who, B, Sq, Sk, H, KV, hd, window, device):
    if H // KV > MAX_GROUP or hd % 8 or not 0 < hd <= MAX_HEAD_DIM \
            or window < 0:
        raise ValueError(f"{who}: needs H/KV <= {MAX_GROUP}, head_dim a "
                         f"multiple of 8 up to {MAX_HEAD_DIM} and window "
                         f">= 0; got H/KV={H // KV}, head_dim={hd}, "
                         f"window={window}")
    if B == 0 or Sq == 0:
        return
    # a query row with no live key would average V in the reference
    if Sk == 0 or (window and Sq >= Sk + window):
        raise ValueError(f"{who}: query rows without a live key (Sq={Sq}, "
                         f"Sk={Sk}, window={window})")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")


def flash_attention_cuda(q, k, v, *, causal=True, window: int = 0,
                         scale=None, return_lse: bool = False):
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`flash_attention_plain`.  q, k and v are float32 or bfloat16 of
    one dtype (made contiguous), ``H / KV <= 64``, head_dim a multiple of 8
    up to 256, and every query row must have a live key.  With
    ``return_lse`` (the TMA/wgmma route only, :func:`uses_hopper_kernel`)
    also each row's log-sum-exp in base 2, float32 (B, H, Sq): the natural
    one times :data:`LOG2E`, the unit the Hopper backward takes.  Raises
    on anything the kernel does not take, on an input that requires a
    gradient, and on a failed launch."""
    who = "flash_attention_cuda"
    B, Sq, Sk, H, KV, hd = _check_inputs(who, q, k, v)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(f"{who} is forward-only: call it under "
                           f"torch.no_grad() on tensors that do not require "
                           f"a gradient, or train through "
                           f"ops.flash_attention (the FlashAttention "
                           f"autograd Function)")
    _check_limits(who, B, Sq, Sk, H, KV, hd, window, q.device)
    hopper = uses_hopper_kernel(q.dtype, hd)
    if return_lse and not hopper:
        raise ValueError(f"{who}: return_lse needs the TMA/wgmma route "
                         f"(bfloat16, head_dim in {HOPPER_HEAD_DIMS}); got "
                         f"{q.dtype}, head_dim {hd}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B == 0 or Sq == 0:
        return (out, lse) if return_lse else out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError(f"{who}: tensors must be 16-byte aligned")
    args = (B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window),
            float(hd ** -0.5 if scale is None else scale))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _library()
    if hopper:
        err = lib.flash_attention_hopper_fwd(
            *ptrs, None if lse is None else lse.data_ptr(), *args, stream)
    else:
        err = lib.flash_attention_fwd(*ptrs, *args, _DTYPE_CODE[q.dtype],
                                      stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    streams.launched(flash_attention_cuda)
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, dout, *, causal=True,
                             window: int = 0, scale=None, lse=None):
    """Launch the backward kernels on the current stream; same contract as
    :func:`flash_attention_bwd_plain`, and the forward's limits (head_dim
    a multiple of 8 up to 256).  All five tensors are float32 or bfloat16
    of one dtype (made contiguous).

    Where :func:`uses_hopper_bwd_kernel` holds, ``lse`` is required: the
    base-2 log-sum-exp that ``flash_attention_cuda(..., return_lse=True)``
    returned for this ``out``, and no QK^T sweep rebuilds it.  The other
    kernels rebuild it and take no ``lse``.  Raises on anything the kernels
    do not take and on a failed launch."""
    who = "flash_attention_bwd_cuda"
    B, Sq, Sk, H, KV, hd = _check_inputs(who, q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape:
            raise ValueError(f"{who}: {name} must match q ({q.dtype}, "
                             f"{tuple(q.shape)} on {q.device}), got "
                             f"{t.dtype}, {tuple(t.shape)} on {t.device}")
    _check_limits(who, B, Sq, Sk, H, KV, hd, window, q.device)
    hopper = uses_hopper_bwd_kernel(q.dtype, hd)
    if hopper and (lse is None or lse.shape != (B, H, Sq)
                   or lse.dtype != torch.float32 or lse.device != q.device):
        got = None if lse is None else (lse.dtype, tuple(lse.shape),
                                        lse.device)
        raise ValueError(f"{who}: the TMA/wgmma backward needs the "
                         f"forward's base-2 log-sum-exp, float32 "
                         f"{(B, H, Sq)} on {q.device} "
                         f"(flash_attention_cuda(..., return_lse=True)); "
                         f"got {got}")
    if not hopper and lse is not None:
        raise ValueError(f"{who}: the {q.dtype} head_dim {hd} kernels "
                         f"rebuild the log-sum-exp and take none")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout, dq, dk, dv)):
        raise ValueError(f"{who}: tensors must be 16-byte aligned")
    scale = float(hd ** -0.5 if scale is None else scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if hopper:
        keys = bwd_keys(hd)
        _, tiles = bwd_split_plan(B, Sq, Sk, H, KV, causal=causal,
                                  window=window, sms=_sm_count(q.device),
                                  keys=keys)
        nslots = sum(splits for _, _, splits in tiles)
        lse = lse.contiguous()
        delta = torch.empty((B, H, Sq), dtype=torch.float32,
                            device=q.device)
        part = torch.empty(
            (B * KV * nslots * 2 * keys * hd
             if nslots > len(tiles) else 0,),
            dtype=torch.float32, device=q.device)
        err = _library_bwd_hopper().flash_attention_hopper_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), part.data_ptr(),
            _plan_table(tiles, q.device).data_ptr(), B, Sq, Sk, H, KV, hd,
            int(bool(causal)), int(window), scale, nslots, len(tiles),
            part.numel(), stream)
    else:
        stats = torch.empty((2, B, H, Sq), dtype=torch.float32,
                            device=q.device)
        # above BWD_DIM_TILE each query head's fp32 dK and dV, summed in
        # head order by the kernels
        part = torch.empty((2 * H * B * Sk * hd,), dtype=torch.float32,
                           device=q.device) if hd > BWD_DIM_TILE else None
        err = _library_bwd().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(),
            None if part is None else part.data_ptr(), B, Sq, Sk, H, KV,
            hd, int(bool(causal)), int(window), scale, _DTYPE_CODE[q.dtype],
            stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    streams.launched(flash_attention_bwd_cuda)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def _library_bwd():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library_bwd_hopper():
    lib = build.load("flash_attention_bwd_hopper")
    fn = lib.flash_attention_hopper_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel and the backward
    kernels on CUDA tensors, :func:`flash_attention_plain` and
    :func:`flash_attention_bwd_plain` on CPU tensors.  Saves q, k, v, the
    output and the log-sum-exp (the forward kernel's base-2 one where the
    Hopper backward takes it, the plain natural-log one on the CPU, none on
    the other kernels, which rebuild it); the backward rebuilds P from
    them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = q.detach(), k.detach(), v.detach()
        opts = {"causal": causal, "window": window, "scale": scale}
        if not q.is_cuda:
            out, lse = flash_attention_plain(q, k, v, return_lse=True,
                                             **opts)
        elif uses_hopper_bwd_kernel(q.dtype, q.shape[-1]):
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
        else:
            out, lse = flash_attention_cuda(q, k, v, **opts), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if q.is_cuda \
            else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, dout, lse=lse, **ctx.opts)
        return dq, dk, dv, None, None, None
