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
  128 (every Qwen2.5-Math layer) goes to the TMA/wgmma kernel; other bf16
  head dims to the ``mma.sync`` kernel and fp32 to the CUDA-core kernel,
  chosen from dtype and shape before the launch.  It is forward-only: an
  input that requires a gradient raises, since no backward kernel exists.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1e30
MAX_GROUP = 64        # query heads per kv head (the kernel's 64 query rows)
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal=True, window: int = 0,
                          scale=None):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    dt = torch.promote_types(p.dtype, v.dtype)       # as jnp promotes
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(dt), v.to(dt))
    return out.reshape(B, Sq, H, hd)


HOPPER_HEAD_DIMS = (64, 128)   # bf16 head dims of the TMA/wgmma kernel


def _library():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        hop = lib.flash_attention_hopper_fwd
        hop.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        hop.restype = ctypes.c_int
    return lib


def uses_hopper_kernel(dtype, head_dim: int) -> bool:
    """Whether :func:`flash_attention_cuda` sends these inputs to the
    TMA/wgmma kernel (else the ``mma.sync`` or CUDA-core one)."""
    return dtype == torch.bfloat16 and head_dim in HOPPER_HEAD_DIMS


def flash_attention_cuda(q, k, v, *, causal=True, window: int = 0,
                         scale=None):
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`flash_attention_plain`.  q, k and v are float32 or bfloat16 of
    one dtype (made contiguous), ``H / KV <= 64``, head_dim a multiple of 8
    up to 128, and every query row must have a live key.  Raises on
    anything the kernel does not take, on an input that requires a
    gradient, and on a failed launch."""
    who = "flash_attention_cuda"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{who}: {name} must be on {q.device} (CUDA), "
                             f"got {t.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(f"{who} is forward-only (no backward kernel): "
                           f"call it under torch.no_grad() on tensors that "
                           f"do not require a gradient")
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
    if H // KV > MAX_GROUP or hd % 8 or not 0 < hd <= MAX_HEAD_DIM \
            or window < 0:
        raise ValueError(f"{who}: needs H/KV <= {MAX_GROUP}, head_dim a "
                         f"multiple of 8 up to {MAX_HEAD_DIM} and window "
                         f">= 0; got H/KV={H // KV}, head_dim={hd}, "
                         f"window={window}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    # a query row with no live key would average V in the reference
    if Sk == 0 or (window and Sq >= Sk + window):
        raise ValueError(f"{who}: query rows without a live key (Sq={Sq}, "
                         f"Sk={Sk}, window={window})")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError(f"{who}: tensors must be 16-byte aligned")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(bool(causal)), int(window),
            float(hd ** -0.5 if scale is None else scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _library()
    if uses_hopper_kernel(q.dtype, hd):
        err = lib.flash_attention_hopper_fwd(*args, stream)
    else:
        err = lib.flash_attention_fwd(*args, _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
