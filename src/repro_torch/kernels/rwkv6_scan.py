"""WKV6 recurrence (RWKV-6 time-mix inner loop): plain version and kernel.

Per (batch row, head), with an fp32 state ``S`` of shape (hd, hd), at every
step t::

    out_t[n] = sum_k r_t[k] * (S[k, n] + u[k] * k_t[k] * v_t[n])
    S[k, n] <- w_t[k] * S[k, n] + k_t[k] * v_t[n]

* :func:`rwkv6_scan_plain` mirrors ``repro.kernels.ref.rwkv6_scan_ref``
  (and the model's ``_wkv_scan``): the sequential recurrence in fp32, one
  step at a time.  The CPU path, and the yardstick the kernel is held to.
* :func:`rwkv6_scan_cuda` launches ``csrc/rwkv6_scan.cu`` (the Hopper
  kernel that replaces ``rwkv6_scan_pallas``) and counts its launches in
  ``rwkv6_scan_cuda.launches``.  It is forward-only: an input that requires
  a gradient raises, since no backward kernel exists.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)          # the kernel's template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _library():
    lib = build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_cuda(r, k, v, w, u, state):
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`rwkv6_scan_plain`.  r, k and v are float32 or bfloat16 of one
    dtype; w, u and state float32; hd is 32 or 64.  Inputs are made
    contiguous; the final state goes to a fresh buffer.  Raises on anything
    the kernel does not take, on an input that requires a gradient, and on
    a failed launch."""
    who = "rwkv6_scan_cuda"
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state))
    for name, t in named:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{who}: {name} must be on {r.device} (CUDA), "
                             f"got {t.device}")
    if any(t.requires_grad for _, t in named):
        raise RuntimeError(f"{who} is forward-only (no backward kernel): "
                           f"call it under torch.no_grad() on tensors that "
                           f"do not require a gradient")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"{who} takes float32 or bfloat16 r/k/v of one "
                        f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 \
            or state.dtype != torch.float32:
        raise TypeError(f"{who}: w, u and state must be float32, got "
                        f"{w.dtype}, {u.dtype}, {state.dtype}")
    if r.dim() != 4:
        raise ValueError(f"{who}: r must be (B,T,H,hd), got "
                         f"{tuple(r.shape)}")
    B, T, H, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"{who}: bad shapes r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} w "
                         f"{tuple(w.shape)} u {tuple(u.shape)} state "
                         f"{tuple(state.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {hd} not in {HEAD_DIMS}")
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    final = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return out, final
    if r.device.index != torch.cuda.current_device():
        raise ValueError(f"{who}: tensors on {r.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    r, k, v, w, u, state = (t.contiguous() for t in (r, k, v, w, u, state))
    err = _library()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), state.data_ptr(), out.data_ptr(),
                     final.data_ptr(), B, T, H, hd, _DTYPE_CODE[r.dtype],
                     torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    rwkv6_scan_cuda.launches += 1
    return out, final


rwkv6_scan_cuda.launches = 0
