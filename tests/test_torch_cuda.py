"""The port's CUDA kernels on a card, against their plain versions.

Paged attention (fp32 and bf16 pools), quantized paged attention (int8 and
fp8-e4m3 codes under fp32 and bf16 queries) and the fused log-softmax
gather (bf16/bf16, fp32/bf16 and fp32/fp32, W row-major and transposed).

These tests need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so
elsewhere they skip.  The file imports neither JAX nor ``repro``, so it runs
on a machine that has only the port (``--noconftest``: the shared
``conftest.py`` imports JAX; the ``cuda`` marker is registered in
``pyproject.toml``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Paged serving through the kernel against dense serving on the card is
checked by ``chip_smoke.py`` (its toy agreement phase), not repeated here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, quant
from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                logprob_gather_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 paged_attention_quant_cuda,
                                                 paged_attention_quant_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel: no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def paged_case(seed, *, B=5, H=14, KV=2, hd=128, ps=16, nblk=4):
    """Random (stale) content in every page, a page shared by rows 0 and 1,
    the trash column last, one row at the trash column's first position."""
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
    return [torch.from_numpy(a) for a in (q, kp, vp, pt, pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       # plain casts probabilities to bf16
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,KV", [(14, 2), (4, 4)])      # G = 7 and 1
def test_paged_kernel_matches_plain(cuda_device, dtype, tol, window, H, KV):
    q, kp, vp, pt, pos = [t.to(cuda_device)
                          for t in paged_case(H + window, H=H, KV=KV)]
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    before = paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, pt, pos, window=window)
    want = paged_attention_plain(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


def quantize_pools(kp, vp, kv_dtype):
    """Per-page per-kv-head codes and scales of fp pools, as the engine
    writes them (scales amax / QMAX)."""
    dt = quant.pool_dtype(kv_dtype, torch.float32)
    out = []
    for pool in (kp, vp):
        sc = pool.abs().amax(dim=(1, 3)).clamp(min=quant.EPS) \
            / quant.QMAX[kv_dtype]
        out += [quant.quantize_codes(pool / sc[:, None, :, None], dt), sc]
    return out[0], out[2], out[1], out[3]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       # one bf16 rounding of the output
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,KV", [(14, 2), (4, 4)])      # G = 7 and 1
def test_quant_kernel_matches_plain(cuda_device, kv_dtype, dtype, tol,
                                    window, H, KV):
    q, kp, vp, pt, pos = [t.to(cuda_device)
                          for t in paged_case(H + window + 1, H=H, KV=KV)]
    kp, vp, ks, vs = quantize_pools(kp, vp, kv_dtype)
    q = q.to(dtype)
    before = paged_attention_quant_cuda.launches
    got = ops.paged_attention_quant(q, kp, vp, ks, vs, pt, pos,
                                    window=window)
    want = paged_attention_quant_plain(q, kp, vp, ks, vs, pt, pos,
                                       window=window)
    torch.cuda.synchronize()
    assert paged_attention_quant_cuda.launches == before + 1
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("hd", [40, 8])        # 8-byte and 4-byte copies
def test_quant_kernel_narrow_heads(cuda_device, kv_dtype, hd):
    """head_dim 40 (the toy target's) is not a multiple of 16 codes."""
    q, kp, vp, pt, pos = [t.to(cuda_device)
                          for t in paged_case(hd, H=4, KV=2, hd=hd)]
    kp, vp, ks, vs = quantize_pools(kp, vp, kv_dtype)
    got = ops.paged_attention_quant(q, kp, vp, ks, vs, pt, pos)
    want = paged_attention_quant_plain(q, kp, vp, ks, vs, pt, pos)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 2e-5, err


@pytest.mark.cuda
def test_paged_kernel_refuses_fp32_queries_over_bf16_pools(cuda_device):
    """kv_dtype="bf16" under fp32 activations: the kernel takes one dtype
    for q and the pools, so the call raises rather than casting."""
    q, kp, vp, pt, pos = [t.to(cuda_device) for t in paged_case(3)]
    with pytest.raises(TypeError):
        ops.paged_attention(q, kp.bfloat16(), vp.bfloat16(), pt, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("hdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("tied", [False, True])
def test_logprob_gather_kernel_matches_plain(cuda_device, hdt, wdt, tied):
    """T = 130 (not a multiple of the 64-token tile), V = 1024 with
    vocab_size 1000 (masked tail, not a multiple of the 64-column tile),
    labels including 0 and vocab_size - 1.  Tolerance 1e-3 absolute on
    log-probs: both sides compute in fp32 from the same inputs (bf16 x bf16
    is exact in fp32) and differ only in summation order."""
    rng = np.random.default_rng(7)
    B, S, d, V, vocab = 2, 65, 256, 1024, 1000
    h = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, V)).astype(np.float32)
                         / np.sqrt(d))
    labels = torch.from_numpy(rng.integers(0, vocab, (B, S)))
    labels[0, 0], labels[1, -1] = 0, vocab - 1
    h, labels = h.to(cuda_device, hdt), labels.to(cuda_device)
    w = w.to(cuda_device, wdt)
    if tied:                            # W = E.T of a row-major (V, d) E
        w = w.T.contiguous().T
    before = logprob_gather_cuda.launches
    got = ops.logprob_gather(h, w, labels, vocab)
    want = logprob_gather_plain(h, w, labels, vocab)
    torch.cuda.synchronize()
    assert logprob_gather_cuda.launches == before + 1
    assert got.shape == (B, S) and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-3, err
