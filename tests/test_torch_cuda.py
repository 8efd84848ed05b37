"""The port's CUDA kernels on a card, against their plain versions.

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

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)


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
