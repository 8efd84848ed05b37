"""The port's paged attention against the reference's oracle and kernel.

``paged_attention_plain`` (the CPU path and the CUDA kernel's yardstick) is
held to ``repro.kernels.ref.paged_attention_ref`` and to the Pallas kernel
run in interpret mode, on identical numpy inputs: GQA groups 1, 2 and 7,
page sizes 4 and 16, full and sliding-window masks, random (stale) content
in every page, a page shared by two rows, and the trash column; and with
fp32 queries over bf16 pools against the oracle's promotion.  The CUDA
kernel itself is checked against the plain version on a card, in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)

torch.set_num_threads(1)
ATOL = 1e-5


def make_case(seed, *, B, H, KV, hd, ps, nblk):
    """Numpy inputs: every page holds random values (stale rows included),
    rows 0 and 1 share their first page, the last table column is the
    trash page, and one row sits at the trash column's first position."""
    rng = np.random.default_rng(seed)
    P = B * nblk + 2
    trash = P - 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pt = rng.permutation(P - 1)[:B * nblk].reshape(B, nblk)
    pt[1, 0] = pt[0, 0]
    pt = np.concatenate([pt, np.full((B, 1), trash)], axis=1).astype(np.int32)
    pos = np.linspace(0, nblk * ps - 2, B).astype(np.int32)
    pos[-1] = nblk * ps                  # garbage-at-pos write position
    return q, kp, vp, pt, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2), (14, 2)])   # G = 1, 2, 7
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("window", [0, 8])
def test_plain_matches_reference_oracle_and_pallas(H, KV, ps, window):
    case = make_case(H * 100 + ps + window, B=3, H=H, KV=KV, hd=16, ps=ps,
                     nblk=max(2, 24 // ps))
    got = paged_attention_plain(*_torch(*case), window=window).numpy()
    want = np.asarray(ref.paged_attention_ref(
        *[jnp.asarray(a) for a in case], window=window))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    kern = np.asarray(paged_attention_pallas(
        *[jnp.asarray(a) for a in case], window=window, interpret=True))
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,KV", [(4, 2), (14, 2)])            # G = 2, 7
@pytest.mark.parametrize("window", [0, 8])
def test_plain_fp32_queries_over_bf16_pools_match_reference(H, KV, window):
    """kv_dtype="bf16" under fp32 activations: the plain version promotes
    the bf16 K and V to fp32 as jnp does, and returns fp32 (the card's
    kernel widens them the same way)."""
    q, kp, vp, pt, pos = make_case(H + window + 7, B=3, H=H, KV=KV, hd=16,
                                   ps=4, nblk=6)
    kpb, vpb = (torch.from_numpy(a).bfloat16() for a in (kp, vp))
    got = paged_attention_plain(torch.from_numpy(q), kpb, vpb,
                                torch.from_numpy(pt), torch.from_numpy(pos),
                                window=window)
    assert got.dtype == torch.float32
    want = np.asarray(ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp).astype(jnp.bfloat16),
        jnp.asarray(vp).astype(jnp.bfloat16), jnp.asarray(pt),
        jnp.asarray(pos), window=window))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_ops_dispatch_cpu_goes_to_plain_version():
    case = _torch(*make_case(0, B=2, H=4, KV=2, hd=8, ps=4, nblk=3))
    before = paged_attention_cuda.launches
    out = ops.paged_attention(*case, window=5)
    torch.testing.assert_close(out, paged_attention_plain(*case, window=5),
                               rtol=0, atol=0)
    assert paged_attention_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: off the card it raises."""
    case = _torch(*make_case(1, B=2, H=4, KV=2, hd=8, ps=4, nblk=3))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*case)
