"""The port's full-sequence attention against the reference's oracle and
kernel.

``flash_attention_plain`` (the CPU path and the CUDA kernel's yardstick) is
held to ``repro.kernels.ref.flash_attention_ref`` and to
``flash_attention_pallas`` in interpret mode (16 x 16 tiles, so the grids
stay small), both called directly, on identical numpy inputs: GQA groups 1,
2 and 7, causal with no window and with a window shorter than the tile,
Sq and Sk not multiples of the tile, head_dim 16 and 40.  Tolerances: 2e-5
in fp32 (both sides fp32, summation order differs); 2e-2 in bf16 (the
reference and the plain version round the probabilities to bf16 before
P.V, the Pallas kernel keeps them in fp32).  The CUDA kernel itself is
checked against the plain version on a card, in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)

torch.set_num_threads(1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def make_case(seed, *, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    return q, k, v


def _both(case, dtype):
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in case]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in case]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("H,KV,hd", [(2, 2, 16), (4, 2, 40), (14, 2, 16)])
def test_plain_matches_reference_oracle_and_pallas(dtype, window, H, KV, hd):
    """Sq = Sk = 37: three 16-row tiles, the last one ragged; window 5 <
    the 16-key tile, so late rows' first tiles are wholly masked."""
    case = make_case(H * 10 + hd + window, B=2 if H < 14 else 1, Sq=37,
                     Sk=37, H=H, KV=KV, hd=hd)
    jx, tx = _both(case, dtype)
    got = flash_attention_plain(*tx, window=window).float().numpy()
    want = np.asarray(ref.flash_attention_ref(*jx, window=window),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    kern = np.asarray(flash_attention_pallas(*jx, window=window, qt=16,
                                             kt=16, interpret=True),
                      np.float32)
    np.testing.assert_allclose(got, kern, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_plain_ragged_sq_and_sk(causal, window):
    """Sq = 21 queries over Sk = 29 keys (neither a multiple of 16),
    positions from 0 on both sides, as the reference counts them."""
    case = make_case(3 + window, B=2, Sq=21, Sk=29, H=4, KV=2, hd=16)
    jx, tx = _both(case, "float32")
    got = flash_attention_plain(*tx, causal=causal, window=window).numpy()
    want = np.asarray(ref.flash_attention_ref(*jx, causal=causal,
                                              window=window))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    kern = np.asarray(flash_attention_pallas(
        *jx, causal=causal, window=window, qt=16, kt=16, interpret=True))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=0)


def test_plain_scale_and_output_dtype():
    case = make_case(9, B=1, Sq=12, Sk=12, H=4, KV=1, hd=8)
    jx, tx = _both(case, "bfloat16")
    got = flash_attention_plain(*tx, scale=0.3)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 12, 4, 8)
    want = np.asarray(ref.flash_attention_ref(*jx, scale=0.3), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_ops_dispatch_cpu_goes_to_plain_version():
    tx = [torch.from_numpy(a) for a in make_case(0, B=2, Sq=10, Sk=10, H=4,
                                                 KV=2, hd=8)]
    before = flash_attention_cuda.launches
    out = ops.flash_attention(*tx, window=3)
    torch.testing.assert_close(out, flash_attention_plain(*tx, window=3),
                               rtol=0, atol=0)
    assert flash_attention_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: off the card it raises."""
    tx = [torch.from_numpy(a) for a in make_case(1, B=1, Sq=8, Sk=8, H=2,
                                                 KV=1, hd=8)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(*tx)
