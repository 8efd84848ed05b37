"""The glue the card's vocab gather depends on, on the CPU.

With fp32 h over bf16 W, ``logprob_gather_cuda`` runs its tensor-core
kernel on three bf16 parts of h (``bf16_split``) against the same W and
sums the three products in one fp32 accumulator.  Held here, on numpy
inputs from a seed:

* the parts sum back to h within 2^-20 |h| (each part takes the next 8 of
  fp32's 24 bits; what is left is below 2^-24 |h|);
* the log-probs from sum_i h_i @ W match ``logprob_gather_plain`` on fp32 h
  and ``repro.kernels.ref.logprob_gather_ref`` within the kernel's
  tolerance of 1e-3 + 1e-5 |log-prob|, W row-major and a tied embedding's
  transpose, ``vocab_size < V``;
* ``vocab_split`` covers every strip once with no split empty, for the
  TMA/wgmma kernel's tiles and the fp32 kernel's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels.logprob_gather import (FP32_TILES, HOPPER_TILES,
                                                bf16_split,
                                                logprob_gather_plain,
                                                vocab_split)

torch.set_num_threads(1)
ATOL, RTOL = 1e-3, 1e-5


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_parts_sum_back_to_h(scale):
    rng = np.random.default_rng(int(scale * 1000) % 97)
    h = (scale * rng.standard_normal((3, 7, 96))).astype(np.float32)
    h[0, 0, :4] = [0.0, -0.0, 1.0, -2.5]            # exact in bf16 already
    parts = bf16_split(torch.from_numpy(h))
    assert parts.shape == (3, *h.shape) and parts.dtype == torch.bfloat16
    total = parts.double().sum(0).numpy()
    err = np.abs(total - h.astype(np.float64))
    assert (err <= 2.0 ** -20 * np.abs(h)).all(), err.max()
    # exact values need no lower parts
    assert (parts[1:, 0, 0, :4] == 0).all()


def gather_case(seed, *, B=2, S=33, d=96, V=300, vocab=287, tied=False):
    """fp32 h, bf16-valued W (row-major (d, V), or a (V, d) embedding's
    transpose), labels with 0 and vocab - 1."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((V, d) if tied else (d, V)).astype(np.float32)
    w = torch.from_numpy(w).bfloat16()
    labels = rng.integers(0, vocab, (B, S))
    labels[0, 0], labels[-1, -1] = 0, vocab - 1
    return h, (w.T if tied else w), labels


def split_logprobs(h, w, labels, vocab):
    """log-softmax gather of sum_i h_i @ W, the kernel's three products,
    each accumulated in fp32."""
    parts = bf16_split(torch.from_numpy(h))
    logits = sum(p.float() @ w.float() for p in parts)
    valid = torch.arange(logits.shape[-1]) < vocab
    logits = torch.where(valid, logits, -1e30)
    picked = torch.gather(logits, -1, torch.from_numpy(labels)[..., None])
    return (picked[..., 0] - torch.logsumexp(logits, -1)).numpy()


@pytest.mark.parametrize("tied", [False, True])
def test_split_products_match_plain_and_reference(tied):
    h, w, labels = gather_case(5 + tied, tied=tied)
    vocab = 287
    got = split_logprobs(h, w, labels, vocab)
    plain = logprob_gather_plain(torch.from_numpy(h), w,
                                 torch.from_numpy(labels), vocab).numpy()
    want = np.asarray(ref.logprob_gather_ref(
        jnp.asarray(h), jnp.asarray(w.float().numpy()), jnp.asarray(labels),
        vocab))
    for other in (plain, want):
        over = np.abs(got - other) - ATOL - RTOL * np.abs(other)
        assert over.max() <= 0, np.abs(got - other).max()
    # and the split is what makes it: bf16(h) alone is far off
    one = bf16_split(torch.from_numpy(h))[0].float().numpy()
    assert np.abs(split_logprobs(one, w, labels, vocab) - got).max() > 1e-3


@pytest.mark.parametrize("tiles", [HOPPER_TILES, FP32_TILES])
@pytest.mark.parametrize("tokens,vocab", [(1, 64), (130, 1000),
                                          (256, 151936), (2000, 65536)])
def test_vocab_split_covers_every_strip_once(tiles, tokens, vocab):
    per, nsplit = vocab_split(tokens, vocab, 132, tiles)
    strips = -(-vocab // tiles[1])
    assert per >= 1 and nsplit >= 1
    assert nsplit * per >= strips > (nsplit - 1) * per      # none empty
    ttiles = -(-tokens // tiles[0])
    if strips >= nsplit > 1:            # the grid aims at tiles[2] per SM
        assert ttiles * (nsplit - 1) < tiles[2] * 132
