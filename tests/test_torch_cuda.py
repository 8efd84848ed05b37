"""The port's CUDA kernels on a card, against their plain versions.

Paged attention (fp32 and bf16 pools, and fp32 queries over bf16 pools),
quantized paged attention (int8 and fp8-e4m3 codes under fp32 and bf16
queries), both also at head_dim 256 with G = 16 and 4 (the Gemma
families' decode shapes) and at the split plan's shapes (the engine's
33-column table with positions up to 527, B = KV = 1, G = 16, windows
that leave splits empty, head_dim 8, 40 and 256, pages of 4, 8 and 32
rows), bitwise deterministic, on two streams at once, and captured in a
CUDA graph; the fused log-softmax gather (bf16/bf16 and fp32/bf16 through
the TMA/wgmma kernel, fp32 h as three bf16 parts; fp32/fp32; W row-major
and transposed; ragged tokens, depth and vocabulary strips), and
full-sequence flash attention (fp32 and bf16; GQA groups 1, 2, 6, 7 and
64; head_dim 16, 40, 64, 128 and 256, bf16 at 64, 128 and 256 through
the TMA/wgmma kernels; windows shorter and longer than the key tile;
ragged Sq and Sk, Sk > Sq non-causal; the cross and encoder families'
non-causal shapes up to Sk 6404, on N(0, 1) inputs and on a case whose
softmax the last 4 keys decide), which refuses inputs that require
a gradient when called directly, and its backward kernel (fp32 and bf16;
the same groups, head dims up to 256, G 4 and 16 at 256 with windows that
bind, one of 8 and ragged shapes, bf16 at 256 through the TMA/wgmma
kernels from the forward's log-sum-exp and raising without it; bitwise
deterministic;
through the autograd Function of ``ops.flash_attention``; one toy train
step on the card against the CPU), and the WKV6 scan
(head dims 32 and 64; T = 1, 17 and 1000; bf16 and fp32 r/k/v; spread
decays and a non-zero initial state; decays at the model's clamp ends and
mixed; B = H = 1 at T = 4096, many segments; forced plans down to
one-step segments; the in-place decode form with half the rows frozen,
their state bitwise unchanged; bitwise deterministic, on two streams at
once, and captured in a CUDA graph), which refuses other head dims and,
called directly, inputs that require a gradient, and its backward kernel
(head dims 32 and 64, bf16 and fp32, T 1 to 600, spread and mixed
clamp-end decays, with and without a final-state cotangent, and T 4096
with decays near 1, bitwise deterministic, through the ``WKV6Scan``
autograd Function of ``ops.rwkv6_scan``).  One train step of a reduced
rwkv6-3b and of a reduced gemma3-1b at head_dim 256 on the card matches
the CPU's, and ``launch.train --reduced`` trains both on the card.  A toy
model's ``score`` on the card launches the flash kernel once per layer
and the gather once; a toy RWKV model's ``score`` and ``decode_step``
launch the scan once per layer.

These tests need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so
elsewhere they skip.  Two cases run on the CPU too: they show that the
cross shapes' tail case fails a kernel that drops the 4 keys past the
last full tile or lets a tile's padding into the softmax.  The file imports neither JAX nor ``repro``, so it runs
on a machine that has only the port (``--noconftest``: the shared
``conftest.py`` imports JAX; the ``cuda`` marker is registered in
``pyproject.toml``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Paged serving through the kernel against dense serving on the card is
checked by ``chip_smoke.py`` (its toy agreement phase), not repeated here.
On the toy triple the card's chunked prefill (``extend``) and a priority
preemption with its resume commit the CPU's tokens, and a radix-cache
snapshot round trip (bf16 and int8 pools) is bitwise.  A threaded
two-replica fleet (a thread and a CUDA stream a replica; bf16 pages, and
int8 pages with shared scoring) commits the CPU's sequential fleet's
tokens with exact launch counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, quant, rwkv6_scan
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.logprob_gather import (logprob_gather_cuda,
                                                logprob_gather_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 paged_attention_quant_cuda,
                                                 paged_attention_quant_plain)
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                            rwkv6_scan_cuda_,
                                            rwkv6_scan_plain, scan_plan)


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
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,KV", [(14, 2), (4, 4)])      # G = 7 and 1
def test_paged_kernel_refuses_fp32_queries_over_bf16_pools(cuda_device,
                                                           window, H, KV):
    """kv_dtype="bf16" under fp32 activations: the kernel widens the bf16
    K and V to fp32 as it reads them and computes in fp32, as the plain
    version's promotion does (2e-5, summation order only).  Every other
    mixed pair, such as bf16 queries over fp32 pools, is refused."""
    q, kp, vp, pt, pos = [t.to(cuda_device)
                          for t in paged_case(H + window + 3, H=H, KV=KV)]
    kp, vp = kp.bfloat16(), vp.bfloat16()
    before = paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, pt, pos, window=window)
    want = paged_attention_plain(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == before + 1
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 2e-5, err
    with pytest.raises(TypeError):
        ops.paged_attention(q.bfloat16(), kp.float(), vp.float(), pt, pos)
    assert paged_attention_cuda.launches == before + 1


# (B, H, KV, head_dim, page size, table columns, largest pos, window):
# the split plan's shapes.  "long" is the engine's 33-column table at
# max_seq 512 with the last row in the trash column; "b1kv1" gives one
# (row, kv head) pair its 9 splits; "window" leaves the early splits of
# long rows with no live position; "ps8" and "ps4" give each warp two and
# four pages; "hd256-ps32" is the layout whose pages are cut into units of
# 16 rows when the pools are fp32
SPLIT_SHAPES = {
    "long": (16, 28, 4, 128, 16, 33, 527, 0),
    "b1kv1": (1, 7, 1, 128, 16, 33, 527, 0),
    "g16": (4, 32, 2, 64, 16, 33, 300, 0),
    "window": (8, 28, 4, 128, 16, 33, 527, 40),
    "hd8": (4, 8, 2, 8, 16, 12, 180, 0),
    "hd40-ps8": (4, 14, 2, 40, 8, 20, 150, 8),
    "ps4-g1": (3, 4, 4, 16, 4, 40, 150, 0),
    "hd256-ps32": (3, 14, 2, 256, 32, 10, 300, 0),
}
# (q dtype, pool kind, tolerance): the kernels' instances
SPLIT_KINDS = {
    "fp32": (torch.float32, torch.float32, 2e-5),
    "bf16": (torch.bfloat16, torch.bfloat16, 2e-2),
    "fp32-over-bf16": (torch.float32, torch.bfloat16, 2e-5),
    "int8-bf16q": (torch.bfloat16, "int8", 2e-2),
    "fp8-fp32q": (torch.float32, "fp8", 2e-5),
}


def split_case(kind, shape, seed, device):
    """Inputs of one paged call at ``SPLIT_SHAPES[shape]``: distinct random
    pages in every column but the last (the trash page), stale values
    everywhere, rows 0 and 1 sharing their first page, positions spread up
    to the largest.  Returns (kernel wrapper, plain version, args, window,
    tolerance)."""
    B, H, KV, hd, ps, nblk1, top, window = SPLIT_SHAPES[shape]
    qdt, pool, tol = SPLIT_KINDS[kind]
    rng = np.random.default_rng(seed)
    P = B * (nblk1 - 1) + 1
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(
        np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (P, ps, KV, hd)).astype(np.float32)) for _ in range(2))
    pt = rng.permutation(P - 1)[:B * (nblk1 - 1)].reshape(B, nblk1 - 1)
    pt[min(1, B - 1), 0] = pt[0, 0]
    pt = np.concatenate([pt, np.full((B, 1), P - 1)], axis=1)
    pos = np.linspace(top, 0, B).astype(np.int32)
    pt, pos = torch.from_numpy(pt.astype(np.int32)), torch.from_numpy(pos)
    q = q.to(device, qdt)
    pt, pos = pt.to(device), pos.to(device)
    if isinstance(pool, str):
        kc, vc, ks, vs = quantize_pools(kp.to(device), vp.to(device), pool)
        return (paged_attention_quant_cuda, paged_attention_quant_plain,
                (q, kc, vc, ks, vs, pt, pos), window, tol)
    return (paged_attention_cuda, paged_attention_plain,
            (q, kp.to(device, pool), vp.to(device, pool), pt, pos), window,
            tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SPLIT_SHAPES))
@pytest.mark.parametrize("kind", list(SPLIT_KINDS))
def test_paged_kernels_split_shapes(cuda_device, kind, shape):
    """Both redesigned kernels at every split shape, each instance of
    theirs, against the plain versions; one launch counted per call."""
    fn, plain, args, window, tol = split_case(kind, shape, len(shape),
                                              cuda_device)
    before = fn.launches
    got = fn(*args, window=window)
    want = plain(*args, window=window)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8-bf16q"])
@pytest.mark.parametrize("shape", ["long", "window"])
def test_paged_kernels_are_deterministic(cuda_device, kind, shape):
    """The partials merge in a fixed order, with no atomics: one input gives
    bitwise the same output on every call."""
    fn, _, args, window, _ = split_case(kind, shape, 3, cuda_device)
    first = fn(*args, window=window)
    for _ in range(3):
        assert torch.equal(fn(*args, window=window), first)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8-bf16q"])
def test_paged_kernels_on_two_streams(cuda_device, kind):
    """Each stream keeps its own partials' scratch: calls in flight on two
    streams at once, over different inputs, each match the plain version
    (a shared scratch would mix their partials)."""
    fn, plain, args_a, window, tol = split_case(kind, "long", 7, cuda_device)
    _, _, args_b, _, _ = split_case(kind, "window", 8, cuda_device)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for stream, args in zip(streams, (args_a, args_b)):
            with torch.cuda.stream(stream):
                outs.append(fn(*args, window=window))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        args = (args_a, args_b)[i % 2]
        want = plain(*args, window=window)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "fp32-over-bf16", "int8-bf16q",
                                  "fp8-fp32q"])
def test_paged_kernels_capture_in_a_cuda_graph(cuda_device, kind):
    """Each wrapper (the split plan, the partials' scratch and both
    launches) records into a torch.cuda.graph: it makes no host sync and
    allocates nothing outside the graph's pool.  A replay over new inputs
    copied into the captured tensors equals the eager call."""
    fn, _, args, window, _ = split_case(kind, "long", 5, cuda_device)
    fn(*args, window=window)                  # build and load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, window=window)
    _, _, fresh, _, _ = split_case(kind, "long", 6, cuda_device)
    for dst, src in zip(args, fresh):
        dst.copy_(src)
    graph.replay()
    want = fn(*args, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("hdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tied", [False, True])
def test_logprob_gather_hopper_strips_and_depth(cuda_device, hdt, tied):
    """bf16 W through the TMA/wgmma kernel: T = 130 (two token tiles, the
    second ragged), d = 200 (four 64-deep chunks, the last ragged), V =
    1600 with vocab_size 1537 (seven 256-column strips, the last holding
    one live column, some splits more than one strip), labels 0,
    vocab_size - 1 (that live column) and 1535 (the strip before's last
    column).  Held to the plain
    version at 1e-3 + 1e-5 |log-prob| (fp32 math both sides, summation
    order; fp32 h as three bf16 parts leaves below 2^-24 |h|)."""
    rng = np.random.default_rng(11)
    B, S, d, V, vocab = 2, 65, 200, 1600, 1537
    h = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, (B, S)))
    labels[0, 0], labels[1, -1], labels[0, 1] = 0, vocab - 1, 1535
    h, labels = h.to(cuda_device, hdt), labels.to(cuda_device)
    w = w.to(cuda_device, torch.bfloat16)
    if tied:
        w = w.T.contiguous().T
    before = logprob_gather_cuda.launches
    got = ops.logprob_gather(h, w, labels, vocab)
    want = logprob_gather_plain(h, w, labels, vocab)
    torch.cuda.synchronize()
    assert logprob_gather_cuda.launches == before + 1
    over = ((got - want).abs() - 1e-3 - 1e-5 * want.abs()).max().item()
    assert over <= 0, (got - want).abs().max().item()


def flash_case(seed, *, B, Sq, Sk, H, KV, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for shape in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                             (B, Sk, KV, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       # plain casts probabilities to bf16
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 5, 100])
@pytest.mark.parametrize("H,KV,hd", [(14, 2, 128), (4, 4, 40), (4, 2, 16),
                                     (64, 1, 8)])     # G = 7, 1, 2, 64
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, window, H, KV,
                                    hd):
    """S = 300: neither a multiple of the 64-key tile nor of any group's
    query tile; window 5 leaves late rows' first visited tiles wholly
    masked, window 100 spans tiles."""
    q, k, v = flash_case(H + hd + window, B=2, Sq=300, Sk=300, H=H, KV=KV,
                         hd=hd, dtype=dtype, device=cuda_device)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 70, 130), (True, 0, 130, 70), (True, 9, 150, 145),
    (False, 0, 70, 130), (False, 33, 90, 90)])
def test_flash_kernel_ragged_and_noncausal(cuda_device, dtype, tol, causal,
                                           window, Sq, Sk):
    q, k, v = flash_case(Sq + Sk + window, B=3, Sq=Sq, Sk=Sk, H=6, KV=2,
                         hd=64, dtype=dtype, device=cuda_device)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=0.1)
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=0.1)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(28, 4), (12, 2), (4, 4)])  # G = 7, 6, 1
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 8, 300, 300), (True, 200, 300, 300),
    (False, 0, 150, 333)])
def test_flash_hopper_kernel_matches_plain(cuda_device, hd, H, KV, causal,
                                           window, Sq, Sk):
    """bf16 at head_dim 64 and 128 goes to the TMA/wgmma kernel.  Sq = 300
    is not a multiple of any group's query tile (2 x 9, 2 x 10, 2 x 64
    positions); window 8 is shorter than the 128-key tile (late rows' first
    tile wholly masked) and 200 longer; Sk = 333 > Sq without the causal
    mask leaves a ragged last key tile."""
    from repro_torch.kernels.flash_attention import uses_hopper_kernel
    assert uses_hopper_kernel(torch.bfloat16, hd)
    q, k, v = flash_case(H + hd + window + Sk, B=2, Sq=Sq, Sk=Sk, H=H, KV=KV,
                         hd=hd, dtype=torch.bfloat16, device=cuda_device)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("H,KV", [(4, 1), (16, 1)])   # gemma3, recurrentgemma
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 8, 300, 300), (True, 100, 300, 300),
    (False, 0, 150, 333)])
def test_flash_head_dim_256_matches_plain(cuda_device, dtype, tol, H, KV,
                                          causal, window, Sq, Sk):
    """head_dim 256: bf16 through the 256-wide TMA/wgmma kernel (64-key
    tiles: window 8 leaves late rows' first tile wholly masked, 100 spans
    two), fp32 through the CUDA-core kernel's 256-wide instance; asked for
    its log-sum-exp, the bf16 kernel's output is the same bits."""
    from repro_torch.kernels.flash_attention import (LOG2E,
                                                     uses_hopper_kernel)
    assert uses_hopper_kernel(dtype, 256) == (dtype == torch.bfloat16)
    q, k, v = flash_case(H + window + Sk, B=2, Sq=Sq, Sk=Sk, H=H, KV=KV,
                         hd=256, dtype=dtype, device=cuda_device)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
    if dtype == torch.bfloat16:
        again, lse2 = flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(again, got)
        assert (lse2 / LOG2E - lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 8, 300, 300), (True, 200, 511, 511),
    (True, 0, 77, 77), (False, 0, 150, 333), (False, 33, 300, 300),
    (False, 40, 233, 200)])
@pytest.mark.parametrize("H,KV", [(4, 1), (16, 1)])     # G = 4 and 16
def test_flash_backward_head_dim_256(cuda_device, dtype, tol, causal, window,
                                     Sq, Sk, H, KV):
    """The Gemma families' training heads: the backward at head_dim 256
    against the plain version, to ``tol`` of each gradient's scale, twice
    bitwise; then through the autograd Function (one forward and one
    backward launch).  bf16 goes to the TMA/wgmma kernels, from the
    forward kernel's base-2 log-sum-exp; fp32 to the kernels that rebuild
    it (each 128-wide half of the output's head dims a block of its own).
    Window 200 binds at S 511 (ragged against every tile), 8 is shorter
    than a tile, S 77 is shorter than a 128-key tile; the non-causal cases
    (an encoder's or cross layer's masks) take the kernels' other bounds:
    ragged with Sq < Sk, a window alone at Sq = Sk, and a window alone
    with Sq > Sk."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        uses_hopper_bwd_kernel)
    hopper = uses_hopper_bwd_kernel(dtype, 256)
    assert hopper == (dtype == torch.bfloat16)
    q, k, v = flash_case(H + window + Sq, B=2, Sq=Sq, Sk=Sk, H=H, KV=KV,
                         hd=256, dtype=dtype, device=cuda_device)
    opts = {"causal": causal, "window": window}
    if hopper:
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
        kw = {"lse": lse, **opts}
    else:
        out, kw = flash_attention_cuda(q, k, v, **opts), opts
    dout = torch.randn(q.shape, device=cuda_device).to(dtype)
    got = flash_attention_bwd_cuda(q, k, v, out, dout, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, dout, **opts)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches)
    grads = torch.autograd.grad(ops.flash_attention(*leaves, **opts),
                                leaves, dout)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert all(torch.equal(g, w) for g, w in zip(grads, got))


@pytest.mark.cuda
def test_flash_backward_head_dim_256_needs_the_forwards_lse(cuda_device):
    """bf16 at head_dim 256 goes to the TMA/wgmma backward, which takes the
    forward's log-sum-exp: called without it, or with the natural-log
    shape wrong, the wrapper raises before any launch."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v = flash_case(3, B=1, Sq=100, Sk=100, H=4, KV=1, hd=256,
                         dtype=torch.bfloat16, device=cuda_device)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    before = flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd_cuda(q, k, v, out, out)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd_cuda(q, k, v, out, out, lse=lse[:, :, :50])
    assert flash_attention_bwd_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,KV", [(16, 1), (4, 1)])     # G = 16 and 4
def test_paged_kernels_head_dim_256(cuda_device, dtype, tol, window, H, KV):
    """The Gemma families' decode shapes: head_dim 256 at G = 16
    (recurrentgemma's local layers) and 4 (gemma3), bf16 or fp32 pools and
    int8 codes."""
    q, kp, vp, pt, pos = [t.to(cuda_device) for t in paged_case(
        H + window + 256, H=H, KV=KV, hd=256)]
    qd, kd, vd = (t.to(dtype) for t in (q, kp, vp))
    got = ops.paged_attention(qd, kd, vd, pt, pos, window=window)
    want = paged_attention_plain(qd, kd, vd, pt, pos, window=window)
    codes = quantize_pools(kp, vp, "int8")
    got_q = ops.paged_attention_quant(qd, codes[0], codes[1], codes[2],
                                      codes[3], pt, pos, window=window)
    want_q = paged_attention_quant_plain(qd, codes[0], codes[1], codes[2],
                                         codes[3], pt, pos, window=window)
    torch.cuda.synchronize()
    for a, b in ((got, want), (got_q, want_q)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, err


@pytest.mark.cuda
def test_flash_kernel_refuses_gradients_and_rowless_windows(cuda_device):
    """Called directly the forward wrapper refuses inputs that require a
    gradient (``ops.flash_attention`` sends them through the autograd
    Function instead, tested below)."""
    q, k, v = flash_case(0, B=1, Sq=16, Sk=16, H=2, KV=1, hd=16,
                         dtype=torch.float32, device=cuda_device)
    before = flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_cuda(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_cuda(q, k, v.requires_grad_())
    # a query row with no live key (Sq >= Sk + window)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k[:, :4], v.detach()[:, :4], window=8)
    assert flash_attention_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       # P and dS rounded to bf16
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 5, 300, 300), (True, 100, 300, 300),
    (True, 0, 70, 130), (False, 33, 90, 90), (True, 0, 511, 511),
    (True, 0, 512, 512), (True, 8, 511, 511), (True, 0, 300, 200),
    (False, 0, 150, 333)])
@pytest.mark.parametrize("H,KV,hd", [(14, 2, 128), (4, 4, 40), (4, 2, 16),
                                     (64, 1, 8),      # G = 7, 1, 2, 64
                                     (12, 2, 128), (28, 4, 128),
                                     (12, 2, 64)])    # the training heads
def test_flash_backward_kernel_matches_plain(cuda_device, dtype, tol, causal,
                                             window, Sq, Sk, H, KV, hd):
    """dq, dk, dv against the plain backward, each to ``tol`` of its scale;
    two calls bitwise equal (no atomics).  bf16 at head_dim 64 and 128 takes
    the TMA/wgmma backward from the forward kernel's log-sum-exp (the out
    it returned with it); the rest the kernels that rebuild it.  S 511 and
    512 are the training shapes (511 ragged against the 64-query items and
    the 128-key tiles); window 8 is shorter than every tile; Sq 300 > Sk
    200 causal, and Sq 150 < Sk 333 without the mask."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        uses_hopper_bwd_kernel)
    q, k, v = flash_case(H + hd + window + Sk, B=2, Sq=Sq, Sk=Sk, H=H,
                         KV=KV, hd=hd, dtype=dtype, device=cuda_device)
    kw = dict(causal=causal, window=window)
    hopper = uses_hopper_bwd_kernel(dtype, hd)
    assert hopper == (dtype == torch.bfloat16 and hd in (64, 128))
    if hopper:
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        kw_cuda = dict(kw, lse=lse)
    else:
        out, kw_cuda = flash_attention_plain(q, k, v, **kw), kw
    dout = torch.randn(q.shape, device=cuda_device).to(dtype)
    before = flash_attention_bwd_cuda.launches
    got = flash_attention_bwd_cuda(q, k, v, out, dout, **kw_cuda)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, **kw_cuda)
    want = flash_attention_bwd_plain(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


# the cross-attention and encoder families' non-causal shapes: (B, Sq, Sk,
# H, KV, hd) of llama-3.2-vision-11b's cross layers (Sk 6404: 100 full
# 64-key tiles and a tail of 4), seamless-m4t-medium's encoder and its
# cross layers
CROSS_SHAPES = {"llama-cross": (4, 512, 6404, 32, 8, 128),
                "seamless-enc": (4, 1024, 1024, 16, 16, 64),
                "seamless-cross": (4, 512, 1024, 16, 16, 64)}
# their limit, elementwise: four bf16 ulps of the value at most (each side
# rounds its own fp32 result to bf16, and the plain forward rounds P first)
# plus a floor for values near zero: a share of the forward's standard
# deviation, or of the largest gradient (the backward rounds P and dS,
# terms of that size, to bf16 before they cancel).  chip_smoke.py's same
# checks used 0.490-0.655 of it in the forward and 0.178-0.467 in the
# backward on an H100 80GB HBM3 (700 W), N(0, 1) inputs and the tail case
# alike
CROSS_RTOL, CROSS_STD, CROSS_BWD_MAX = 2 ** -5, 2e-2, 5e-3


def cross_tail_case(seed, *, B, Sq, Sk, H, KV, hd, device, tail=4):
    """``flash_case`` in bf16 with every query's softmax decided by the
    last ``tail`` keys: q's first lane 8 and each key's first lane set so
    that the tail scores about 1, every other key about 10, below a key of
    zeros (a tile's zero-filled padding).  Dropping the tail, or letting
    the padding into the softmax, moves the output by about its size."""
    q, k, v = flash_case(seed, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd,
                         dtype=torch.bfloat16, device=device)
    lane = hd ** 0.5 / 8.0              # score = 8 * lane * k0 / sqrt(hd)
    q[..., 0] = 8.0
    k[:, :Sk - tail, :, 0] = -10.0 * lane
    k[:, Sk - tail:, :, 0] = -1.0 * lane
    return q, k, v


def cross_limit_used(got, want, *, bwd=False):
    """The largest share of the cross checks' limit that ``got`` uses
    (above 1 fails): ``CROSS_RTOL`` of each value plus ``CROSS_STD`` of
    ``want``'s standard deviation, or for gradients (``bwd``)
    ``CROSS_BWD_MAX`` of their largest."""
    g, w = got.float(), want.float()
    floor = CROSS_BWD_MAX * w.abs().max() if bwd else CROSS_STD * w.std()
    return ((g - w).abs() / (CROSS_RTOL * w.abs() + floor)).max().item()


@pytest.mark.parametrize("fault", ["tail dropped", "padding let in"])
def test_cross_tail_case_fails_a_faulty_tail(fault):
    """Runs on the CPU: the tail case at llama-vision's Sk 6404 (4 keys
    past the last full 64-key tile) moves the plain output past the cross
    checks' limit by far when the 4 tail keys are dropped or when the
    last tile's 60 zero keys join the softmax, so a kernel with either
    fault fails ``test_flash_cross_shapes_match_plain`` and the smoke's
    check."""
    q, k, v = cross_tail_case(5, B=1, Sq=64, Sk=6404, H=8, KV=2, hd=128,
                              device="cpu")
    want = flash_attention_plain(q, k, v, causal=False)
    if fault == "tail dropped":
        k2, v2 = k[:, :-4], v[:, :-4]
    else:
        pad = torch.zeros((1, 60, 2, 128), dtype=torch.bfloat16)
        k2, v2 = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    assert cross_limit_used(flash_attention_plain(q, k2, v2, causal=False),
                            want) > 10
    assert cross_limit_used(flash_attention_plain(q.float(), k.float(),
                                                  v.float(), causal=False),
                            want) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["random", "tail"])
@pytest.mark.parametrize("shape", list(CROSS_SHAPES))
def test_flash_cross_shapes_match_plain(cuda_device, shape, inputs):
    """bf16 through the TMA/wgmma kernel with ``causal=False`` at Sq !=
    Sk, as ``ops.flash_attention`` routes a cross or encoder layer, on
    N(0, 1) inputs and on the tail case; the backward at the two seamless
    shapes (its training shapes) against the plain backward; each within
    the cross checks' limit."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    B, Sq, Sk, H, KV, hd = CROSS_SHAPES[shape]
    make = flash_case if inputs == "random" else cross_tail_case
    kw = dict(dtype=torch.bfloat16) if inputs == "random" else {}
    q, k, v = make(Sq + Sk + hd, B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, hd=hd,
                   device=cuda_device, **kw)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert cross_limit_used(got, want) <= 1
    if shape == "llama-cross":
        return
    out, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    dout = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    grads = flash_attention_bwd_cuda(q, k, v, out, dout, causal=False,
                                     lse=lse)
    for g, w in zip(grads, flash_attention_bwd_plain(q, k, v, out, dout,
                                                     causal=False)):
        assert cross_limit_used(g, w, bwd=True) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("H,KV", [(28, 4), (12, 2), (4, 4)])  # G = 7, 6, 1
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 511, 511), (True, 8, 300, 300), (False, 0, 150, 333)])
def test_flash_forward_lse_matches_plain(cuda_device, hd, H, KV, causal,
                                         window, Sq, Sk):
    """The TMA/wgmma forward asked for its log-sum-exp: the output bitwise
    the same as without it, the base-2 log-sum-exp within 1e-3 (absolute,
    in the natural unit) of the plain one over scores of a few units."""
    from repro_torch.kernels.flash_attention import LOG2E
    q, k, v = flash_case(H + hd + window + Sq, B=2, Sq=Sq, Sk=Sk, H=H,
                         KV=KV, hd=hd, dtype=torch.bfloat16,
                         device=cuda_device)
    kw = dict(causal=causal, window=window)
    before = flash_attention_cuda.launches
    plain_out = flash_attention_cuda(q, k, v, **kw)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2
    assert torch.equal(out, plain_out)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    assert (lse / LOG2E - want).abs().max().item() <= 1e-3
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention_cuda(q.float(), k.float(), v.float(),
                             return_lse=True)


@pytest.mark.cuda
def test_flash_autograd_function_runs_both_kernels(cuda_device):
    """``ops.flash_attention`` on inputs that require a gradient: the
    forward kernel, then the backward kernel, never a plain version."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    q, k, v = (t.requires_grad_() for t in flash_case(
        3, B=2, Sq=100, Sk=100, H=12, KV=2, hd=128, dtype=torch.bfloat16,
        device=cuda_device))
    before = (flash_attention_cuda.launches,
              flash_attention_bwd_cuda.launches)
    out = ops.flash_attention(q, k, v, window=9)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     out.detach(), dout, window=9)
    for g, w in zip(grads, want):
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [
    10 ** 9,       # a run of one item a block: the most partials
    33, 1])        # fewer, longer runs
@pytest.mark.parametrize("H,KV,S,window", [(28, 4, 512, 0), (12, 2, 511, 8),
                                           (12, 2, 300, 0)])
def test_flash_backward_plans_match_plain(cuda_device, monkeypatch, sms, H,
                                         KV, S, window):
    """The TMA/wgmma backward under the dK/dV plans for other SM counts
    (``_sm_count`` replaced): the partials of other runs summed by the
    second pass, each within 2e-2 of the gradient's scale of the plain
    backward, two calls bitwise equal."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "_sm_count", lambda device: sms)
    q, k, v = flash_case(H + S + window, B=2, Sq=S, Sk=S, H=H, KV=KV,
                         hd=128, dtype=torch.bfloat16, device=cuda_device)
    out, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    dout = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, window=window,
                                      lse=lse)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, dout, window=window,
                                        lse=lse)
    want = fa.flash_attention_bwd_plain(q, k, v, out, dout, window=window)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
def test_flash_backward_runs_on_a_new_thread(cuda_device):
    """The TMA/wgmma backward launched first from a thread that has made
    no CUDA call (as autograd's device threads may be): its tensor maps
    must not be refused, and it gives the main thread's gradients."""
    import threading
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v = flash_case(5, B=2, Sq=100, Sk=100, H=12, KV=2, hd=128,
                         dtype=torch.bfloat16, device=cuda_device)
    out, lse = flash_attention_cuda(q, k, v, window=9, return_lse=True)
    dout = torch.randn_like(out)
    got = []

    def run():
        got.append(flash_attention_bwd_cuda(q, k, v, out, dout, window=9,
                                            lse=lse))
        torch.cuda.synchronize()
    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    want = flash_attention_bwd_cuda(q, k, v, out, dout, window=9, lse=lse)
    torch.cuda.synchronize()
    assert len(got) == 1
    assert all(torch.equal(g, w) for g, w in zip(got[0], want))


@pytest.mark.cuda
def test_toy_trainer_step_on_card_matches_cpu(cuda_device):
    """One fp32 train step of the toy target on the card (flash forward and
    backward kernels in every layer) against the same step on the CPU:
    loss to 1e-4, parameters to 1e-4 of their scale plus 5% of the step's
    learning rate (Adam's m / sqrt(v) of a near-zero gradient)."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticReasoningTask
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.train import Trainer
    cfg = serve.toy_triple()[1]
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    params = random_params(cfg, 3, "cpu")
    batch = SyntheticReasoningTask(seed=2).lm_batch(16, 64)
    before = flash_attention_bwd_cuda.launches
    card = Trainer(cfg, tcfg, params=params, device=cuda_device)
    cpu = Trainer(cfg, tcfg, params=params, device="cpu")
    lc, lp = (float(tr.step(batch)["loss"]) for tr in (card, cpu))
    assert flash_attention_bwd_cuda.launches == before + cfg.num_layers
    assert abs(lc - lp) <= 1e-4 * max(abs(lp), 1.0)
    slack = 0.05 * float(cpu.opt.lr_fn(1))
    for name, p in cpu.params.items():
        got = card.params[name].detach().cpu()
        scale = max(p.detach().abs().max().item(), 1.0)
        assert (got - p.detach()).abs().max().item() <= 1e-4 * scale + slack


@pytest.mark.cuda
def test_model_score_runs_flash_per_layer_and_one_gather(cuda_device):
    from repro_torch.launch import serve
    from repro_torch.models import Model, random_params
    cfg = serve.toy_triple(vocab=64)[1]           # head_dim 40, 4 layers
    params = random_params(cfg, 0, "cpu")
    cpu = Model(cfg, params)
    card = Model(cfg, params, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 64, (3, 90)))
    before = (flash_attention_cuda.launches, logprob_gather_cuda.launches)
    got = card.score(toks.to(cuda_device))
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before[0] + cfg.num_layers
    assert logprob_gather_cuda.launches == before[1] + 1
    want = cpu.score(toks)
    err = (got.cpu() - want).abs().max().item()
    # fp32 both sides; cuBLAS and the CPU sum in other orders
    assert err <= 1e-4 * max(want.abs().max().item(), 1.0), err


FAST_DECAY = float(np.exp(-np.exp(4.0)))    # the clamp's ends in _decay
SLOW_DECAY = float(np.exp(-np.exp(-8.0)))


def scan_case(seed, *, B, T, H, hd, dtype, device, decays="spread"):
    """r, k, v N(0, 1) in ``dtype``; decays spread in (0.45, 0.999), at
    one of the model's clamp ends (``fast`` about 1.8e-24, ``slow`` about
    0.99966) or ``mixed`` element by element between them; u N(0, 0.3^2);
    a non-zero initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, hd)).astype(
        np.float32)).to(device, dtype) for _ in range(3))
    shape = (B, T, H, hd)
    w = {"spread": lambda: 0.45 + 0.549 * rng.uniform(size=shape),
         "fast": lambda: np.full(shape, FAST_DECAY),
         "slow": lambda: np.full(shape, SLOW_DECAY),
         "mixed": lambda: np.where(rng.uniform(size=shape) < 0.5, FAST_DECAY,
                                   SLOW_DECAY)}[decays]()
    w = torch.from_numpy(w.astype(np.float32)).to(device)
    u = torch.from_numpy((0.3 * rng.standard_normal((H, hd))).astype(
        np.float32)).to(device)
    s0 = torch.from_numpy((0.1 * rng.standard_normal((B, H, hd, hd)))
                          .astype(np.float32)).to(device)
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 17, 1000])
@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv6_scan_kernel_matches_plain(cuda_device, dtype, T, hd):
    """Both sides compute in fp32 from the same inputs and differ in
    summation order: 1e-4 of each output's largest magnitude."""
    args = scan_case(T + hd, B=2, T=T, H=3, hd=hd, dtype=dtype,
                     device=cuda_device)
    before = rwkv6_scan_cuda.launches
    out, sT = ops.rwkv6_scan(*args)
    want_out, want_s = rwkv6_scan_plain(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    assert out.dtype == sT.dtype == torch.float32
    assert out.shape == (2, T, 3, hd) and sT.shape == (2, 3, hd, hd)
    assert sT.data_ptr() != args[5].data_ptr()       # a fresh buffer
    for got, want in ((out, want_out), (sT, want_s)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(want.abs().max().item(), 1.0), err


def assert_scan_close(got, want):
    """Both sides compute in fp32 from the same inputs and differ in
    summation order: 1e-4 of each output's largest magnitude."""
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().max().item() if w.numel() else 0.0
        scale = w.abs().max().item() if w.numel() else 0.0
        assert err <= 1e-4 * max(scale, 1.0), err


@pytest.mark.cuda
@pytest.mark.parametrize("decays", ["fast", "slow", "mixed"])
@pytest.mark.parametrize("B,T,H", [(16, 1, 40), (16, 17, 40), (4, 1024, 40)])
def test_rwkv6_scan_kernel_clamp_end_decays(cuda_device, decays, B, T, H):
    """rwkv6-3b's three call shapes (bf16 r/k/v, hd 64) at the decays'
    clamp ends: the split's decay products underflow to zero at the fast
    end, and at the slow end the state carries across every segment."""
    args = scan_case(B + T, B=B, T=T, H=H, hd=64, dtype=torch.bfloat16,
                     device=cuda_device, decays=decays)
    got = ops.rwkv6_scan(*args)
    assert_scan_close(got, rwkv6_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_long_single_head(cuda_device, dtype):
    """B = H = 1, T = 4096: the plan's most segments (32 of 128 steps)."""
    args = scan_case(4096, B=1, T=4096, H=1, hd=64, dtype=dtype,
                     device=cuda_device, decays="mixed")
    assert scan_plan(1, 4096, 1, 64) == (32, 128)
    assert_scan_close(ops.rwkv6_scan(*args), rwkv6_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(40, 1), (7, 6), (2, 39), (1, 40)])
@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv6_scan_kernel_forced_plans(cuda_device, monkeypatch, plan,
                                        hd):
    """T = 40 under other plans (forced in place of ``scan_plan``'s):
    one-step segments, a short last segment, one segment."""
    args = scan_case(40 + hd, B=2, T=40, H=3, hd=hd, dtype=torch.float32,
                     device=cuda_device, decays="mixed")
    monkeypatch.setattr(rwkv6_scan, "scan_plan", lambda *shape: plan)
    got = rwkv6_scan_cuda(*args)
    assert_scan_close(got, rwkv6_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("T,plan", [(1, None), (17, None), (0, None),
                                    (300, None), (300, (1, 300))])
def test_rwkv6_scan_kernel_in_place_freezes_rows(cuda_device, monkeypatch,
                                                 T, plan):
    """The decode form: half the rows frozen keep their state bit for bit,
    the live rows get the out-of-place kernel's state (bitwise), and
    ``out`` is computed for every row.  ``plan``, when given, is forced in
    place of ``scan_plan``'s."""
    r, k, v, w, u, s0 = scan_case(T + 7, B=16, T=T, H=4, hd=64,
                                  dtype=torch.bfloat16, device=cuda_device)
    live = torch.arange(16, device=cuda_device) % 2 == 0
    if plan is not None:
        monkeypatch.setattr(rwkv6_scan, "scan_plan", lambda *shape: plan)
    want_out, want_s = rwkv6_scan_cuda(r, k, v, w, u, s0)
    state = s0.clone()
    before = rwkv6_scan_cuda.launches
    if plan is None:
        out = ops.rwkv6_scan_(r, k, v, w, u, state, live)
    else:
        out = rwkv6_scan_cuda_(r, k, v, w, u, state, live)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    assert torch.equal(out, want_out)
    assert torch.equal(state[~live], s0[~live])
    assert torch.equal(state[live], want_s[live])
    plain_out, plain_s = rwkv6_scan_plain(r, k, v, w, u, s0)
    assert_scan_close((out, state), (plain_out, torch.where(
        live[:, None, None, None], plain_s, s0)))
    state2 = s0.clone()
    rwkv6_scan_cuda_(r, k, v, w, u, state2, None)
    assert torch.equal(state2, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(16, 1), (16, 17), (4, 1024)])
def test_rwkv6_scan_kernel_is_deterministic(cuda_device, B, T):
    """Fixed orders and no atomics: two calls on one input are bitwise
    equal, the split ones (T = 1024) included."""
    args = scan_case(T, B=B, T=T, H=40, hd=64, dtype=torch.bfloat16,
                     device=cuda_device)
    first = rwkv6_scan_cuda(*args)
    for _ in range(2):
        again = rwkv6_scan_cuda(*args)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.cuda
def test_rwkv6_scan_kernel_on_two_streams(cuda_device):
    """Each stream keeps its own segment scratch: split calls in flight on
    two streams at once, over different inputs, each match the plain
    version."""
    sets = [scan_case(50 + i, B=2, T=600, H=4, hd=64, dtype=torch.bfloat16,
                      device=cuda_device) for i in range(2)]
    assert scan_plan(2, 600, 4, 64)[0] > 1
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for stream, args in zip(streams, sets):
            with torch.cuda.stream(stream):
                outs.append(rwkv6_scan_cuda(*args))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert_scan_close(got, rwkv6_scan_plain(*sets[i % 2]))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1024])
def test_rwkv6_scan_kernel_captures_in_a_cuda_graph(cuda_device, T):
    """The wrapper (the plan, the scratch, both launches; the in-place
    form too) records into a torch.cuda.graph: no host sync, nothing
    allocated outside the graph's pool.  A replay over new inputs copied
    into the captured tensors equals the eager call."""
    B = 16 if T == 1 else 4
    args = scan_case(T, B=B, T=T, H=40, hd=64, dtype=torch.bfloat16,
                     device=cuda_device)
    live = torch.arange(B, device=cuda_device) % 3 != 0
    state = args[5].clone()
    rwkv6_scan_cuda(*args)                  # build and load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, final = rwkv6_scan_cuda(*args)
        out_ = ops.rwkv6_scan_(*args[:5], state, live)
    fresh = scan_case(T + 1, B=B, T=T, H=40, hd=64, dtype=torch.bfloat16,
                      device=cuda_device)
    for dst, src in zip(args, fresh):
        dst.copy_(src)
    state.copy_(fresh[5])
    graph.replay()
    want_out, want_final = rwkv6_scan_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(final, want_final)
    assert torch.equal(out_, want_out)
    assert torch.equal(state, torch.where(live[:, None, None, None],
                                          want_final, fresh[5]))


@pytest.mark.cuda
def test_rwkv6_scan_kernel_refuses_other_head_dims_and_gradients(
        cuda_device):
    before = rwkv6_scan_cuda.launches
    args = scan_case(0, B=1, T=4, H=2, hd=16, dtype=torch.float32,
                     device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.rwkv6_scan(*args)
    r, k, v, w, u, s0 = scan_case(1, B=1, T=4, H=2, hd=32,
                                  dtype=torch.float32, device=cuda_device)
    # called directly the kernel takes no input that requires a gradient
    # (ops.rwkv6_scan sends those through the WKV6Scan Function)
    with pytest.raises(RuntimeError, match="forward-only"):
        rwkv6_scan_cuda(r.requires_grad_(), k, v, w, u, s0)
    with pytest.raises(RuntimeError, match="forward-only"):
        rwkv6_scan_cuda(r.detach(), k, v, w, u, s0.requires_grad_())
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r.detach(), k, v, w.double(), u, s0.detach())
    assert rwkv6_scan_cuda.launches == before


def scan_cotangents(seed, r, device):
    """N(0, 1) cotangents on a scan's output (B,T,H,hd) and final state."""
    rng = np.random.default_rng(seed)
    B, T, H, hd = r.shape
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device) for shape in ((B, T, H, hd), (B, H, hd, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("decays", ["spread", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 5, 300])
@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv6_scan_bwd_kernel_matches_plain(cuda_device, hd, T, dtype,
                                             decays, with_dstate):
    """The WKV6 backward kernel against rwkv6_scan_bwd_plain: dw, du and
    dstate fp32 on both sides (summation orders differ: 1e-4 of scale);
    dr, dk and dv in r's dtype, which in bf16 rounds them (half an ulp,
    2^-9 of the value: 4e-3 of scale).  Two calls bitwise equal; T 1 and
    5 are shorter than a 16-step checkpoint segment (5 ragged against its
    4-step sub-chunks), 300 ragged against the segments."""
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_cuda,
                                                rwkv6_scan_bwd_plain)
    args = scan_case(hd + T, B=3, T=T, H=5, hd=hd, dtype=dtype,
                     device=cuda_device, decays=decays)
    dout, dstate = scan_cotangents(T, args[0], cuda_device)
    ds = dstate if with_dstate else None
    before = rwkv6_scan_bwd_cuda.launches
    got = rwkv6_scan_bwd_cuda(*args, dout, ds)
    again = rwkv6_scan_bwd_cuda(*args, dout, ds)
    want = rwkv6_scan_bwd_plain(*args, dout, ds)
    torch.cuda.synchronize()
    assert rwkv6_scan_bwd_cuda.launches == before + 2
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        tol = 4e-3 if i < 3 and dtype == torch.bfloat16 else 1e-4
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_rwkv6_scan_bwd_kernel_long_slow_decays(cuda_device):
    """B = H = 1 at T 4096 with decays near 1 (the clamp's slow end), so
    the state carries across all 256 checkpoint segments: against
    rwkv6_scan_bwd_plain at the same tolerances, twice bitwise."""
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_bwd_cuda,
                                                rwkv6_scan_bwd_plain)
    args = scan_case(41, B=1, T=4096, H=1, hd=64, dtype=torch.bfloat16,
                     device=cuda_device, decays="slow")
    dout, dstate = scan_cotangents(42, args[0], cuda_device)
    got = rwkv6_scan_bwd_cuda(*args, dout, dstate)
    again = rwkv6_scan_bwd_cuda(*args, dout, dstate)
    want = rwkv6_scan_bwd_plain(*args, dout, dstate)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a)
        tol = 4e-3 if i < 3 else 1e-4
        scale = max(w.float().abs().max().item(), 1.0)
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_bwd_kernels_refuse_mis_sized_scratch(cuda_device, monkeypatch):
    """The backward kernels' C entries check the sizes the wrappers give
    them: a checkpoint scratch sized for another interval than the scan
    kernel's, or a dK/dV plan for another key tile than the hd-256
    kernel's, is refused before any launch, and the wrapper raises."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    args = scan_case(43, B=1, T=40, H=2, hd=64, dtype=torch.bfloat16,
                     device=cuda_device, decays="spread")
    dout, _ = scan_cotangents(44, args[0], cuda_device)
    monkeypatch.setattr(rs, "bwd_scratch_bytes", lambda B, T, H, hd:
                        (-(-T // 8) - 1) * B * H * hd * hd * 4)
    before = rs.rwkv6_scan_bwd_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        rs.rwkv6_scan_bwd_cuda(*args, dout)
    assert rs.rwkv6_scan_bwd_cuda.launches == before
    q, k, v = flash_case(45, B=1, Sq=300, Sk=300, H=4, KV=1, hd=256,
                         dtype=torch.bfloat16, device=cuda_device)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    monkeypatch.setattr(fa, "bwd_keys", lambda head_dim: 128)
    before = fa.flash_attention_bwd_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_bwd_cuda(q, k, v, out, out, lse=lse)
    assert fa.flash_attention_bwd_cuda.launches == before


@pytest.mark.cuda
def test_rwkv6_scan_function_on_card(cuda_device):
    """ops.rwkv6_scan on CUDA inputs that require a gradient: one forward
    and one backward kernel launch, gradients bitwise the backward
    kernel's, and the output the forward kernel's."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    args = scan_case(5, B=2, T=600, H=4, hd=64, dtype=torch.bfloat16,
                     device=cuda_device, decays="mixed")
    dout, dstate = scan_cotangents(6, args[0], cuda_device)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (rwkv6_scan_cuda.launches, rwkv6_scan_bwd_cuda.launches)
    out, final = ops.rwkv6_scan(*leaves)
    grads = torch.autograd.grad((out, final), leaves, (dout, dstate))
    torch.cuda.synchronize()
    assert (rwkv6_scan_cuda.launches, rwkv6_scan_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_final = rwkv6_scan_cuda(*args)
    want = rwkv6_scan_bwd_cuda(*args, dout, dstate)
    assert torch.equal(out, want_out) and torch.equal(final, want_final)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def carry_params(params, seed):
    """Every RWKV ``decay_base`` overwritten with a seeded U[-6, -0.5] and
    every RG-LRU ``lam`` with U[-9, -4], in place, so the states carry."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in params.items():
        if name.endswith(".tm.decay_base"):
            t.copy_(torch.empty(t.shape).uniform_(-6.0, -0.5, generator=gen))
        if name.endswith(".rec.lam"):
            t.copy_(torch.empty(t.shape).uniform_(-9.0, -4.0, generator=gen))
    return params


def reduced_family(name):
    """A reduced fp32 config of ``name``; gemma3-1b keeps head_dim 256 and
    gets windows of 8 that a 64-token batch crosses."""
    from repro_torch.config import get_config, reduced_config
    cfg = reduced_config(get_config(name))
    if name == "gemma3-1b":
        cfg = dataclasses.replace(
            cfg, num_layers=3, layer_pattern=("local", "local", "full"),
            window_size=8, d_model=64, num_heads=4, num_kv_heads=1,
            head_dim=256, d_ff=96)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6-3b", "gemma3-1b"])
def test_family_trainer_step_on_card_matches_cpu(cuda_device, name):
    """A reduced rwkv6-3b (the scan's forward and backward kernels in
    every layer) and a reduced gemma3-1b at head_dim 256 (flash's) in
    fp32 on the card against the CPU from the same weights: ``lm_loss``
    and every gradient to 1e-4 of its scale (summation orders differ),
    then one Trainer step: the loss to 1e-4, parameters to 1e-4 of their
    scale plus 5% of the step's rate (Adam's first step moves the weight
    of a near-zero gradient by up to the rate whatever its rounding, so
    the rate is kept small by a 20-step warmup, as run t3 keeps it)."""
    from repro_torch.config import TrainConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    from repro_torch.models import Model, random_params
    from repro_torch.train import Trainer, lm_loss
    cfg = reduced_family(name)
    params = carry_params(random_params(cfg, 3, "cpu"), 4)
    batch = next(lm_batches(cfg.vocab_size, 4, 64, seed=2))
    kernel = rwkv6_scan_bwd_cuda if name == "rwkv6-3b" \
        else flash_attention_bwd_cuda
    before = kernel.launches
    got = []
    for dev in (cuda_device, "cpu"):
        model = Model(cfg, params, device=dev, trainable=True)
        tb = {"tokens": torch.from_numpy(batch["tokens"]).long().to(dev),
              "loss_mask": torch.from_numpy(batch["loss_mask"]).to(dev)}
        loss, _ = lm_loss(model, tb)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        got.append((float(loss), {k: g for k, g in zip(named, grads)}))
    assert kernel.launches == before + cfg.num_layers
    (lc, gc), (lp, gp) = got
    assert abs(lc - lp) <= 1e-4 * max(abs(lp), 1.0)
    for key, g in gp.items():
        if g is None:
            assert gc[key] is None, key
            continue
        scale = max(g.abs().max().item(), 1.0)
        assert (gc[key].cpu() - g).abs().max().item() <= 1e-4 * scale, key
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20, total_steps=40)
    card = Trainer(cfg, tcfg, params=params, device=cuda_device)
    cpu = Trainer(cfg, tcfg, params=params, device="cpu")
    lc, lp = (float(tr.step(batch)["loss"]) for tr in (card, cpu))
    assert kernel.launches == before + 2 * cfg.num_layers
    assert abs(lc - lp) <= 1e-4 * max(abs(lp), 1.0)
    slack = 0.05 * float(cpu.opt.lr_fn(1))
    for key, p in cpu.params.items():
        got_p = card.params[key].detach().cpu()
        scale = max(p.detach().abs().max().item(), 1.0)
        assert (got_p - p.detach()).abs().max().item() <= 1e-4 * scale \
            + slack, key


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel", [("rwkv6-3b", "rwkv6_scan_bwd"),
                                         ("gemma3-1b", "flash_attention_bwd")])
def test_train_cli_on_card(cuda_device, capsys, arch, kernel):
    """``python -m repro_torch.launch.train --arch ARCH --reduced --steps
    2`` on the card (its default device): two logged steps, the family's
    backward kernel launched once per layer (attention layer) and step."""
    from repro_torch.config import get_config, reduced_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    from repro_torch.launch import train
    fn = {"rwkv6_scan_bwd": rwkv6_scan_bwd_cuda,
          "flash_attention_bwd": flash_attention_bwd_cuda}[kernel]
    before = fn.launches
    train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "64"])
    out = capsys.readouterr().out
    assert "step     0" in out and "step     1" in out
    assert fn.launches == before + 2 * reduced_config(
        get_config(arch)).num_layers


@pytest.mark.cuda
def test_rwkv_model_runs_the_scan_per_layer(cuda_device):
    from repro_torch.config import get_config, reduced_config
    from repro_torch.models import Model, random_params
    cfg = dataclasses.replace(reduced_config(get_config("rwkv6-3b"),
                                             vocab=64), num_layers=3)  # hd 32
    params = random_params(cfg, 0, "cpu")
    # base decays in about (0.54, 0.9975), so the WKV state carries (the
    # seeded init's lie below 1.2e-4)
    gen = torch.Generator().manual_seed(1)
    for name, t in params.items():
        if name.endswith(".tm.decay_base"):
            t.copy_(torch.empty(t.shape).uniform_(-6.0, -0.5, generator=gen))
    cpu = Model(cfg, params)
    card = Model(cfg, params, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 64, (3, 40)))
    before = rwkv6_scan_cuda.launches
    got = card.score(toks.to(cuda_device))
    cache = card.init_cache(3, 0)
    step = card.decode_step(cache, toks[:, :1].to(cuda_device),
                            torch.zeros(3, dtype=torch.long,
                                        device=cuda_device))
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 2 * cfg.num_layers
    want = cpu.score(toks)
    want_step = cpu.decode_step(cpu.init_cache(3, 0), toks[:, :1],
                                torch.zeros(3, dtype=torch.long))
    for g, w in ((got, want), (step, want_step)):
        w = w[..., :cfg.vocab_size]
        err = (g[..., :cfg.vocab_size].cpu() - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1.0), err


def toy_engine(device, **kw):
    """The toy fp32 triple with seeded random weights, paged, on ``device``
    (sampling at temperature 0.7)."""
    from repro_torch.config import GSIConfig
    from repro_torch.launch import serve
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  min_step_reward=-1.0)
    return serve.build_engine(serve.toy_triple(vocab=64), g, seed=0,
                              device=device, max_seq=96, paged=True,
                              page_size=8, **kw)


@pytest.mark.cuda
def test_async_equals_sync_on_the_card(cuda_device):
    """The pipelined scheduler commits the lock-step one's tokens on the
    card at temperature > 0, with the prefix cache."""
    from repro_torch.serving import GSIScheduler
    pre = [5 + i % 24 for i in range(17)]
    prompts = [np.asarray(pre + [33 + i, 34, 4], np.int32) for i in range(5)]
    runs = []
    for sync in (True, False):
        sched = GSIScheduler(toy_engine(cuda_device), capacity=2, sync=sync)
        ids = [sched.submit(p, max_steps=1 + i % 3)
               for i, p in enumerate(prompts)]
        out = sched.run(torch.Generator(device=cuda_device).manual_seed(4))
        runs.append(({r: (out[r].tokens.tolist(), out[r].finish_reason)
                      for r in ids}, sched.engine_steps,
                     sched.prefix_stats(), sched.stats.accepted,
                     sched.stats.decisions))
        if not sync:
            assert sched.pipeline_stats()["overlap_host_s"] > 0
    assert runs[1] == runs[0]
    assert runs[0][2]["hits"] > 0


@pytest.mark.cuda
def test_step_result_outlives_the_next_step(cuda_device):
    """A StepResult's arrays lie in host memory of its own ticket: step
    k+1, dispatched and materialized after step k, leaves them as they
    were (a reused pinned buffer would show step k+1's positions)."""
    eng = toy_engine(cuda_device)
    prompts = np.asarray([[5, 6, 7, 8], [9, 10, 4, 0]], np.int32)
    state = eng.admit(eng.fresh_state(2), np.ones(2, bool), prompts)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, ticket = eng.dispatch_decode(state, gen)
    res = eng.materialize(ticket)
    kept = [None if a is None else np.array(a, copy=True) for a in res]
    assert ticket.host[0].is_pinned() and ticket.host[1].is_pinned()
    state, ticket2 = eng.dispatch_decode(state, gen)
    res2 = eng.materialize(ticket2)
    assert not np.array_equal(res2.pos, res.pos)
    for a, b in zip(res, kept):
        assert np.array_equal(a, b) if b is not None else a is None
    np.testing.assert_array_equal(res.chosen, ticket.chosen.cpu().numpy())
    np.testing.assert_array_equal(res.pos, ticket.pos.cpu().numpy())


@pytest.mark.cuda
def test_materialize_copies_each_buffer_to_the_host_once(cuda_device,
                                                         monkeypatch):
    """One device-to-host copy per packed buffer a step: the int64 one and
    the float32 one (rewards, tilted rewards and log-ratios in gsi mode)."""
    from repro_torch.serving import gsi_engine
    eng = toy_engine(cuda_device)
    copies = []
    real = gsi_engine._to_host

    def counted(buf):
        copies.append((buf.device.type, buf.dtype))
        return real(buf)

    monkeypatch.setattr(gsi_engine, "_to_host", counted)
    prompts = np.asarray([[5, 6, 7, 8], [9, 10, 4, 0]], np.int32)
    state = eng.admit(eng.fresh_state(2), np.ones(2, bool), prompts)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for step in range(1, 3):
        state, res = eng.step_decode(state, gen)
        assert copies == [("cuda", torch.int64),
                          ("cuda", torch.float32)] * step
    assert res.rewards.shape == res.tilted.shape == (2, 2)


def toy_pair(g, **kw):
    """The toy fp32 triple on the CPU and on the card over the same seeded
    weights (made on the CPU, copied to the card), paged."""
    from repro_torch.launch import serve
    from repro_torch.models import random_params
    from repro_torch.serving import GSIServingEngine
    cfgs = serve.toy_triple(vocab=64)
    params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    return [GSIServingEngine(*cfgs, *params, g, device=dev, max_seq=96,
                             paged=True, page_size=8, **kw)
            for dev in ("cpu", "cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("sync", [True, False])
def test_chunked_prefill_and_preemption_on_the_card_match_the_cpu(
        cuda_device, sync):
    """Chunked admission (``extend``), a priority preemption and its
    resume through the prefix cache commit the CPU port's tokens on the
    card at temperature 0, with the same counters, every paged call on the
    card launching the kernel."""
    from repro_torch.config import GSIConfig
    from repro_torch.serving import GSIScheduler
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, eos_token_id=-1, min_step_reward=-1e9)
    pre = [5 + i % 24 for i in range(17)]
    low = np.asarray(pre + [33, 34, 4], np.int32)
    high = np.asarray([30 + i % 20 for i in range(17)] + [43, 44, 4],
                      np.int32)
    runs = []
    for eng in toy_pair(g):
        sched = GSIScheduler(eng, capacity=1, sync=sync, chunk_tokens=8)
        gen = torch.Generator(device=eng.device).manual_seed(0)
        before = paged_attention_cuda.launches
        sched.submit(low, request_id="lo", max_steps=3)
        for _ in range(4):                # three chunks, then one decode
            sched.step(gen)
        sched.submit(high, request_id="hi", max_steps=2, priority=1)
        out = sched.run(gen)
        st = sched.stats
        runs.append(({r: (out[r].tokens.tolist(), out[r].finish_reason,
                          out[r].preemptions) for r in out},
                     sched.engine_steps, sched.prefix_stats(),
                     st.preemptions, st.resumes, st.prefill_commit_max))
        if eng.device.type == "cuda":
            assert paged_attention_cuda.launches > before
    assert runs[1] == runs[0]
    assert runs[0][3] == runs[0][4] == 1
    assert runs[0][5] <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_snapshot_round_trip_on_the_card_is_bitwise(cuda_device, tmp_path,
                                                    kv_dtype):
    """save_cache -> .npz -> load_cache into a fresh engine on the card:
    every restored page row (bf16 bits; int8 codes and scales) is bitwise
    the saved one, the page ledger holds, and the warm rerun commits the
    cold run's tokens with every admission a hit."""
    from repro_torch.config import GSIConfig
    from repro_torch.serving import GSIScheduler
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=2, beta=4.0,
                  temperature=0.0)
    pre = [5 + i % 24 for i in range(17)]
    prompts = [np.asarray(pre + [33 + i, 34, 4], np.int32) for i in range(2)]
    engines = [toy_pair(g, kv_dtype=kv_dtype)[1] for _ in range(2)]
    cold = GSIScheduler(engines[0], capacity=1)
    ids = [cold.submit(p) for p in prompts]
    out = cold.run(torch.Generator(device="cuda").manual_seed(0))
    path = tmp_path / "cache.npz"
    snap = engines[0].save_cache(cold.state, path)
    assert snap["pages"].size >= 2
    warm = GSIScheduler(engines[1], capacity=1)
    warm.state = engines[1].load_cache(warm.state, str(path))
    pool = engines[1].pager
    assert pool.num_free + pool.num_referenced + pool.num_cached \
        == pool.num_pages
    if kv_dtype == "int8":
        assert pool.scale_slots == set(pool.refcount) | pool.cached
    # the same trie, so the records come in the same preorder (page ids
    # are remapped); row i of every pool is record i's page
    again = engines[1].save_cache(warm.state)
    for key in ("chunks", "parents"):
        np.testing.assert_array_equal(snap[key], again[key])
    assert snap["leaves"].keys() == again["leaves"].keys()
    for key, rows in snap["leaves"].items():
        assert rows.dtype == again["leaves"][key].dtype
        np.testing.assert_array_equal(rows, again["leaves"][key])
    ids2 = [warm.submit(p) for p in prompts]
    out2 = warm.run(torch.Generator(device="cuda").manual_seed(0))
    assert [out2[r].tokens.tolist() for r in ids2] == \
        [out[r].tokens.tolist() for r in ids]
    assert warm.prefix_stats()["hits"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_threaded_fleet_on_the_card_matches_the_cpu(cuda_device, kv_dtype):
    """Two replicas on the card, each driven by a thread of its own under a
    stream of its own (pipelined schedulers), commit the CPU's sequential
    fleet's tokens at temperature 0 with the same per-replica hits; every
    paged call on the card launched the kernel, counted exactly across
    the threads; int8 pages with shared scoring reach the gather's TMA
    kernel from the fleet's fresh threads."""
    from repro_torch.config import GSIConfig
    from repro_torch.kernels.logprob_gather import logprob_gather_cuda
    from repro_torch.serving import ReplicaRouter
    g = GSIConfig(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
                  temperature=0.0, eos_token_id=-1, min_step_reward=-1e9)
    kw = {} if kv_dtype is None else dict(kv_dtype="int8",
                                          shared_scoring=True)
    pres = [[5 + i % 24 for i in range(17)], [30 + i % 20 for i in range(17)]]
    prompts = [np.asarray(pres[i // 3] + [33 + i, 34, 4], np.int32)
               for i in range(6)]
    pairs = [toy_pair(g, **kw) for _ in range(2)]
    calls = []
    for eng in (pair[1] for pair in pairs):
        for model in (eng.draft, eng.target, eng.prm):
            def counted(*a, _orig=model.decode_step,
                        _layers=len(model.layers), **k):
                if k.get("pt") is not None:
                    calls.append(_layers)
                return _orig(*a, **k)
            model.decode_step = counted
    runs = []
    for dev, threaded in ((0, False), (1, True)):
        router = ReplicaRouter([pair[dev] for pair in pairs], capacity=1,
                               skew=None, threaded=threaded,
                               sync=not threaded)
        paged = (paged_attention_quant_cuda if kv_dtype
                 else paged_attention_cuda)
        before = (paged.launches, logprob_gather_cuda.launches)
        ids = [router.submit(p, max_steps=1 + i % 3)
               for i, p in enumerate(prompts)]
        out = router.run(3)
        runs.append(({r: out[r].tokens.tolist() for r in ids},
                     [p["hits"] for p in router.prefix_stats()
                      ["per_replica"]]))
        if threaded:
            streams = [rep.stream.cuda_stream for rep in router.replicas]
            assert len(set(streams)) == 2 and 0 not in streams
            assert paged.launches - before[0] == sum(calls) > 0
            assert (logprob_gather_cuda.launches > before[1]) \
                == (kv_dtype is not None)
    assert runs[1] == runs[0]
    assert sum(runs[0][1]) == len(prompts) - len(pres)
