"""The port's CUDA kernels on a card, against their plain versions.

Paged attention (fp32 and bf16 pools, and fp32 queries over bf16 pools),
quantized paged attention (int8 and fp8-e4m3 codes under fp32 and bf16
queries); both also at the split plan's shapes (the engine's 33-column
table with positions up to 527, B = KV = 1, G = 16, windows that leave
splits empty, head_dim 8, 40 and 256, pages of 4, 8 and 32 rows),
bitwise deterministic, on two streams at once, and captured in a CUDA
graph; the fused log-softmax gather (bf16/bf16 and fp32/bf16 through
the TMA/wgmma kernel, fp32 h as three bf16 parts; fp32/fp32; W row-major
and transposed; ragged tokens, depth and vocabulary strips), and
full-sequence flash attention (fp32 and bf16; GQA groups 1, 2, 6, 7 and
64; head_dim 16, 40, 64 and 128, bf16 at 64 and 128 through the TMA/wgmma
kernel; windows shorter and longer than the key tile; ragged Sq and Sk,
Sk > Sq non-causal), which refuses inputs that require a gradient, and
the WKV6 scan
(head dims 32 and 64; T = 1, 17 and 1000; bf16 and fp32 r/k/v; spread
decays and a non-zero initial state; decays at the model's clamp ends and
mixed; B = H = 1 at T = 4096, many segments; forced plans down to
one-step segments; the in-place decode form with half the rows frozen,
their state bitwise unchanged; bitwise deterministic, on two streams at
once, and captured in a CUDA graph), which refuses other head dims and
inputs that require a gradient.  A toy model's ``score`` on the card
launches the flash kernel once per layer and the gather once; a toy RWKV
model's ``score`` and ``decode_step`` launch the scan once per layer.

These tests need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so
elsewhere they skip.  The file imports neither JAX nor ``repro``, so it runs
on a machine that has only the port (``--noconftest``: the shared
``conftest.py`` imports JAX; the ``cuda`` marker is registered in
``pyproject.toml``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Paged serving through the kernel against dense serving on the card is
checked by ``chip_smoke.py`` (its toy agreement phase), not repeated here.
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
def test_flash_kernel_refuses_gradients_and_rowless_windows(cuda_device):
    q, k, v = flash_case(0, B=1, Sq=16, Sk=16, H=2, KV=1, hd=16,
                         dtype=torch.float32, device=cuda_device)
    before = flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, v.requires_grad_())
    # a query row with no live key (Sq >= Sk + window)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k[:, :4], v.detach()[:, :4], window=8)
    assert flash_attention_cuda.launches == before


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
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.rwkv6_scan(r.requires_grad_(), k, v, w, u, s0)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.rwkv6_scan(r.detach(), k, v, w, u, s0.requires_grad_())
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r.detach(), k, v, w.double(), u, s0.detach())
    assert rwkv6_scan_cuda.launches == before


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
