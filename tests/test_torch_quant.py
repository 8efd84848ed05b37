"""The port's quantized paged KV against ``repro``'s, on the CPU.

The same numpy inputs (from a seed) go through the reference and the port:

* ``quantize_codes``: int8 and fp8 codes bit for bit (ties to even, the
  int8 clip, the e4m3 edge at 448 and past it);
* ``paged_attention_quant_plain`` against ``ref.paged_attention_quant_ref``
  and the Pallas kernel in interpret mode (int8 and fp8, GQA groups 1 and
  7, a window, stale rows, a shared page, the trash column; atol 1e-5 in
  fp32), and once against the per-cell oracle at a tiny size;
* ``_write_cache_paged_quant``: codes and scales bit for bit, the trash
  page left out (duplicate writes to it are unordered on both sides);
* ``paged_view`` with dequantization, ``quantize_draft_params`` and
  ``quantized_fraction``, ``cache_memory_report`` at int8;
* the ``PagePool`` scale-slot ledger and its bytes-weighted LRU, and
  copy-on-write branching that carries a partial page's scales.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import GSIConfig
from repro.kernels import quant as jquant
from repro.kernels import ref
from repro.kernels.paged_attention import paged_attention_quant_pallas
from repro.models import build_model
from repro.models.attention import \
    _write_cache_paged_quant as j_write_cache_paged_quant
from repro.serving import GSIServingEngine as JEngine
from repro.serving import paged_view as j_paged_view
from repro.serving import quantize_draft_params as j_quantize_draft_params
from repro.serving import quantized_fraction as j_quantized_fraction
from repro_torch.config import GSIConfig as TGSIConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.kernels import ops, quant
from repro_torch.kernels.paged_attention import (paged_attention_quant_cuda,
                                                 paged_attention_quant_plain)
from repro_torch.models.attention import _write_cache_paged_quant
from repro_torch.models import random_params
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import GSIServingEngine, PagePool, branch_cache
from repro_torch.serving.engine import paged_view
from repro_torch.serving.quant import (quantize_draft_params,
                                       quantized_fraction)
from repro_torch.serving.radix import RadixIndex

torch.set_num_threads(1)
ATOL = 1e-5
F8 = jnp.float8_e4m3fn


def to_torch(a):
    """numpy / jax array -> torch tensor, fp8 codes through their bytes."""
    a = np.asarray(a)
    if a.dtype == F8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def code_bytes(t):
    """A code tensor's raw bytes (int8 or fp8) as a numpy uint8 array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def quant_pages(rng, P, ps, KV, hd, kv_dtype):
    """Random fp pages -> (codes, scales) as the engine writes them."""
    fp = jnp.asarray(rng.standard_normal((P, ps, KV, hd)).astype(np.float32))
    sc = jnp.maximum(jnp.max(jnp.abs(fp), axis=(1, 3)),
                     jquant.EPS) / jquant.QMAX[kv_dtype]
    codes = jquant.quantize_codes(fp / sc[:, None, :, None],
                                  jquant.pool_dtype(kv_dtype, jnp.float32))
    return codes, sc


def quant_case(seed, *, B, H, KV, hd, ps, nblk, kv_dtype):
    """Quantized pools with stale rows everywhere, rows 0 and 1 sharing
    their first page, the trash column last, one row at its first slot."""
    rng = np.random.default_rng(seed)
    P = B * nblk + 2
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp, ks = quant_pages(rng, P, ps, KV, hd, kv_dtype)
    vp, vs = quant_pages(rng, P, ps, KV, hd, kv_dtype)
    pt = rng.permutation(P - 1)[:B * nblk].reshape(B, nblk)
    pt[1, 0] = pt[0, 0]
    pt = np.concatenate([pt, np.full((B, 1), P - 1)], axis=1).astype(np.int32)
    pos = np.linspace(0, nblk * ps - 2, B).astype(np.int32)
    pos[-1] = nblk * ps
    return q, kp, vp, ks, vs, pt, pos


# ----------------------------------------------------------------------
# kernels/quant.py
# ----------------------------------------------------------------------

def test_kv_dtype_helpers_match_reference():
    assert quant.KV_DTYPES == jquant.KV_DTYPES
    assert quant.QUANTIZED == jquant.QUANTIZED
    assert quant.QMAX == jquant.QMAX and quant.EPS == jquant.EPS
    for kd in quant.KV_DTYPES:
        assert quant.validate_kv_dtype(kd) == kd
        assert quant.is_quantized(kd) == jquant.is_quantized(kd)
    with pytest.raises(ValueError):
        quant.validate_kv_dtype("int4")
    assert quant.pool_dtype(None, torch.float32) == torch.float32
    assert quant.pool_dtype("bf16", torch.float32) == torch.bfloat16
    assert quant.pool_dtype("int8", torch.float32) == torch.int8
    assert quant.pool_dtype("fp8", torch.float32) == torch.float8_e4m3fn


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_codes_bit_identical(kv_dtype):
    """Ties round to even, int8 clips at +-127, fp8 keeps 448 and rounds
    the e4m3 boundary cases (up to 464) and beyond (NaN) as the reference."""
    rng = np.random.default_rng(1)
    edge = [0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5, -127.5,
            200.0, -200.0, 1e-9, 0.001953125, 0.0009765625, 0.00146484375,
            1.0625, 1.1875, 17.0, 19.0, 232.0, 240.0, 447.9, 448.0,
            448.00003, 455.9, 456.0, 463.9, 464.0, 464.1, 470.0, 479.9,
            480.0, 1e30, -448.0, -464.0, -464.1, -470.0]
    x = np.concatenate([np.asarray(edge, np.float32),
                        rng.uniform(-470, 470, 4096).astype(np.float32)])
    dt = jquant.pool_dtype(kv_dtype, jnp.float32)
    want = code_bytes(jquant.quantize_codes(jnp.asarray(x), dt))
    got = code_bytes(quant.quantize_codes(
        torch.from_numpy(x), quant.pool_dtype(kv_dtype, torch.float32)))
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# quantized paged attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("H,KV", [(2, 2), (14, 2)])          # G = 1, 7
@pytest.mark.parametrize("window", [0, 8])
def test_quant_plain_matches_reference_oracle_and_pallas(kv_dtype, H, KV,
                                                         window):
    case = quant_case(H + window, B=3, H=H, KV=KV, hd=16, ps=4, nblk=5,
                      kv_dtype=kv_dtype)
    got = paged_attention_quant_plain(*[to_torch(a) for a in case],
                                      window=window).numpy()
    jcase = [jnp.asarray(a) for a in case]
    want = np.asarray(ref.paged_attention_quant_ref(*jcase, window=window))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    kern = np.asarray(paged_attention_quant_pallas(*jcase, window=window,
                                                   interpret=True))
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)


def test_quant_plain_matches_cell_oracle_tiny():
    """The reference's per-cell oracle (slow to trace) at a tiny size."""
    case = quant_case(5, B=2, H=2, KV=1, hd=8, ps=4, nblk=2,
                      kv_dtype="int8")
    got = paged_attention_quant_plain(*[to_torch(a) for a in case]).numpy()
    want = np.asarray(ref.paged_attention_quant_cell_ref(
        *[jnp.asarray(a) for a in case]))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ops_dispatch_cpu_goes_to_quant_plain_version():
    case = [to_torch(a) for a in quant_case(0, B=2, H=4, KV=2, hd=16, ps=4,
                                            nblk=3, kv_dtype="int8")]
    before = paged_attention_quant_cuda.launches
    out = ops.paged_attention_quant(*case, window=5)
    torch.testing.assert_close(
        out, paged_attention_quant_plain(*case, window=5), rtol=0, atol=0)
    assert paged_attention_quant_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_quant_cuda(*case)


# ----------------------------------------------------------------------
# the quantized page write and the dequantizing view
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_write_cache_paged_quant_bit_identical(kv_dtype):
    """Rows land at their positions, pages re-quantize whole; rows 0 and 1
    write one shared page at different rows of later blocks, two rows sit
    in the trash column (duplicate writes: the trash page is left out)."""
    rng = np.random.default_rng(3)
    B, KV, hd, ps, nblk = 5, 2, 16, 4, 3
    P = B * nblk + 1
    kp, ks = quant_pages(rng, P, ps, KV, hd, kv_dtype)
    vp, vs = quant_pages(rng, P, ps, KV, hd, kv_dtype)
    pt = rng.permutation(P - 1).reshape(B, nblk)
    pt = np.concatenate([pt, np.full((B, 1), P - 1)], axis=1).astype(np.int32)
    pos = np.array([0, 6, 9, nblk * ps, nblk * ps + 2], np.int32)
    k = rng.standard_normal((B, 1, KV, hd)).astype(np.float32) * 3
    v = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    want = j_write_cache_paged_quant(
        {"kp": kp, "vp": vp, "ks": ks, "vs": vs}, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pt))
    cache = {"kp": to_torch(kp), "vp": to_torch(vp), "ks": to_torch(ks),
             "vs": to_torch(vs)}
    _write_cache_paged_quant(cache, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos).long(),
                             torch.from_numpy(pt))
    keep = slice(0, P - 1)
    for key in ("kp", "vp"):
        assert not np.array_equal(code_bytes(cache[key])[keep],
                                  code_bytes(kp if key == "kp" else vp)[keep])
        np.testing.assert_array_equal(code_bytes(cache[key])[keep],
                                      code_bytes(want[key])[keep])
    for key in ("ks", "vs"):
        np.testing.assert_array_equal(cache[key].numpy()[keep],
                                      np.asarray(want[key])[keep])


def test_paged_view_dequantizes_like_reference():
    rng = np.random.default_rng(4)
    P, ps, KV, hd = 9, 4, 2, 8
    kp, ks = quant_pages(rng, P, ps, KV, hd, "int8")
    vp, vs = quant_pages(rng, P, ps, KV, hd, "int8")
    fp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pt = np.array([[3, 1, 8], [5, 1, 8]], np.int32)
    want = j_paged_view({"rem": {"r0": {"kp": kp, "vp": vp, "ks": ks,
                                        "vs": vs},
                                 "r1": {"kp": fp, "vp": fp}}},
                        jnp.asarray(pt))["rem"]
    got = paged_view([{"kp": to_torch(kp), "vp": to_torch(vp),
                       "ks": to_torch(ks), "vs": to_torch(vs)},
                      {"kp": to_torch(fp), "vp": to_torch(fp)}],
                     torch.from_numpy(pt))
    for layer, key in zip(got, ("r0", "r1")):
        for kv in ("k", "v"):
            assert layer[kv].dtype == torch.float32
            np.testing.assert_array_equal(layer[kv].numpy(),
                                          np.asarray(want[key][kv]))


# ----------------------------------------------------------------------
# draft weight fake-quant
# ----------------------------------------------------------------------

def test_quantize_draft_params_bit_identical(tiny_dense):
    """Per-layer, per-channel scales: the port's layer-by-layer weights
    against the reference's stacked ones, leaf for leaf."""
    cfg = tiny_dense
    jparams = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
    tcfg = TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    want = params_from_numpy(tcfg, jax.tree.map(
        np.asarray, j_quantize_draft_params(cfg, jparams)))
    got = quantize_draft_params(tcfg, tparams)
    assert set(got) == set(want)
    changed = 0
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
        changed += not torch.equal(got[name], tparams[name])
    assert changed == 2 * 7                 # wq wk wv wo, gate up down
    assert quantized_fraction(tcfg, tparams) == pytest.approx(
        j_quantized_fraction(cfg, jparams), abs=1e-12)


# ----------------------------------------------------------------------
# PagePool: scale slots and the bytes-weighted LRU
# ----------------------------------------------------------------------

def test_page_pool_scale_slots_follow_their_pages():
    """scale_slots == referenced | cached through claim, splice, publish,
    release and eviction; an unquantized pool keeps none."""
    pool = PagePool(8, page_size=2, index=RadixIndex(2), kv_dtype="int8")
    assert pool.quantized

    def invariant():
        assert pool.scale_slots == set(pool.refcount) | pool.cached
        assert pool.num_free + pool.num_referenced + pool.num_cached == 8

    pool.claim(0, 3)
    pages = [p for _, p in pool.ensure(0, 3)]
    invariant()
    pool.publish([1, 2, 3, 4, 5, 6], pages)
    shared, hit = pool.match([1, 2, 3, 4, 9])
    assert hit == 4
    pool.claim(1, 2, shared=shared)
    pool.ensure(1, 4)
    invariant()
    pool.release(0)
    invariant()
    pool.release(1)
    invariant()
    assert pool.num_cached == 3
    pool.claim(2, 7)                        # evicts cached pages
    invariant()
    pool.release(2)
    pool.evict(8)
    invariant()
    assert not pool.scale_slots and pool.num_free == 8
    plain = PagePool(4, page_size=2, kv_dtype="bf16")
    plain.claim(0, 2)
    plain.ensure(0, 2)
    assert not plain.quantized and not plain.scale_slots
    with pytest.raises(ValueError):
        PagePool(4, page_size=2, kv_dtype="int4")


def _two_cached_pages(page_bytes=0):
    """Two cached pages, A strictly staler than B."""
    ps = 4
    pool = PagePool(4, ps, index=RadixIndex(ps), page_bytes=page_bytes,
                    kv_dtype="int8")
    pages = []
    for slot, tok in ((0, 1), (1, 2)):
        pool.claim(slot, 1)
        pool.ensure(slot, 1)
        pages.append(pool.assigned[slot][0])
        pool.publish([tok] * ps, pages[-1:])
    pool.release(0)
    pool.release(1)
    assert pool.cached == set(pages)
    return (pool, *pages)


@pytest.mark.parametrize("costs,victim", [
    (None, 0),                # uniform cost: plain LRU, the staler goes
    ((50, 400), 1),           # stale but cheap survives an 8x dearer page
    ((400, 50), 0)])
def test_bytes_weighted_lru(costs, victim):
    pool, pa, pb = _two_cached_pages(page_bytes=512)
    if costs:
        pool.page_cost_override.update({pa: costs[0], pb: costs[1]})
    pool.evict(1)
    gone = (pa, pb)[victim]
    assert gone not in pool.cached and (pa, pb)[1 - victim] in pool.cached
    assert gone not in pool.scale_slots
    assert pool.scale_slots == set(pool.refcount) | pool.cached
    assert pool.page_cost(pa) == (costs[0] if costs else 512)


# ----------------------------------------------------------------------
# engine: COW branching with scales, memory report
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_engines(tiny_triple):
    """A reference and a port engine over int8 pools.  Only the port's
    steps run, so the reference gets zero weights of the right shapes."""
    cfgs = tiny_triple
    params = [jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           jax.eval_shape(build_model(c).init,
                                          jax.random.PRNGKey(0)))
              for c in cfgs]
    tcfgs = [TModelConfig(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(c)}) for c in cfgs]
    tparams = [random_params(tc, i, "cpu") for i, tc in enumerate(tcfgs)]
    g = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
             min_step_reward=-1.0)
    kw = dict(max_seq=48, paged=True, page_size=8, kv_dtype="int8")
    je = JEngine(*cfgs, *params, GSIConfig(**g), **kw)
    te = GSIServingEngine(*tcfgs, *tparams, TGSIConfig(**g), device="cpu",
                          **kw)
    return je, te


def test_branch_cache_copies_scales_with_partial_page(int8_engines):
    """Each branch's first scratch page receives the branch-point page's
    codes AND scales, or the copied codes would dequantize with the scratch
    page's stale scale."""
    _, eng = int8_engines
    prompts = np.array([[5, 6, 7, 8, 9, 3, 2, 4, 11, 12, 13, 4]], np.int32)
    state = eng.admit(eng.fresh_state(1), np.ones(1, bool), prompts)
    assert int(state["pos"][0]) == 11                  # page 1 is partial
    cache = state["caches"]["S"]
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    scr = state["scratch"][:, :2]
    branched = branch_cache(cache, 2, state["pt"], state["pos"], scr,
                            eng.page_size)
    src = int(state["pt"][0, 11 // 8])
    for layer, old in zip(branched, before):
        assert set(layer) == {"kp", "vp", "ks", "vs"}
        for key, leaf in layer.items():
            for j in range(2):
                dst = int(scr[0, j, 0])
                assert torch.equal(leaf[dst], old[key][src])
            assert torch.equal(leaf[src], old[key][src])


def test_cache_memory_report_int8_matches_reference(int8_engines):
    je, te = int8_engines
    for batch in (2, 3):
        je.fresh_state(batch)
        te.fresh_state(batch)
        jrep, trep = je.cache_memory_report(batch), \
            te.cache_memory_report(batch)
        assert trep == jrep
        assert trep["scale_bytes_per_page"] > 0
        assert trep["fp_bytes_per_page"] == 4 * trep["bytes_per_page"]
    assert te.pager.page_bytes == je.pager.page_bytes


def test_kv_dtype_needs_paged_and_the_cli_serves_quantized(capsys):
    from repro_torch.launch import serve
    cfgs = tuple(dataclasses.replace(c, num_layers=1)
                 for c in serve.toy_triple())
    params = [random_params(c, i, "cpu") for i, c in enumerate(cfgs)]
    for kw in ({"kv_dtype": "int8"}, {"kv_dtype": "int3", "paged": True}):
        with pytest.raises(ValueError):
            GSIServingEngine(*cfgs, *params, TGSIConfig(), device="cpu", **kw)
    serve.main(["--config", "toy", "--device", "cpu", "--layers", "1",
                "--paged", "--kv-dtype", "fp8", "--quantize-draft",
                "--requests", "2", "--capacity", "2", "--n", "2",
                "--max-step-tokens", "3", "--max-steps", "1"])
    out = capsys.readouterr().out
    assert "kv=fp8 draft=int8" in out and "finished=2/2" in out
