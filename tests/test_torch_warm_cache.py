"""The port's warm prefix cache on the CPU: snapshot, save/load, restore.

Twins of the reference's ``tests/test_warm_cache.py`` snapshot cases, run
on the port with the plain kernels:

* snapshot -> ``.npz`` -> restore into a fresh engine round-trips every
  page row bit for bit (bf16 pools as raw bits, int8 codes and their
  scale rows), keeps the page ledger and ``scale_slots`` in lockstep, and
  the warm rerun commits the cold run's tokens with every admission a hit;
* a restore into a busy engine takes free, unclaimed pages only: live
  assignments, refcounts and claims are untouched and the live request
  finishes;
* the port's snapshot of a greedy run equals the reference's snapshot of
  the same run, over the same weights (numpy bridge): chunks, clocks,
  parents and page ids exactly, page rows and scales within fp32
  tolerance;
* ``serve --cache-dir`` restores its snapshot on a second start, whose
  admissions then all hit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import GSIConfig as JGSIConfig
from repro.config import ModelConfig as JModelConfig
from repro.models import build_model
from repro.serving import GSIScheduler as JScheduler
from repro.serving import GSIServingEngine as JEngine
from repro_torch.config import GSIConfig, ModelConfig
from repro_torch.launch import serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model import layer_slots
from repro_torch.serving import GSIScheduler, GSIServingEngine, load_snapshot

torch.set_num_threads(1)
# two full pages (ps 8) of shared preamble + distinct tails
PRE = np.asarray([5 + (i % 24) for i in range(17)], np.int32)
GCFG = dict(n=2, max_step_tokens=5, max_steps=3, beta=4.0,
            min_step_reward=-1.0)
GREEDY = dict(GCFG, temperature=0.0)
# the port against the reference: the same fp32 math in another summation
# order, a few layers deep
RTOL = ATOL = 1e-5


def _prompt(tail, pre=PRE):
    return np.concatenate([pre, np.asarray(tail, np.int32)])


@pytest.fixture(scope="module")
def triple():
    """A full-attention fp32 triple (the reference's ``full_triple``), its
    reference weights and the same weights bridged to the port."""
    base = JModelConfig(
        name="t-wc-full-0", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64, head_dim=16,
        dtype="float32", param_dtype="float32")
    target = dataclasses.replace(base, name=base.name + "-t", num_layers=3)
    prm = dataclasses.replace(target, name=base.name + "-p",
                              reward_head=True)
    jcfgs = (base, target, prm)
    cfgs = [ModelConfig(**{f.name: getattr(c, f.name)
                           for f in dataclasses.fields(c)}) for c in jcfgs]
    params = [build_model(c).init(jax.random.PRNGKey(i))
              for i, c in enumerate(jcfgs)]
    tparams = [params_from_numpy(c, jax.tree.map(np.asarray, p))
               for c, p in zip(cfgs, params)]
    return jcfgs, params, cfgs, tparams


def _engine(triple, g=GCFG, **kw):
    _, _, cfgs, tparams = triple
    return GSIServingEngine(*cfgs, *tparams, GSIConfig(**g), max_seq=96,
                            paged=True, page_size=8, device="cpu", **kw)


def _sched_run(engine, prompts, *, capacity=2, seed=7, max_steps=None):
    sched = GSIScheduler(engine, capacity=capacity)
    ids = [sched.submit(p, max_steps=max_steps) for p in prompts]
    out = sched.run(torch.Generator().manual_seed(seed))
    return {r: out[r].tokens.tolist() for r in ids}, sched


def _check_ledger(pool):
    """Page conservation and the scale-slot lockstep."""
    free, referenced, cached = set(pool.free), set(pool.refcount), \
        set(pool.cached)
    assert len(free) == len(pool.free)
    assert free | referenced | cached == set(range(pool.num_pages))
    assert not free & referenced and not free & cached
    assert not referenced & cached
    assert pool.num_free >= pool.num_claimed
    assert cached == pool.retained - referenced
    if pool.index is not None:
        assert set(pool.index.nodes) == pool.retained
    if pool.quantized:
        assert pool.scale_slots == referenced | cached
    else:
        assert not pool.scale_slots


def _record_paths(snap):
    """The root-to-node token path (a tuple of chunks) of every record."""
    chunks = [tuple(int(t) for t in c) for c in snap["chunks"]]
    parents = np.asarray(snap["parents"], np.int64)
    paths = []
    for i in range(len(chunks)):
        path, j = [], i
        while j != -1:
            path.append(chunks[j])
            j = int(parents[j])
        paths.append(tuple(reversed(path)))
    return paths


def _canon(snap):
    """A snapshot as {token path: {leaf: row}}, independent of page ids."""
    return {path: {k: np.asarray(a)[i] for k, a in snap["leaves"].items()}
            for i, path in enumerate(_record_paths(snap))}


# ----------------------------------------------------------------------
# Snapshot / restore round trip
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_snapshot_restore_roundtrip(triple, tmp_path, kv_dtype):
    """Disk round trip into a fresh engine: bit-identical rows (bf16 raw
    bits; int8 codes and scales), the ledger intact, and the warm rerun
    commits the cold run's tokens with every admission a hit."""
    eng = _engine(triple, kv_dtype=kv_dtype)
    prompts = [_prompt([33, 34, 4]), _prompt([35, 36, 4])]
    # capacity 1 serializes admission: the second request hits the
    # preamble pages the first published (cold hit rate 1/2)
    cold, sched = _sched_run(eng, prompts, capacity=1, seed=3)
    st_cold = sched.prefix_stats()
    assert st_cold["hits"] == 1
    path = tmp_path / "cache.npz"
    snap = eng.save_cache(sched.state, path)
    assert snap["pages"].size >= 2
    kinds = {k.split(".")[-1] for k in snap["leaves"]}
    assert kinds == ({"kp", "vp", "ks", "vs"} if kv_dtype == "int8"
                     else {"kp", "vp"})
    want = {None: np.float32, "bf16": np.int16, "int8": np.int8}[kv_dtype]
    assert all(snap["leaves"][k].dtype == want for k in snap["leaves"]
               if k.endswith(("kp", "vp")))
    loaded = load_snapshot(path)
    assert loaded["page_size"] == 8
    assert (loaded["kv_dtype"] or None) == kv_dtype

    eng2 = _engine(triple, kv_dtype=kv_dtype)
    sched2 = GSIScheduler(eng2, capacity=1)
    sched2.state = eng2.load_cache(sched2.state, str(path))
    _check_ledger(eng2.pager)
    assert eng2.pager.num_cached == snap["pages"].size
    a, b = _canon(snap), _canon(eng2.save_cache(sched2.state))
    assert a.keys() == b.keys()
    for p in a:
        assert a[p].keys() == b[p].keys()
        for key in a[p]:
            assert a[p][key].dtype == b[p][key].dtype
            np.testing.assert_array_equal(a[p][key], b[p][key])
    ids = [sched2.submit(p) for p in prompts]
    out = sched2.run(torch.Generator().manual_seed(3))
    assert [out[r].tokens.tolist() for r in ids] == list(cold.values())
    st_warm = sched2.prefix_stats()
    assert st_warm["hits"] == 2
    assert st_warm["hit_rate"] >= st_cold["hit_rate"]
    _check_ledger(eng2.pager)
    # a snapshot of another page format is refused
    other = _engine(triple, kv_dtype="int8" if kv_dtype != "int8" else None)
    with pytest.raises(ValueError, match="kv_dtype"):
        other.load_cache(other.fresh_state(1), snap)


def test_restore_into_busy_engine_never_resurrects_pages(triple, tmp_path):
    """A restore while slots hold pages and admission holds claims draws
    only unclaimed free pages: live assignments, refcounts and claims are
    untouched, and the live request finishes on the spliced state."""
    donor = _engine(triple)
    pre_a = np.asarray([21 + (i % 10) for i in range(17)], np.int32)
    _, dsched = _sched_run(donor, [_prompt([33, 34, 4], pre_a),
                                   _prompt([35, 36, 4], pre_a)],
                           capacity=1, seed=3)
    path = tmp_path / "donor.npz"
    donor.save_cache(dsched.state, path)

    eng = _engine(triple)
    sched = GSIScheduler(eng, capacity=2)
    b = sched.submit(_prompt([41, 42, 4]), max_steps=3)
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):                    # the request is now mid-decode
        sched.step(gen)
    pool = eng.pager
    assert pool.num_referenced > 0
    ref_before = dict(pool.refcount)
    assigned_before = {s: list(p) for s, p in pool.assigned.items()}
    claimed_before = dict(pool.claimed)
    cached_before = set(pool.cached)
    sched.state = eng.load_cache(sched.state, str(path))
    _check_ledger(pool)
    assert dict(pool.refcount) == ref_before
    assert {s: list(p) for s, p in pool.assigned.items()} == assigned_before
    assert dict(pool.claimed) == claimed_before
    restored = pool.cached - cached_before
    assert restored and not restored & set(ref_before)
    while b not in sched.responses:
        sched.step(gen)
    _check_ledger(pool)


# ----------------------------------------------------------------------
# The port's snapshot against the reference's
# ----------------------------------------------------------------------

def _reference_rows(jcfgs, tcfgs, jsnap):
    """The reference snapshot's leaves renamed to the port's
    ``{model}.{layer}.{pool}`` keys (a scanned block's stacked leaf split
    by its repetition index)."""
    out = {}
    for model, cfg in zip("SBP", tcfgs):
        for i, (_, group, key, index) in enumerate(layer_slots(cfg)):
            for leaf in ("kp", "vp", "ks", "vs"):
                name = f"{model}.{group}.{key}.{leaf}"
                if name in jsnap["leaves"]:
                    arr = np.asarray(jsnap["leaves"][name])
                    out[f"{model}.{i}.{leaf}"] = \
                        arr if index is None else arr[index]
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_snapshot_matches_reference(triple, kv_dtype):
    """The same greedy run on the port and on the reference: the records
    (chunks, LRU clocks, parents, page ids) are equal, and every page row
    and scale agrees within fp32 tolerance (int8 codes within one code
    step, where the fp32 difference crosses a rounding boundary)."""
    jcfgs, params, tcfgs, _ = triple
    prompts = [_prompt([33, 34, 4]), _prompt([35, 36, 4]),
               _prompt([37, 4], np.asarray([30 + i % 20 for i in range(17)],
                                           np.int32))]
    kw = dict(max_seq=96, paged=True, page_size=8, kv_dtype=kv_dtype)
    je = JEngine(*jcfgs, *params, JGSIConfig(**GREEDY), **kw)
    js = JScheduler(je, capacity=1)
    for p in prompts:
        js.submit(p, max_steps=2)
    js.run(jax.random.PRNGKey(0))
    jsnap = je.save_cache(js.state)
    _, ts = _sched_run(_engine(triple, GREEDY, kv_dtype=kv_dtype),
                                  prompts, capacity=1, max_steps=2)
    tsnap = ts.engine.save_cache(ts.state)
    assert tsnap["pages"].size >= 4
    for key in ("page_size", "kv_dtype"):
        assert (tsnap[key] or None) == (jsnap[key] or None)
    for key in ("chunks", "clocks", "parents", "pages"):
        np.testing.assert_array_equal(tsnap[key], np.asarray(jsnap[key]))
    want = _reference_rows(jcfgs, tcfgs, jsnap)
    assert want.keys() == tsnap["leaves"].keys()
    for name, got in tsnap["leaves"].items():
        ref = want[name]
        assert got.shape == ref.shape, name
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - ref.astype(np.int32)) \
                .max() <= 1, name
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


# ----------------------------------------------------------------------
# serve --cache-dir
# ----------------------------------------------------------------------

def test_serve_cache_dir_restores_on_second_start(tmp_path, capsys):
    """The CLI saves the radix cache after serving and restores it on its
    next start, whose admissions then splice the restored pages."""
    argv = ["--config", "toy", "--device", "cpu", "--layers", "1",
            "--paged", "--requests", "2", "--capacity", "2", "--n", "2",
            "--max-steps", "1", "--max-step-tokens", "4", "--sync",
            "--cache-dir", str(tmp_path)]
    serve.main(argv)
    first = capsys.readouterr().out
    assert "restored 0 snapshot(s), saved 1" in first
    assert (tmp_path / "cache-r0.npz").exists()
    serve.main(argv)
    second = capsys.readouterr().out
    assert "restored 1 snapshot(s), saved 1" in second
    assert "'hits': 2" in second and "'hit_rate': 1.0" in second
