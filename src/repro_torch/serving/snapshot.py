"""Snapshot and restore of the radix prefix cache (warm restarts).

A port of ``repro.serving.snapshot``.  A warm radix cache lets a restarted
server answer its first requests from spliced KV pages instead of a cold
prefill.  This module serializes the evictable part of a paged engine's
prefix cache (the reference-free ``cached`` pages, their token chunks and
LRU clocks, and for quantized pools their per-page scale rows) and restores
it into another live state without disturbing any page the allocator has
handed out.

Two layers:

* **Records** (:func:`index_records` / :func:`restore_records`): host
  bookkeeping over a :class:`~repro_torch.serving.pages.PagePool` and its
  :class:`~repro_torch.serving.radix.RadixIndex`.  A record is one trie
  node, ``(chunk, clock, page, parent)``, ``parent`` an index into the
  record list (-1: a child of the root).  A restore remaps page ids
  through the destination pool's free list, so it can never resurrect a
  page a live slot references, and admits records hottest first, so the
  coldest subtrees are the ones dropped when free pages run short.
* **Payload** (:func:`snapshot_state` / :func:`restore_state`): the
  recorded pages' rows of every paged pool (``kp``/``vp`` and, quantized,
  the ``ks``/``vs`` scale rows), gathered on the device and copied to the
  host, then written back at the remapped page ids.  Rows round-trip bit
  for bit; conservation (``free + referenced + cached == num_pages``,
  ``scale_slots == referenced | cached``) holds after every restore.

The snapshot dict has the reference's keys (``page_size``, ``kv_dtype``,
``chunks``, ``clocks``, ``parents``, ``pages``, ``leaves``).  A payload
leaf is named ``{model}.{layer}.{pool}`` (``S.3.kp``: the draft's fourth
layer's K pool) and holds the recorded pages' rows along axis 0.  numpy
has no bf16 or fp8 type, so those pools travel as their raw bits (int16,
uint8) and are read back as the destination pool's type.

:func:`save_snapshot` / :func:`load_snapshot` put a snapshot on disk as one
``.npz``, with numpy alone (``launch/serve.py --cache-dir``);
``GSIServingEngine.save_cache`` / ``load_cache`` are the engine's entry
points.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.engine import _PAGED_KEYS
from repro_torch.serving.pages import PagePool
from repro_torch.serving.radix import RadixNode

# one record = one trie node: (chunk, clock, page, parent record index)
Record = Tuple[Tuple[int, ...], int, int, int]

# pool dtypes numpy lacks: stored as their raw bits
_RAW_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def _paged_leaves(caches):
    """``(name, pool)`` of every paged pool leaf of a state's caches."""
    for model, layers in caches.items():
        for i, layer in enumerate(layers):
            for key, leaf in layer.items():
                if key in _PAGED_KEYS:
                    yield f"{model}.{i}.{key}", leaf


def index_records(pool: PagePool,
                  roots: Optional[Sequence[Sequence[int]]] = None
                  ) -> List[Record]:
    """The snapshot records of ``pool``'s radix index.

    A preorder walk (parents precede their children) of the cached
    closure: descent stops at the first page not in ``pool.cached``, since
    pages with live readers stay with their slots and a subtree under one
    could not be restored along an unbroken path.  ``roots`` restricts the
    walk to the given first-chunk keys.
    """
    index = pool.index
    if index is None:
        return []
    want = None if roots is None else \
        {tuple(int(t) for t in r) for r in roots}
    out: List[Record] = []
    stack: List[Tuple[RadixNode, int]] = []
    for key in sorted(index.root.children, reverse=True):
        if want is not None and key not in want:
            continue
        stack.append((index.root.children[key], -1))
    while stack:
        node, parent = stack.pop()
        if node.page not in pool.cached:
            continue                      # referenced: stays with its slot
        rec_idx = len(out)
        out.append((node.key, int(node.clock), int(node.page), parent))
        for key in sorted(node.children, reverse=True):
            stack.append((node.children[key], rec_idx))
    return out


def restore_records(pool: PagePool,
                    records: Sequence[Record]) -> Dict[int, int]:
    """Rebuild snapshot records inside ``pool``'s radix index.

    Returns ``{old_page: new_page}`` for every node created: the pages
    whose rows the caller must copy.  New nodes take their pages from
    ``pool.free`` only, and never one that backs an outstanding admission
    claim.  Records are admitted by descending snapshot clock (parents
    first at equal clocks, a topological order since a parent's clock is
    at least its children's), so the coldest subtrees are dropped when
    pages run out.  A chunk already present at its path keeps its node and
    page (no copy), and the snapshot's children attach beneath it.
    Restored clocks are rebased past the destination's clock, keeping
    their relative order, and ancestors are bumped so that no parent is
    staler than a restored child.
    """
    index = pool.index
    if index is None or not records:
        return {}
    order = sorted(range(len(records)), key=lambda i: (-records[i][1], i))
    min_clock = min(r[1] for r in records)
    base = index.clock + 1
    node_of: Dict[int, RadixNode] = {}
    remap: Dict[int, int] = {}
    max_clock = index.clock
    for i in order:
        key, clock, old_page, parent = records[i]
        if parent == -1:
            pnode = index.root
        else:
            pnode = node_of.get(parent)
            if pnode is None:             # parent dropped: branch is dead
                continue
        new_clock = base + (clock - min_clock)
        existing = pnode.children.get(key)
        if existing is not None:
            existing.clock = max(existing.clock, new_clock)
            node_of[i] = existing
            max_clock = max(max_clock, existing.clock)
            continue
        if len(pool.free) <= pool.num_claimed:
            # the free pages left back admission claims: taking one would
            # let a live slot's ensure() pop an empty free list
            continue
        page = pool.free.pop()
        node = RadixNode(key, page, pnode, new_clock)
        pnode.children[key] = node
        index.nodes[page] = node
        pool.retained.add(page)
        pool.cached.add(page)
        if pool.quantized:
            pool.scale_slots.add(page)    # restored with the page
        node_of[i] = node
        remap[old_page] = page
        max_clock = max(max_clock, new_clock)
        anc = pnode                       # parent at least as recent
        while anc is not index.root and anc.clock < new_clock:
            anc.clock = new_clock
            anc = anc.parent
    index.clock = max(index.clock, max_clock)
    return remap


def _bits(pool: torch.Tensor) -> torch.Tensor:
    """``pool`` itself, or a view of its raw bits where numpy lacks its
    type (indexing and copies then move bits, never values)."""
    raw = _RAW_BITS.get(pool.dtype)
    return pool if raw is None else pool.view(raw)


def _host_rows(pool: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    return _bits(pool).index_select(0, ids).cpu().numpy()


def _device_rows(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if src.dtype != like.dtype or src.shape[1:] != like.shape[1:]:
        raise ValueError(f"snapshot rows {src.dtype} {tuple(src.shape)} do "
                         f"not fit a pool of {like.dtype} rows "
                         f"{tuple(like.shape[1:])}")
    return src.to(like.device)


def _live_cache(engine) -> bool:
    return bool(engine.paged and engine.pager is not None
                and engine.prefix_cache)


def snapshot_state(engine, state,
                   roots: Optional[Sequence[Sequence[int]]] = None) -> dict:
    """Snapshot the engine's cached radix subtrees out of ``state``.

    Returns a host-side dict: the records as flat arrays
    (``chunks``/``clocks``/``parents``/``pages``) and, under ``leaves``,
    one array of the recorded pages' rows per paged pool leaf.  ``roots``
    restricts it to the given first chunks; ``None`` takes everything
    cached.  An engine without a live prefix cache gives an empty snapshot
    (restoring it changes nothing).
    """
    snap = {
        "page_size": engine.page_size,
        "kv_dtype": engine.kv_dtype,
        "chunks": np.zeros((0, engine.page_size), np.int32),
        "clocks": np.zeros((0,), np.int64),
        "parents": np.zeros((0,), np.int32),
        "pages": np.zeros((0,), np.int32),
        "leaves": {},
    }
    if not _live_cache(engine):
        return snap
    engine._check_gen(state)
    records = index_records(engine.pager, roots=roots)
    if not records:
        return snap
    snap["chunks"] = np.asarray([r[0] for r in records], np.int32)
    snap["clocks"] = np.asarray([r[1] for r in records], np.int64)
    snap["pages"] = np.asarray([r[2] for r in records], np.int32)
    snap["parents"] = np.asarray([r[3] for r in records], np.int32)
    ids = torch.as_tensor(snap["pages"], dtype=torch.long,
                          device=engine.device)
    snap["leaves"] = {name: _host_rows(leaf, ids)
                      for name, leaf in _paged_leaves(state["caches"])}
    return snap


def restore_state(engine, state, snapshot: dict):
    """Splice a snapshot's cached subtrees into ``state``; returns it.

    Checks the snapshot's ``page_size`` and ``kv_dtype`` against the
    engine, rebuilds the records through the pool's free list
    (:func:`restore_records`) and writes the admitted records' rows into
    every paged pool at their remapped page ids, in place: those pages
    came off the free list, so no slot reads them.
    """
    if not _live_cache(engine):
        return state
    engine._check_gen(state)
    if int(snapshot["page_size"]) != engine.page_size:
        raise ValueError(
            f"snapshot page_size {snapshot['page_size']} != engine "
            f"page_size {engine.page_size}")
    if (snapshot.get("kv_dtype") or None) != (engine.kv_dtype or None):
        raise ValueError(
            f"snapshot kv_dtype {snapshot.get('kv_dtype')!r} != engine "
            f"kv_dtype {engine.kv_dtype!r} (page rows would not round-trip)")
    pages = np.asarray(snapshot["pages"], np.int64)
    records: List[Record] = [
        (tuple(int(t) for t in snapshot["chunks"][i]),
         int(snapshot["clocks"][i]), int(pages[i]),
         int(snapshot["parents"][i]))
        for i in range(pages.size)]
    remap = restore_records(engine.pager, records)
    if not remap:
        return state
    rows = np.asarray([i for i in range(pages.size)
                       if int(pages[i]) in remap])
    new_ids = torch.as_tensor([remap[int(pages[i])] for i in rows],
                              dtype=torch.long, device=engine.device)
    leaves = snapshot["leaves"]
    for name, leaf in _paged_leaves(state["caches"]):
        if name in leaves:
            bits = _bits(leaf)
            bits[new_ids] = _device_rows(np.asarray(leaves[name])[rows],
                                         bits)
    return state


def save_snapshot(snapshot: dict, path) -> None:
    """Write a snapshot dict to ``path`` as one ``.npz`` file."""
    np.savez(
        path,
        __page_size=np.asarray(int(snapshot["page_size"]), np.int64),
        __kv_dtype=np.asarray(snapshot.get("kv_dtype") or ""),
        __chunks=snapshot["chunks"], __clocks=snapshot["clocks"],
        __parents=snapshot["parents"], __pages=snapshot["pages"],
        **{f"leaf.{k}": v for k, v in snapshot["leaves"].items()})


def load_snapshot(path) -> dict:
    """Read a snapshot ``.npz`` written by :func:`save_snapshot`."""
    with np.load(path) as f:
        return {
            "page_size": int(f["__page_size"]),
            "kv_dtype": str(f["__kv_dtype"]) or None,
            "chunks": f["__chunks"], "clocks": f["__clocks"],
            "parents": f["__parents"], "pages": f["__pages"],
            "leaves": {k[len("leaf."):]: f[k] for k in f.files
                       if k.startswith("leaf.")},
        }
