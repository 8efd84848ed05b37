"""Radix (token-trie) index over full, committed KV-cache pages.

One node is one *full* page: a ``page_size`` chunk of some prompt's token
prefix, so the path from the root spells the token prefix and the pages
along it are exactly the KV pages a new request with that prefix can splice
into its block table.  Token chunks are compared exactly (they are dict
keys), so a "hash hit" can never alias two different prefixes.

``clock`` is a logical LRU timestamp: every match and insert touches the
whole path it walks, so a parent is always at least as recent as its
children and the LRU minimum sits leaf-ward — eviction (PagePool.evict)
drops whole subtrees, which keeps the trie free of unreachable pages.

This module is deliberately dependency-free host-side bookkeeping; the
refcounted page ledger that owns it lives in ``repro_torch.serving.pages``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple


class RadixNode:
    """One full committed page: a page-size chunk of the token prefix."""

    __slots__ = ("key", "page", "parent", "children", "clock")

    def __init__(self, key, page, parent, clock):
        """Node for token chunk ``key`` holding page id ``page``."""
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.clock = clock


class RadixIndex:
    """Token-trie over full committed pages (one node == one page)."""

    def __init__(self, page_size: int):
        """Empty trie over ``page_size``-token chunks."""
        self.page_size = page_size
        self.root = RadixNode(None, None, None, 0)
        self.nodes: Dict[int, RadixNode] = {}
        self.clock = 0

    def _tick(self) -> int:
        self.clock += 1
        return self.clock

    def __len__(self) -> int:
        """Number of pages (== nodes) the trie currently retains."""
        return len(self.nodes)

    def _chunks(self, tokens):
        ps = self.page_size
        for j in range(len(tokens) // ps):
            lo = j * ps
            hi = lo + ps
            yield tuple(int(t) for t in tokens[lo:hi])

    def match(self, tokens) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(pages, matched_tokens)`` with ``matched_tokens`` equal to
        ``len(pages) * page_size``; touches the matched path (LRU).
        """
        node = self.root
        pages: List[int] = []
        t = self._tick()
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.clock = t
            node = child
            pages.append(node.page)
        return pages, len(pages) * self.page_size

    def insert(self, tokens, pages: Sequence[int]) -> List[int]:
        """Register ``pages`` (one per full page-size chunk of ``tokens``).

        Walks/extends the trie; chunks already present keep their existing
        page (the caller's duplicate page stays plain slot-owned and is
        freed on release).  Returns the page ids newly retained here.
        """
        node = self.root
        new: List[int] = []
        t = self._tick()
        for key, page in zip(self._chunks(tokens), pages):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, int(page), node, t)
                node.children[key] = child
                self.nodes[int(page)] = child
                new.append(int(page))
            child.clock = t
            node = child
        return new

    def lru_page(self, among: Set[int], cost=None) -> Optional[int]:
        """The page in ``among`` whose node is least recently used.

        ``cost`` (page -> positive int, typically the page's bytes)
        weights the eviction priority: the victim minimizes
        ``clock / cost``, so between equally-stale pages the *expensive*
        one goes first, and a cheap page (a cached int8 page costs half
        a bf16 one) must be proportionally staler to be chosen over a
        costly newer one.  The comparison is exact integer
        cross-multiplication — no float ties — and a uniform cost
        reduces it to plain LRU, clock alone.

        Deterministic tie-break: the lowest page id wins at equal
        scores (``sorted`` iteration + strict ``<``).
        """
        best = None
        best_clock = None
        best_cost = 1
        for page in sorted(among):
            node = self.nodes.get(page)
            if node is None:
                continue
            c = 1 if cost is None else max(1, int(cost(page)))
            # node.clock / c < best_clock / best_cost, exactly
            if best_clock is None \
                    or node.clock * best_cost < best_clock * c:
                best = page
                best_clock = node.clock
                best_cost = c
        return best

    def groups(self) -> List[Tuple[int, ...]]:
        """First-chunk keys of the root's children (preamble groups).

        Each key names one independently evictable/migratable subtree:
        the router's hash tiers place requests by exactly this chunk,
        so it is the unit rendezvous cache migration moves and the
        ``roots`` filter of ``serving.snapshot`` selects by.  Sorted
        for deterministic iteration.
        """
        return sorted(self.root.children)

    def drop_subtree(self, page: int) -> List[int]:
        """Detach the node owning ``page`` plus its whole subtree.

        Returns every page id the subtree retained (subtree root first).
        """
        node = self.nodes.get(page)
        if node is None:
            return []
        del node.parent.children[node.key]
        dropped: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            dropped.append(n.page)
            self.nodes.pop(n.page, None)
            stack.extend(n.children.values())
        return dropped
