"""Paged KV-cache bookkeeping: refcounted page table + prefix tree.

A copy of ``repro.engine.pagetable`` (pure Python, no framework): the
port keeps its own so it never imports the JAX package.

Host-side metadata for the device-resident page pool. The pool itself
is a pair of ``(num_pages, page_size, kv_heads, head_dim)`` arrays held
by the engine; this module only tracks which pages are free, how many
requests reference each page, and which fully-written prompt pages can
be shared between requests with a common prompt prefix.

Page 0 is the **null page**: permanently reserved, never handed out.
Padded rows of a decode bucket point their whole page-table row at it,
so dummy lanes scatter their (identical, deterministic) writes into a
page no real request ever reads.

Sharing is storage-level deduplication: a prefix-tree node maps a
*full page of prompt tokens* (reached through its parent chain, so the
key is position-dependent) to the pool page holding its KV rows. With
causal attention, identical token prefixes produce bit-identical KV
rows regardless of what follows them, so a shared page read by request
A equals what A's own prefill would have written — bit-identity of
outputs is preserved (asserted in tests/test_engine.py).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

NULL_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """Raised by ``alloc`` when the free list cannot cover a request."""


class PageTable:
    """Free list + per-page reference counts over a fixed pool.

    Pages are shared by refcount: a page is returned to the free list
    only when its last reference drops. ``peak_used`` tracks the
    high-water occupancy (a bench-gated metric).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages {num_pages} < 2 (page 0 is "
                             "reserved as the null page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refcount = [0] * num_pages
        self.refcount[NULL_PAGE] = 1          # pinned forever
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.peak_used = 0

    # -- capacity --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages currently referenced (excluding the null page)."""
        return (self.num_pages - 1) - len(self._free)

    # -- alloc / share / free -------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each) off the free list."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            assert self.refcount[p] == 0, p
            self.refcount[p] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return out

    def share(self, page: int) -> int:
        """Add a reference to an already-live page."""
        if page == NULL_PAGE:
            return page
        if self.refcount[page] <= 0:
            raise ValueError(f"share of dead page {page}")
        self.refcount[page] += 1
        return page

    def free(self, page: int) -> None:
        """Drop one reference; recycle the page when none remain."""
        if page == NULL_PAGE:
            return
        if self.refcount[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    def balanced(self) -> bool:
        """True iff every non-null page is unreferenced and free —
        the drain invariant the hypothesis suite asserts."""
        live = [p for p in range(1, self.num_pages) if self.refcount[p]]
        return not live and len(self._free) == self.num_pages - 1


@dataclass
class _Node:
    page: int
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    parent: Optional["_Node"] = None
    key: Optional[Tuple[int, ...]] = None
    stamp: int = 0                        # last-matched LRU clock value


class PrefixTree:
    """Trie over full prompt pages for cross-request KV reuse.

    Each edge is labelled with one page's worth of tokens; each node
    (except the root) owns a reference on the pool page holding that
    edge's KV rows. ``match`` walks the longest shared prefix and takes
    a reference per matched page for the caller; ``insert`` registers a
    request's freshly-prefilled full pages for future requests.

    Under pool pressure the tree is an LRU victim set: every ``match``
    / ``insert`` stamps the touched path with a monotonic clock, and
    ``evict`` frees leaf pages held *only* by the tree (refcount 1) in
    least-recently-matched order — hot shared prefixes survive, pages a
    live request still reads are never victims. ``evict_all`` (engine
    drain) drops every tree-held reference in the same deterministic
    leaf-first LRU order.
    """

    def __init__(self, table: PageTable):
        self.table = table
        self.root = _Node(NULL_PAGE)
        self.hits = 0
        self.misses = 0
        self.nodes = 0
        self.evicted = 0                  # cumulative pages freed to pool
        self._clock = 0

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def lookup(self, page_tokens: List[Tuple[int, ...]]) -> int:
        """Length of the longest shared prefix, in pages — no references
        taken, no hit/miss accounting (admission capacity checks)."""
        node = self.root
        n = 0
        for toks in page_tokens:
            child = node.children.get(toks)
            if child is None:
                break
            n += 1
            node = child
        return n

    def match(self, page_tokens: List[Tuple[int, ...]]
              ) -> List[int]:
        """Longest-prefix match; returns shared pages (ref'd for the
        caller) covering ``page_tokens[:len(result)]``."""
        node = self.root
        out: List[int] = []
        for toks in page_tokens:
            child = node.children.get(toks)
            if child is None:
                break
            out.append(self.table.share(child.page))
            self._touch(child)
            node = child
        self.hits += len(out)
        self.misses += len(page_tokens) - len(out)
        return out

    def insert(self, page_tokens: List[Tuple[int, ...]],
               pages: List[int]) -> int:
        """Register full prompt pages along one root path; the tree
        takes its own reference on each newly registered page. Returns
        the number of new nodes."""
        assert len(page_tokens) == len(pages)
        node = self.root
        added = 0
        for toks, page in zip(page_tokens, pages):
            child = node.children.get(toks)
            if child is None:
                child = _Node(self.table.share(page), parent=node, key=toks)
                node.children[toks] = child
                added += 1
            self._touch(child)
            node = child
        self.nodes += added
        return added

    # -- eviction --------------------------------------------------------
    def _leaf_heap(self) -> List[Tuple[int, int, _Node]]:
        """Min-heap of current leaves keyed (LRU stamp, insertion id)."""
        leaves = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for ch in nd.children.values():
                if ch.children:
                    stack.append(ch)
                else:
                    leaves.append((ch.stamp, id(ch), ch))
        heapq.heapify(leaves)
        return leaves

    def _unlink(self, node: _Node) -> Optional[_Node]:
        """Detach a leaf from its parent; returns the parent if it just
        became an evictable (non-root) leaf itself."""
        assert not node.children
        parent = node.parent
        del parent.children[node.key]
        self.nodes -= 1
        if parent is not self.root and not parent.children:
            return parent
        return None

    def evict(self, n_pages: int,
              protect: Optional[List[Tuple[int, ...]]] = None) -> List[int]:
        """Free up to ``n_pages`` pool pages under pressure, in
        least-recently-matched leaf-first order.

        Only pages whose *sole* reference is the tree's (refcount 1) are
        victims — a page a live request shares is never evicted. Nodes on
        the ``protect`` path (the head request's own prefix) are spared
        so admission never cannibalizes the prefix it is about to match.
        Returns the freed page ids in eviction order."""
        protected = set()
        if protect:
            node = self.root
            for toks in protect:
                node = node.children.get(toks)
                if node is None:
                    break
                protected.add(id(node))
        heap = self._leaf_heap()
        freed: List[int] = []
        while heap and len(freed) < n_pages:
            _, _, node = heapq.heappop(heap)
            if id(node) in protected or self.table.refcount[node.page] != 1:
                continue                  # shared with a live request
            parent = self._unlink(node)
            self.table.free(node.page)
            freed.append(node.page)
            if parent is not None:
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        self.evicted += len(freed)
        return freed

    def evict_all(self) -> List[int]:
        """Drop every tree-held reference (engine drain), leaf-first in
        LRU order; returns the pages actually freed to the pool (pages a
        live request still references merely lose the tree's ref)."""
        heap = self._leaf_heap()
        freed: List[int] = []
        while heap:
            _, _, node = heapq.heappop(heap)
            parent = self._unlink(node)
            last = self.table.refcount[node.page] == 1
            self.table.free(node.page)
            if last:
                freed.append(node.page)
            if parent is not None:
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        return freed

    def clear(self) -> List[int]:
        """Release every tree-held page reference (legacy all-or-nothing
        eviction policy); returns the pages freed to the pool."""
        return self.evict_all()
