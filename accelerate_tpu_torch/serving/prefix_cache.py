"""Automatic prefix caching: radix-tree KV reuse across requests.

This package's own copy of the JAX package's host-side radix tree
(`serving/prefix_cache.py`), minus request tracing and the router's
migration surface (both wait for later slices):

- a HOST-side radix tree keyed on token ids records which prefixes have
  committed KV retained on the device;
- the device storage is a dedicated **prefix pool**: a second family cache
  whose rows mirror the engine's slot rows, sized by a byte budget;
- every row-bearing node owns ONE pool row holding committed KV for
  positions ``[0, node.end)`` of its full root path, so any unreferenced
  node can be LRU-evicted without touching its subtree;
- cached lengths are **chunk-aligned** (sums of the engine's prefill bucket
  lengths), so every hit and promotion copies in bucket-sized chunks;
- nodes are **ref-counted**: `match` pins its source node until the engine
  has issued the hit copy (`release`), and eviction skips pinned nodes.

The tree never touches a tensor: it hands the engine ``(row, length)`` and
the engine issues the copies (`engine._prefill_step` / `engine._promote`).
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np

from .. import telemetry as _telemetry

__all__ = ["PrefixCache", "CacheNode"]


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    neq = a != b
    return int(neq.argmax()) if neq.any() else len(a)


class CacheNode:
    """One radix-tree node. ``edge`` is the token span from the parent and
    ``end`` the cumulative token depth. Row-bearing nodes (``row is not
    None``) own one pool row; structural nodes created by edge splits carry
    no row and are pruned once childless. ``refs`` pins the row against
    eviction while an admitted slot still plans to copy from it."""

    __slots__ = ("edge", "end", "children", "row", "refs", "last_use", "parent")

    def __init__(self, edge: np.ndarray, end: int, parent: "CacheNode | None"):
        self.edge = edge
        self.end = end
        self.children: dict[int, CacheNode] = {}
        self.row: int | None = None
        self.refs = 0
        self.last_use = 0
        self.parent = parent


class PrefixCache:
    """Host-side index over a fixed pool of ``rows`` device KV rows.

    ``buckets`` are the engine's prefill bucket lengths; ``max_len`` the
    per-row capacity. Only lengths decomposable into bucket-sized chunks are
    stored or matched (``aligned`` / ``chunks``)."""

    def __init__(self, rows: int, buckets: Sequence[int], max_len: int) -> None:
        if rows < 1:
            raise ValueError(f"prefix cache needs >= 1 row, got {rows}")
        self.n_rows = rows
        self.buckets = tuple(sorted(set(buckets)))
        self.max_len = max_len
        self._free: deque[int] = deque(range(rows))
        self._root = CacheNode(np.empty((0,), np.int32), 0, None)
        self._entries: set[CacheNode] = set()  # row-bearing nodes
        self._clock = 0
        self.stats = _telemetry.StatsView(
            "serve_prefix_cache",
            (
                "lookups",
                "hits",
                "tokens_matched",
                "insertions",
                "dedup_skips",
                "evictions",
                "insert_denied",  # no free row and every row pinned
            ),
            label="cache",
        )
        # Reachability DP over [0, max_len]: _chunkable[n] is the LARGEST
        # bucket completing a decomposition of n into bucket lengths (0 =
        # not decomposable; handles bucket sets like (5, 7): 12 = 5 + 7).
        chunkable = np.zeros(max_len + 1, np.int64)
        chunkable[0] = -1
        for n in range(1, max_len + 1):
            for b in self.buckets:
                if b <= n and chunkable[n - b]:
                    chunkable[n] = b
        self._chunkable = chunkable

    # ---------------------------------------------------------- alignment
    def aligned(self, n: int) -> int:
        """Largest chunk-decomposable length <= n (0 if none)."""
        n = min(int(n), self.max_len)
        while n > 0 and not self._chunkable[n]:
            n -= 1
        return n

    def chunks(self, n: int) -> list[int]:
        """Decompose an `aligned` length into bucket-sized copy chunks."""
        out: list[int] = []
        n = int(n)
        while n > 0:
            b = int(self._chunkable[n])
            if b <= 0:
                raise ValueError(f"length {n} is not chunk-aligned for buckets {self.buckets}")
            out.append(b)
            n -= b
        return out

    # ------------------------------------------------------------- lookup
    @property
    def used_rows(self) -> int:
        return self.n_rows - len(self._free)

    def _touch(self, node: CacheNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    def _any_row_below(self, node: CacheNode) -> CacheNode | None:
        if node.row is not None:
            return node
        for child in node.children.values():
            found = self._any_row_below(child)
            if found is not None:
                return found
        return None

    def match(
        self, tokens: np.ndarray, *, limit: int | None = None
    ) -> tuple[CacheNode | None, int]:
        """Longest usable cached prefix of ``tokens``: ``(node, length)``
        where ``node``'s row holds committed KV for at least positions
        [0, length) of ``tokens`` and ``length`` is chunk-aligned and <=
        ``limit``. The node is PINNED until `release`. A miss is
        ``(None, 0)``."""
        self.stats["lookups"] += 1
        tokens = np.asarray(tokens)
        node, depth = self._root, 0
        path: list[CacheNode] = []
        frontier: CacheNode | None = None  # child matched partway into its edge
        while depth < len(tokens):
            child = node.children.get(int(tokens[depth]))
            if child is None:
                break
            n = min(len(child.edge), len(tokens) - depth)
            common = _common_prefix(child.edge[:n], tokens[depth : depth + n])
            depth += common
            if common < len(child.edge):
                if common > 0:
                    frontier = child
                break
            node = child
            path.append(child)
        limit = len(tokens) if limit is None else min(int(limit), len(tokens))
        matched = self.aligned(min(depth, limit))
        if matched <= 0:
            return None, 0
        # A source row must cover [0, matched) of a path agreeing with
        # ``tokens`` for >= matched tokens: fully matched path nodes with
        # end >= matched qualify, as does ANY row below the deepest matched
        # point (everything there shares the first ``depth`` tokens).
        src: CacheNode | None = None
        for cand in reversed(path):
            if cand.row is not None and cand.end >= matched:
                src = cand
                break
        if src is None:
            src = self._any_row_below(frontier if frontier is not None else node)
        if src is None:
            return None, 0
        src.refs += 1
        self._touch(src)
        self.stats["hits"] += 1
        self.stats["tokens_matched"] += matched
        return src, matched

    def release(self, node: CacheNode) -> None:
        """Unpin a node returned by `match` (after the copy is issued)."""
        if node.refs <= 0:
            raise RuntimeError("release() without a matching match() pin")
        node.refs -= 1

    # ------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray) -> int | None:
        """Register ``tokens`` (an `aligned`-length committed prefix) and
        return the pool row the caller must now copy the KV into, or None
        when the prefix is already cached or every row is pinned (the caller
        skips promotion; correctness never depends on an insert landing).
        May LRU-evict an unpinned entry to free a row."""
        tokens = np.asarray(tokens, np.int32)
        L = len(tokens)
        if L <= 0 or L > self.max_len or not self._chunkable[L]:
            raise ValueError(f"insert length {L} is not chunk-aligned (buckets {self.buckets})")
        node, depth = self._root, 0
        child: CacheNode | None = None
        common = 0
        while depth < L:
            child = node.children.get(int(tokens[depth]))
            if child is None:
                break
            n = min(len(child.edge), L - depth)
            common = _common_prefix(child.edge[:n], tokens[depth : depth + n])
            depth += common
            if common < len(child.edge):
                break
            node = child
            child = None
            common = 0
        if depth == L and child is None and node.row is not None:
            self._touch(node)  # exact duplicate: refresh recency only
            self.stats["dedup_skips"] += 1
            return None
        row = self._take_row()
        if row is None:
            self.stats["insert_denied"] += 1
            return None
        if depth == L and child is None:
            target = node  # structural node at exactly L: adopt a row
        elif child is None:
            target = CacheNode(tokens[depth:].copy(), L, node)
            node.children[int(tokens[depth])] = target
        else:
            # Matched partway into ``child``'s edge: split it at ``common``.
            mid = CacheNode(child.edge[:common], child.end - len(child.edge) + common, node)
            node.children[int(mid.edge[0])] = mid
            child.edge = child.edge[common:]
            child.parent = mid
            mid.children[int(child.edge[0])] = child
            if mid.end == L:
                target = mid
            else:
                target = CacheNode(tokens[depth:].copy(), L, mid)
                mid.children[int(tokens[depth])] = target
        target.row = row
        self._entries.add(target)
        self._touch(target)
        self.stats["insertions"] += 1
        return row

    def _take_row(self) -> int | None:
        if self._free:
            return self._free.popleft()
        victims = [n for n in self._entries if n.refs == 0]
        if not victims:
            return None
        self._evict(min(victims, key=lambda n: n.last_use))
        return self._free.popleft()

    def _evict(self, node: CacheNode) -> None:
        """Free one row; childless structural leftovers are pruned up the
        path (every descendant's row is self-contained)."""
        self._free.append(node.row)
        node.row = None
        self._entries.discard(node)
        self.stats["evictions"] += 1
        while (
            node.parent is not None
            and node.row is None
            and not node.children
            and node.refs == 0
        ):
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node.parent = None
            node = parent
