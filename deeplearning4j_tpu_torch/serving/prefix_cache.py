"""Prefix cache: token-level radix tree over device-side KV segments (the
port of ``deeplearning4j_tpu/serving/prefix_cache.py``, which imports no
JAX; host-only bookkeeping, kept here as the port's own copy).

Serving traffic is dominated by shared prompt prefixes — system prompts,
few-shot templates, multi-turn histories. This module gives the engine a
bounded SEGMENT REGION (a second ``init_caches`` allocation with the decode
pool's per-slot layout: same Tpad, same dtype, same int8 scale planes, see
``KVSlotPool.alloc_region``) plus a radix tree mapping token sequences to
region slots: one segment = one full-prefix KV slab in one region slot, so
reuse is one slab copy instead of a paged gather. Over a ``PagedKVPool``
there is no region: a segment is a list of refcounted pool blocks.

The tree is a compressed radix trie: edges are token runs, segments live
at nodes (a lookup matches only at node boundaries; the engine rounds a
partial match down to its hit grain). ``lookup`` returns the DEEPEST node
on the query's root path holding a live segment; ``insert`` splits edges
as needed and claims a region slot, evicting least-recently-used UNPINNED
segments (weighted by their hits) to make room.

Refcounted pinning is the correctness boundary: the engine pins a segment
for every admission that reads it and unpins at retirement, and
``_evict_one`` only considers ``refs == 0`` segments, so a segment an
active slot read is NEVER dropped. When every segment is pinned,
``insert`` declines (returns no segment) rather than grow: the cache is
bounded by construction.

The only device state is ``region``, which the engine's programs write in
place. ``reinit`` (crash recovery) re-creates the region zeroed and drops
every segment: after a crash the buffers are assumed corrupt, and replay
then runs every lookup against an empty tree, the cold-miss path.
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterable

from deeplearning4j_tpu_torch.serving.cache_pool import KVSlotPool


class Segment:
    """One cached prefix: ``length`` tokens of KV in region slot
    ``slot``, plus the (1, V) last-row logits captured at insert time —
    a FULL hit replays those logits directly, so a fully-cached
    admission dispatches zero prefill programs.

    Over a :class:`~deeplearning4j_tpu_torch.serving.cache_pool.PagedKVPool`
    the storage is ``block_ids`` instead of a region slot: the pool
    block ids (cache-owned references) covering the prefix rows, mostly
    aliased straight off the donor slot's table plus at most one
    privately copied tail block. ``slot`` is then just a monotonic
    identity used for deterministic eviction tie-breaks.

    ``partial_ok`` (engine-set): the segment's rows were computed by the
    engine's chunk windows, so they may serve a PARTIAL hit (see the
    engine's ``_classify_plan``); a FULL hit needs only ``logits``."""

    __slots__ = ("slot", "length", "node", "refs", "last_use", "hits",
                 "logits", "alive", "block_ids", "partial_ok")

    def __init__(self, slot: int, length: int, node: "_Node"):
        self.slot = slot
        self.length = length
        self.node = node
        self.refs = 0          # in-flight admissions reading this segment
        self.last_use = 0      # LRU tick, updated on lookup hit
        self.hits = 0          # lifetime lookup hits (eviction weighting)
        self.logits = None     # device (1, V) row, set by the engine
        self.alive = True      # False once evicted (guards stale unpins)
        self.block_ids = None  # paged mode: pool block ids, engine-set
        self.partial_ok = False  # rows reusable by a partial hit


class _Node:
    """Radix-trie node: ``edge`` is the token run from the parent,
    ``segment`` (optional) caches the prefix spelled by the root path
    ending here."""

    __slots__ = ("edge", "children", "parent", "segment")

    def __init__(self, edge: tuple, parent: "_Node | None"):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.parent = parent
        self.segment: Segment | None = None


def _common_len(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Radix tree + bounded segment region + refcounted LRU eviction.

    ``capacity_tokens`` is rounded down to whole region slots (each
    segment occupies a full Tpad slab — the fixed-slot analogue of a
    page budget); at least one slot is always allocated. ``on_evict``
    is called once per evicted segment (the engine wires it to the
    Prometheus eviction counter).
    """

    def __init__(self, pool: KVSlotPool, capacity_tokens: int,
                 on_evict: Callable[[Segment], None] | None = None,
                 min_seg_len: int = 1, hit_weight: float = 4.0):
        self.tpad = pool.tpad
        self.paged = bool(getattr(pool, "is_paged", False))
        if self.paged:
            # Paged mode: no region at all. Segments live as
            # refcounted block lists INSIDE the pool's shared block
            # store (mostly aliases of the donor slot's blocks), so the
            # capacity budget bounds how many blocks the cache may keep
            # referenced, not a second allocation.
            self._pool = pool
            self.n_region_slots = 0
            self.capacity_blocks = max(
                1, int(capacity_tokens) // pool.block_size
            )
            self.capacity_tokens = self.capacity_blocks * pool.block_size
            self.region = None
            self._nbytes = 0
            self._next_id = 0  # monotonic Segment.slot (tie-breaks)
        else:
            self._pool = pool
            self.n_region_slots = max(1, int(capacity_tokens) // self.tpad)
            self.capacity_tokens = self.n_region_slots * self.tpad
            self._alloc_region = (
                lambda: pool.alloc_region(self.n_region_slots)
            )
            self.region = self._alloc_region()
            # region byte size is fixed for the cache's lifetime: take
            # it from the pool's host metadata so metrics scrapes never
            # touch the live device tensors (see KVSlotPool.region_nbytes)
            self._nbytes = pool.region_nbytes(self.n_region_slots)
        self.on_evict = on_evict
        self.min_seg_len = max(1, int(min_seg_len))  # branch-seg floor
        # eviction score = last_use + hit_weight * hits: each lifetime
        # hit buys the segment hit_weight LRU ticks of extra survival,
        # so a hot system-prompt segment outlives colder-but-newer ones
        # under churn instead of rotating out the moment traffic mixes
        # (flat LRU's failure mode). 0 restores pure LRU.
        self.hit_weight = float(hit_weight)
        self._root = _Node((), None)
        self._free: list[int] = list(range(self.n_region_slots))  # heap
        self._segments: set[Segment] = set()
        self._tick = 0
        self.n_evictions = 0
        self.n_inserts = 0
        self.n_insert_declined = 0  # region full of pinned segments

    # -- introspection -----------------------------------------------------

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    @property
    def tokens_cached(self) -> int:
        return sum(s.length for s in self._segments)

    @property
    def n_pinned(self) -> int:
        return sum(1 for s in self._segments if s.refs > 0)

    @property
    def blocks_cached(self) -> int:
        """Paged mode: pool blocks the live segments logically span
        (``ceil(length/block_size)`` each — shared aliases counted once
        per segment, matching the capacity budget's bookkeeping)."""
        if not self.paged:
            return 0
        return sum(
            self._pool.blocks_needed(s.length) for s in self._segments
        )

    def nbytes(self) -> int:
        """Device bytes the cache accounts for: the fixed segment region in slab mode, or the live
        segments' block span in paged mode. Host metadata either way —
        scrapes never touch the live device arrays."""
        if self.paged:
            return self.blocks_cached * self._pool.block_nbytes()
        return self._nbytes

    def stats(self) -> dict:
        return {
            "segments": self.n_segments,
            "pinned": self.n_pinned,
            "tokens_cached": self.tokens_cached,
            "capacity_tokens": self.capacity_tokens,
            "evictions": self.n_evictions,
            "inserts": self.n_inserts,
            "insert_declined": self.n_insert_declined,
            "hits_recorded": sum(s.hits for s in self._segments),
        }

    # -- tree --------------------------------------------------------------

    def lookup(self, tokens: Iterable[int]) -> tuple[Segment | None, int]:
        """Longest cached prefix of ``tokens``: the deepest node on the
        query's root path holding a live segment. Returns
        ``(segment, matched_len)`` with ``matched_len ==
        segment.length`` (segments only exist at node boundaries), or
        ``(None, 0)``. A hit refreshes the segment's LRU tick."""
        q = tuple(int(t) for t in tokens)
        node, depth = self._root, 0
        best: Segment | None = None
        best_depth = 0
        while True:
            if node.segment is not None:
                best, best_depth = node.segment, depth
            child = node.children.get(q[depth]) if depth < len(q) else None
            if child is None:
                break
            e = child.edge
            if len(q) - depth < len(e) or q[depth:depth + len(e)] != e:
                break  # query diverges (or ends) mid-edge: no node there
            node, depth = child, depth + len(e)
        if best is not None:
            self._tick += 1
            best.last_use = self._tick
            best.hits += 1
        return best, best_depth

    def insert(self, tokens: Iterable[int]) -> list[Segment]:
        """Cache ``tokens`` as a new segment, claiming a region slot
        per segment (evicting unpinned LRU segments as needed).
        Returns the NEW segments needing device backing — the
        full-``tokens`` segment first, plus at most one segment at a
        newly observed BRANCH POINT: when this insert diverges from an
        existing path (edge split, or a new child under an existing
        interior node), the common prefix has now been seen with two
        different continuations — exactly the system-prompt sharing
        signal radix caches exist for — so it gets its own segment
        (length ≥ ``min_seg_len``), usable by future partial hits.
        Branch segments carry no stored logits (no request ended
        there), so they can never serve a FULL hit — the engine
        prefills their last row like any partial hit. The CALLER copies
        the KV slab into ``region`` at each ``segment.slot`` (a branch
        segment's slab is the same slab — rows past its length are
        stale, invisible under causal masking and overwritten by the
        suffix prefill). Empty when the prefix is already cached or
        every slot is pinned. Each returned segment starts PINNED
        (refs=1): not yet backed by device rows; the caller's unpin at
        request retirement makes it evictable."""
        q = tuple(int(t) for t in tokens)
        if not q:
            return []
        node, depth = self._root, 0
        branch: tuple[_Node, int] | None = None
        while depth < len(q):
            child = node.children.get(q[depth])
            if child is None:
                if node is not self._root and node.segment is None:
                    branch = (node, depth)  # existing branch node,
                    # sharing re-observed (e.g. after an eviction)
                nxt = _Node(q[depth:], node)
                node.children[q[depth]] = nxt
                node, depth = nxt, len(q)
                break
            c = _common_len(child.edge, q[depth:])
            if c == len(child.edge):
                node, depth = child, depth + c
                continue
            # split the edge at the divergence (or at query end)
            mid = _Node(child.edge[:c], node)
            node.children[q[depth]] = mid
            child.edge = child.edge[c:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            if depth + c == len(q):
                node, depth = mid, len(q)
            else:
                branch = (mid, depth + c)
                nxt = _Node(q[depth + c:], mid)
                mid.children[nxt.edge[0]] = nxt
                node, depth = nxt, len(q)
            break
        out: list[Segment] = []
        # Branch FIRST: its _attach may evict, and if eviction prunes
        # away the branch node's other subtree the node drops to one
        # child and would be merged — the placeholder _attach puts on
        # before claiming makes it unprunable. The main leaf needs no
        # such shield: it has no descendants, so no eviction's upward
        # prune walk can reach it. (If the branch attach declines,
        # every slot is pinned and the main attach declines without
        # evicting either — no merge hazard on the bare branch node.)
        bseg = None
        if (branch is not None and branch[0].segment is None
                and branch[1] >= self.min_seg_len):
            bseg = self._attach(branch[0], branch[1])
        if node.segment is None:
            seg = self._attach(node, len(q))
            if seg is not None:
                out.append(seg)
            else:
                # drop the structural leaf just created; the upward
                # walk stops at the branch node (other children, plus
                # a segment if the branch attach succeeded)
                self._prune(node)
        if bseg is not None:
            out.append(bseg)
        return out

    def _attach(self, node: _Node, length: int) -> Segment | None:
        """Claim a region slot and attach a new pre-pinned segment to
        ``node``. The placeholder goes on BEFORE claiming: _claim_slot
        may evict, and eviction prunes/merges segment-less nodes —
        including this one, which would detach the node we are about to
        cache at. A node with a segment is never pruned, and the
        placeholder cannot be the eviction victim (it is not in
        ``_segments`` yet)."""
        seg = Segment(-1, length, node)
        seg.refs = 1
        node.segment = seg
        if self.paged:
            # Budget in blocks, not region slots: evict unpinned
            # segments until this one's block span fits, declining when
            # everything left is pinned (same bounded-by-construction
            # contract as the slab region).
            need = self._pool.blocks_needed(length)
            while self.blocks_cached + need > self.capacity_blocks:
                if not self._evict_one():
                    node.segment = None
                    self.n_insert_declined += 1
                    return None
            self._next_id += 1
            seg.slot = self._next_id
        else:
            slot = self._claim_slot()
            if slot is None:
                node.segment = None
                self.n_insert_declined += 1
                return None
            seg.slot = slot
        self._tick += 1
        seg.last_use = self._tick
        self._segments.add(seg)
        self.n_inserts += 1
        return seg

    # -- pinning / eviction ------------------------------------------------

    def pin(self, seg: Segment) -> None:
        """One more in-flight reader: the segment cannot be evicted
        until the matching :meth:`unpin`."""
        if seg.alive:
            seg.refs += 1

    def unpin(self, seg: Segment) -> None:
        """Release one reader. Safe on a segment dropped by ``reinit``
        (crash recovery clears pins wholesale)."""
        if seg.alive and seg.refs > 0:
            seg.refs -= 1

    def _claim_slot(self) -> int | None:
        if self._free:
            return heapq.heappop(self._free)
        if self._evict_one():
            return heapq.heappop(self._free)
        return None

    def _evict_one(self) -> bool:
        """Drop the UNPINNED segment with the lowest hit-weighted
        recency score (``last_use + hit_weight * hits`` — see
        ``__init__``; ties broken by raw recency, then slot index for
        determinism). Pinned segments (refs > 0 — referenced by an
        active slot's in-flight admission) are never candidates, so
        eviction can fail even at full capacity; the caller declines
        the insert instead."""
        victim: Segment | None = None
        vscore = None
        for seg in self._segments:
            if seg.refs:
                continue
            score = (seg.last_use + self.hit_weight * seg.hits,
                     seg.last_use, seg.slot)
            if victim is None or score < vscore:
                victim, vscore = seg, score
        if victim is None:
            return False
        self._drop(victim)
        self.n_evictions += 1
        if self.on_evict is not None:
            self.on_evict(victim)
        return True

    def drop(self, seg: Segment) -> None:
        """Abort an insert: the engine failed to back ``seg`` with
        device rows (paged mode — the tail-block allocation lost a race
        with admission pressure), so remove it before any lookup can
        hit unbacked storage. Safe no-op on a segment already gone."""
        if seg.alive:
            self._drop(seg)

    def reclaim(self) -> bool:
        """Evict one unpinned segment on demand, returning whether one
        was dropped. Paged admission uses this to hand cached blocks
        back to the pool's free heap when a fresh request doesn't fit."""
        return self._evict_one()

    def _drop(self, seg: Segment) -> None:
        seg.alive = False
        seg.logits = None
        seg.node.segment = None
        self._segments.discard(seg)
        if self.paged:
            if seg.block_ids:
                self._pool.decref(seg.block_ids)
            seg.block_ids = None
        else:
            heapq.heappush(self._free, seg.slot)
        self._prune(seg.node)

    def _prune(self, node: _Node) -> None:
        """Re-compress the trie after a removal: delete childless
        segment-less nodes bottom-up, then merge a single-child
        segment-less node into its child."""
        while (node is not self._root and node.segment is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent
        if (node is not self._root and node.segment is None
                and len(node.children) == 1):
            (child,) = node.children.values()
            child.edge = node.edge + child.edge
            child.parent = node.parent
            node.parent.children[node.edge[0]] = child

    # -- recovery ----------------------------------------------------------

    def reinit(self) -> None:
        """Crash recovery: re-create the region buffers zeroed and drop
        every segment AND every pin (the engine clears its per-slot
        segment refs in the same breath). Replay then misses on every
        lookup — the same code path as a cold start, so recovered
        streams stay byte-identical.

        Paged ordering contract: the engine calls ``pool.reinit()``
        FIRST (it resets every refcount and rebuilds the block free
        heap wholesale), so dropping segments here must NOT decref
        their block ids — the counts they referenced no longer exist."""
        if not self.paged:
            self.region = self._alloc_region()
        for seg in list(self._segments):
            seg.alive = False
            seg.logits = None
            seg.refs = 0
            seg.block_ids = None
        self._root = _Node((), None)
        self._free = list(range(self.n_region_slots))
        self._segments = set()
