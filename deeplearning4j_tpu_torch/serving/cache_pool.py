"""KV-slot pools over ONE pre-allocated decode cache (port of
``deeplearning4j_tpu/serving/cache_pool.py``): the slab pool
``KVSlotPool`` and the block-paged ``PagedKVPool``.

The batch axis of ``init_caches`` IS the slot pool: the buffer
(n_layers, 2, n_slots, Tpad, Hkv*K), plus the f32 scale planes in int8 mode,
is allocated once on the engine's device and never re-allocated. Admitting
a request rewrites that slot's whole slab (zeroed, then prefilled), so no
stale rows of the previous occupant survive; releasing a slot is free-list
bookkeeping only. Slots are handed out lowest-index-first so admission
order is deterministic; a per-slot generation, bumped on acquire, lets the
pipelined engine tell a token block of a previous occupant from the current
one's.

Under exact tensor parallelism (``tp_mesh``, the reference's
``sharding=serving_tp_cache_sharding(...)``) every leaf is a
:class:`~..parallel.mesh.Shards`: each rank's buffer ``(n_layers, 2,
n_slots, Tpad, Hkv/tp*K)`` (blocks in the paged pool) on its device, the
int8 scale plane whole on every rank; the paged pool uploads one copy of
the block tables per rank device, together. Every pool operation runs per
rank through ``kv_map``, and the byte counts sum every shard.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.sanitizers import (
    note_access,
    wrap_lock,
)
from deeplearning4j_tpu_torch.device import upload
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _decode_builder,
    kv_leaves,
    kv_map,
    paged_block_copy,
    paged_scatter,
)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, Shards, smap


def _nbytes(caches) -> int:
    return sum(x.numel() * x.element_size() for x in kv_leaves(caches))


class KVSlotPool:
    """Free-list of decode-cache slots over one device allocation.
    ``caches`` is a float tensor, or ``{"kv", "scale"}`` in int8 mode;
    under ``tp_mesh`` each leaf a :class:`Shards` over the mesh."""

    is_paged = False

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_total: int,
                 device: torch.device, *, tp_mesh: Mesh | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        _, self._init_caches, _, _ = _decode_builder(cfg, tp_mesh)
        self._max_total = max_total
        self._device = device
        self.tp_mesh = tp_mesh
        self.n_slots = n_slots
        # the slab geometry first (shapes only, on the meta device): the
        # paged pool carves the same rows into blocks
        self.tpad = kv_leaves(self._init_caches(
            1, max_total, torch.device("meta")))[0].shape[3]
        self.caches = self._alloc_caches()
        # acquire/release run on the engine thread while the gauges read
        # from HTTP threads: the free list moves under the lock
        self._lock = wrap_lock(threading.Lock(), "pool._lock")
        self._free = list(range(n_slots))  # a heap; guarded-by: _lock
        self._in_use: set[int] = set()  # guarded-by: _lock
        self._gen = [0] * n_slots  # guarded-by: _lock
        # byte size from shapes, captured once: gauges never touch the
        # device tensors
        self._nbytes = _nbytes(self.caches)

    def _alloc_caches(self):
        return self._init_caches(self.n_slots, self._max_total,
                                 self._device)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._in_use)

    @property
    def occupancy(self) -> float:
        """Active fraction of the slot batch this instant, in [0, 1]."""
        with self._lock:
            return len(self._in_use) / self.n_slots

    def acquire(self) -> int:
        """Claim the lowest free slot index."""
        with self._lock:
            note_access("pool.freelist", write=True)
            if not self._free:
                raise RuntimeError("no free KV slots")
            slot = heapq.heappop(self._free)
            self._in_use.add(slot)
            self._gen[slot] += 1
            return slot

    def generation(self, slot: int) -> int:
        """Acquire count for ``slot`` (identifies the current occupant)."""
        with self._lock:
            return self._gen[slot]

    def release(self, slot: int) -> None:
        with self._lock:
            note_access("pool.freelist", write=True)
            if slot not in self._in_use:
                raise ValueError(f"slot {slot} is not in use")
            self._in_use.remove(slot)
            heapq.heappush(self._free, slot)

    def slab(self, slot: int):
        """The (n_layers, 2, 1, Tpad, ...) view of one slot's rows (leafwise
        in int8 mode); writes through it land in the pool."""
        return kv_map(lambda x: x[:, :, slot:slot + 1], self.caches)

    def operand(self):
        """The caches operand of the engine's programs."""
        return self.caches

    def prefill_slab(self, slot: int):
        """The batch-1 slab an admission prefills ``slot``'s prompt into:
        here the slot's own rows, zeroed (no row of the previous occupant
        survives)."""
        return kv_map(lambda x: x.zero_(), self.slab(slot))

    def land(self, slot: int, slab, start: int = 0) -> None:
        """Make a prefilled :meth:`prefill_slab` ``slot``'s rows: here they
        already are."""

    def write_slab(self, slot: int, slab, start: int = 0) -> None:
        """Copy rows ``start``.. of a batch-1 scratch slab into ``slot``'s
        rows."""
        kv_map(lambda d, s: d[:, :, :, start:].copy_(s[:, :, :, start:]),
               self.slab(slot), slab)

    def alloc_region(self, n_slots: int):
        """A second cache allocation with the pool's per-slot layout (Tpad
        rows, dtype, int8 scale planes), zeroed: a region slab and a pool
        slab are interchangeable. The prefix cache keeps its segments in
        one; the pool owns the layout, the cache owns the slots."""
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        return self._init_caches(n_slots, self._max_total, self._device)

    def region_nbytes(self, n_slots: int) -> int:
        """Device bytes of an ``alloc_region(n_slots)``, from shapes."""
        return self._nbytes // self.n_slots * n_slots

    def reinit(self) -> None:
        """Re-create the pooled cache, zeroed (crash recovery: the old
        buffers are assumed corrupt); slot bookkeeping stays."""
        self.caches = self._alloc_caches()

    def nbytes(self) -> int:
        """Device bytes of the pooled cache, from shapes (no device work)."""
        return self._nbytes


class PagedKVPool(KVSlotPool):
    """Block-paged KV pool (the reference's ``PagedKVPool``,
    cache_pool.py:185): one shared device pool of fixed-size blocks plus a
    host-side per-slot int32 block table. The slot free list and
    generations are inherited; what changes is the storage behind a slot:

    - ``caches`` leaves are (n_layers, 2, n_blocks, block_size, ...)
      instead of per-slot Tpad slabs;
    - slot ``s`` owns the rows ``tables()[s]`` names: entry ``j`` maps rows
      [j*block_size, (j+1)*block_size); unallocated entries hold 0, the
      all-zero SENTINEL block (block ids are 1-based);
    - admission allocates ``ceil((prompt + max_new) / block_size)`` blocks
      instead of a whole slab;
    - blocks are reference-counted, so a cached prefix is byte-shared by
      aliasing its ids into another slot's table (:meth:`alias_into_slot`,
      :meth:`alloc_blocks`, :meth:`incref`, :meth:`decref` serve the
      prefix cache); a block returns to the free heap when its count
      reaches zero.

    Block ids are handed out lowest-id-first (a heap), so tables are
    deterministic. ``block_size`` is a power of two dividing Tpad; by
    default the pool holds what the slab pool holds (``n_slots * Tpad /
    block_size`` blocks) plus the sentinel, and ``n_blocks`` (sentinel
    included, at least 2) sizes it otherwise: fewer blocks oversubscribe
    the slots, and ``can_admit`` then gates admission. ``version`` counts
    table changes, so the device copy of the tables in :meth:`operand` is
    uploaded again exactly when they changed.
    """

    is_paged = True

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_total: int,
                 device: torch.device, *, block_size: int = 8,
                 n_blocks: int | None = None, tp_mesh: Mesh | None = None):
        bs = int(block_size)
        if bs < 1 or bs & (bs - 1):
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        self.block_size = bs
        self._requested_blocks = n_blocks
        super().__init__(cfg, n_slots, max_total, device, tp_mesh=tp_mesh)
        self._tables = np.zeros((n_slots, self.blocks_per_slot),
                                np.int32)  # guarded-by: _lock
        self._refs = np.zeros((self.n_blocks,), np.int32)  # guarded-by: _lock
        self._refs[0] = 1  # the sentinel is pinned for good
        self._free_blocks = list(range(1, self.n_blocks))  # heap; guarded-by: _lock
        self.version = 0  # guarded-by: _lock
        # the device copy of the tables and the version it mirrors (engine
        # thread only)
        self._dtables = None
        self._dversion = -1

    def _alloc_caches(self):
        if self.block_size > self.tpad or self.tpad % self.block_size:
            raise ValueError(
                f"block_size {self.block_size} does not divide the slab row "
                f"count Tpad={self.tpad}")
        self.blocks_per_slot = self.tpad // self.block_size
        self.n_blocks = (
            self._requested_blocks if self._requested_blocks is not None
            else self.n_slots * self.blocks_per_slot + 1)
        if self.n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (sentinel + one allocatable "
                f"block), got {self.n_blocks}")
        # an empty (batch 0) cache on the real devices names each leaf's
        # dtype, width and device
        return kv_map(
            lambda s: torch.zeros(
                (s.shape[0], s.shape[1], self.n_blocks, self.block_size,
                 s.shape[4]), dtype=s.dtype, device=s.device),
            self._init_caches(0, self._max_total, self._device))

    # -- block accounting ------------------------------------------------------

    def block_nbytes(self) -> int:
        """Bytes of ONE block across all cache leaves."""
        return self._nbytes // self.n_blocks

    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` rows."""
        return -(-max(0, int(n_tokens)) // self.block_size)

    @property
    def n_free_blocks(self) -> int:
        with self._lock:
            return len(self._free_blocks)

    @property
    def n_blocks_in_use(self) -> int:
        """Allocated blocks (sentinel excluded)."""
        with self._lock:
            return self.n_blocks - 1 - len(self._free_blocks)

    def can_admit(self, n_tokens: int) -> bool:
        """Whether the free heap covers a fresh ``n_tokens``-row
        allocation (the paged admission gate)."""
        return self.blocks_needed(n_tokens) <= self.n_free_blocks

    def table(self, slot: int) -> np.ndarray:
        """Snapshot of one slot's table row."""
        with self._lock:
            return self._tables[slot].copy()

    def tables(self) -> np.ndarray:
        """Snapshot of the whole (n_slots, blocks_per_slot) table."""
        with self._lock:
            return self._tables.copy()

    def slot_blocks(self, slot: int) -> list[int]:
        """The non-sentinel block ids ``slot``'s table names, in order."""
        with self._lock:
            return [int(b) for b in self._tables[slot] if b]

    def refcount(self, block_id: int) -> int:
        with self._lock:
            return int(self._refs[block_id])

    # -- the engine's view -------------------------------------------------------

    def operand(self):
        """The blocks with a device copy of the tables, uploaded again
        (pinned, non-blocking) whenever the tables changed since the last
        upload: a stale copy would send a retired slot's dead rows into
        blocks handed to someone else. The engine asks for it between
        horizons, never inside one."""
        with self._lock:
            version = self.version
            tables = self._tables.copy() if version != self._dversion else None
        if tables is not None:
            if self.tp_mesh is None:
                self._dtables = upload(tables, self._device)
            else:
                # one copy a rank device, uploaded together
                on = {d: upload(tables, d)
                      for d in dict.fromkeys(self.tp_mesh.devices)}
                self._dtables = Shards(on[d] for d in self.tp_mesh.devices)
            self._dversion = version
        return {"blocks": self.caches, "tables": self._dtables}

    def table_row(self, slot: int):
        """The device copy of ``slot``'s table row (per rank under TP)."""
        return smap(lambda t: t[slot], self.operand()["tables"])

    def prefill_slab(self, slot: int):
        """A fresh zeroed batch-1 scratch slab of Tpad rows for ``slot``'s
        prompt."""
        return self._init_caches(1, self._max_total, self._device)

    def land(self, slot: int, slab, start: int = 0) -> None:
        """Scatter a prefilled scratch slab's rows ``start``.. into the
        blocks ``slot``'s table row names from entry ``start //
        block_size`` on: zeros past the prompt included, so a reused block
        keeps no stale row; pad rows past the slot's coverage land in the
        sentinel, which is re-zeroed. ``start`` (block-aligned) skips the
        entries a prefix hit aliased: a slot writes only its own blocks."""
        if start % self.block_size:
            raise ValueError(f"start {start} is not a multiple of the block "
                             f"size {self.block_size}")
        j = start // self.block_size
        paged_scatter(self.caches,
                      smap(lambda t: t[slot:slot + 1, j:],
                           self.operand()["tables"]),
                      kv_map(lambda x: x[:, :, :, start:], slab))

    def write_slab(self, slot: int, slab, start: int = 0) -> None:
        """Scatter a batch-1 scratch slab into ``slot``'s blocks (as
        :meth:`land`)."""
        self.land(slot, slab, start)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy block ``src``'s rows into block ``dst``."""
        paged_block_copy(self.caches, src, dst)

    def zero_blocks(self, block_ids) -> None:
        """Zero the named blocks (sentinel entries skipped) in one indexed
        fill a leaf; the index goes up pinned and non-blocking."""
        ids = np.asarray([b for b in block_ids if b], np.int64)
        if ids.size:
            idx = upload(ids, self._device)
            kv_map(lambda x: x.index_fill_(2, idx.to(x.device), 0),
                   self.caches)

    # -- allocation / sharing --------------------------------------------------

    def _pop_block_unlocked(self) -> int:  # lint: holds _lock
        bid = heapq.heappop(self._free_blocks)
        self._refs[bid] = 1
        return bid

    def _drop_unlocked(self, bid: int) -> None:  # lint: holds _lock
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            heapq.heappush(self._free_blocks, int(bid))

    def alloc_slot_blocks(self, slot: int, n_tokens: int,
                          start: int = 0) -> list[int]:
        """Allocate private blocks for table entries ``[start,
        blocks_needed(n_tokens))`` of ``slot``, lowest id first (``start`` >
        0: the first entries were aliased and stay). Raises
        ``RuntimeError`` when the heap cannot cover it (admission gates on
        :meth:`can_admit`)."""
        k = self.blocks_needed(n_tokens)
        if k > self.blocks_per_slot:
            raise RuntimeError(f"{n_tokens} rows need {k} blocks, slot "
                               f"tables hold {self.blocks_per_slot}")
        with self._lock:
            note_access("pool.blockmap", write=True)
            if max(0, k - start) > len(self._free_blocks):
                raise RuntimeError("no free KV blocks")
            out = []
            for j in range(start, k):
                bid = self._pop_block_unlocked()
                self._tables[slot, j] = bid
                out.append(bid)
            self.version += 1
            return out

    def alias_into_slot(self, slot: int, block_ids, start: int = 0) -> None:
        """Byte-share existing blocks into ``slot``'s table entries
        ``[start, start + len(block_ids))``: a refcount bump, no device
        work."""
        with self._lock:
            note_access("pool.blockmap", write=True)
            for j, bid in enumerate(block_ids):
                self._refs[bid] += 1
                self._tables[slot, start + j] = bid
            self.version += 1

    def alloc_blocks(self, k: int) -> list[int]:
        """Allocate ``k`` blocks owned by no slot (refcount 1); freed by
        :meth:`decref`."""
        with self._lock:
            note_access("pool.blockmap", write=True)
            if k > len(self._free_blocks):
                raise RuntimeError("no free KV blocks")
            return [self._pop_block_unlocked() for _ in range(k)]

    def incref(self, block_ids) -> None:
        with self._lock:
            note_access("pool.blockmap", write=True)
            for bid in block_ids:
                self._refs[bid] += 1

    def decref(self, block_ids) -> None:
        """Drop one reference per id; blocks reaching zero return to the
        free heap."""
        with self._lock:
            note_access("pool.blockmap", write=True)
            for bid in block_ids:
                self._drop_unlocked(bid)

    def release(self, slot: int) -> None:
        """Slot release plus block teardown: every non-sentinel entry drops
        one reference (shared blocks survive under their other holders) and
        the table row resets to the sentinel."""
        super().release(slot)
        with self._lock:
            note_access("pool.blockmap", write=True)
            for bid in self._tables[slot]:
                if bid:
                    self._drop_unlocked(bid)
            self._tables[slot] = 0
            self.version += 1

    def reinit(self) -> None:
        """Re-create the block pool zeroed and reset ALL paging state
        (tables, refcounts, free heap); slot bookkeeping stays."""
        super().reinit()
        with self._lock:
            self._tables[:] = 0
            self._refs[:] = 0
            self._refs[0] = 1
            self._free_blocks = list(range(1, self.n_blocks))
            self.version += 1

