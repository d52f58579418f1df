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
"""

from __future__ import annotations

import heapq
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import upload
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _decode_builder,
    _kv_planes,
    kv_map,
    paged_slot_scatter,
)


def _nbytes(caches) -> int:
    return sum(x.numel() * x.element_size()
               for x in _kv_planes(caches) if x is not None)


class KVSlotPool:
    """Free-list of decode-cache slots over one device allocation.
    ``caches`` is a float tensor, or ``{"kv", "scale"}`` in int8 mode."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_total: int,
                 device: torch.device):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        _, self._init_caches, _, _ = _decode_builder(cfg)
        self._max_total = max_total
        self._device = device
        self.n_slots = n_slots
        # the slab geometry first (shapes only, on the meta device): the
        # paged pool carves the same rows into blocks
        self.tpad = _kv_planes(self._init_caches(
            1, max_total, torch.device("meta")))[0].shape[3]
        self.caches = self._alloc_caches()
        # acquire/release run on the engine thread while the gauges read
        # from HTTP threads: the free list moves under the lock
        self._lock = threading.Lock()
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

    def land(self, slot: int, slab) -> None:
        """Make a prefilled :meth:`prefill_slab` ``slot``'s rows: here they
        already are."""

    def reinit(self) -> None:
        """Re-create the pooled cache, zeroed; slot bookkeeping stays."""
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
    - blocks are reference-counted, so a cached prefix can be byte-shared by
      aliasing its ids into another slot's table (:meth:`alias_into_slot`,
      :meth:`alloc_blocks`, :meth:`incref`, :meth:`decref` serve the prefix
      cache of a later slice); a block returns to the free heap when its
      count reaches zero.

    Block ids are handed out lowest-id-first (a heap), so tables are
    deterministic. ``block_size`` is a power of two dividing Tpad; the pool
    holds what the slab pool holds (``n_slots * Tpad / block_size`` blocks)
    plus the sentinel. ``version`` counts table changes, so the device copy
    of the tables in :meth:`operand` is uploaded again exactly when they
    changed.
    """

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_total: int,
                 device: torch.device, *, block_size: int = 8):
        bs = int(block_size)
        if bs < 1 or bs & (bs - 1):
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        self.block_size = bs
        super().__init__(cfg, n_slots, max_total, device)
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
        self.n_blocks = self.n_slots * self.blocks_per_slot + 1
        return kv_map(
            lambda s: torch.zeros(
                (s.shape[0], s.shape[1], self.n_blocks, self.block_size,
                 s.shape[4]), dtype=s.dtype, device=self._device),
            self._init_caches(1, self._max_total, torch.device("meta")))

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
            self._dtables = upload(tables, self._device)
            self._dversion = version
        return {"blocks": self.caches, "tables": self._dtables}

    def prefill_slab(self, slot: int):
        """A fresh zeroed batch-1 scratch slab of Tpad rows for ``slot``'s
        prompt."""
        return self._init_caches(1, self._max_total, self._device)

    def land(self, slot: int, slab) -> None:
        """Scatter a prefilled scratch slab into the blocks ``slot``'s table
        row names: zeros past the prompt included, so a reused block keeps
        no stale row; pad rows past the slot's coverage land in the
        sentinel, which is re-zeroed."""
        paged_slot_scatter(self.caches, self.operand()["tables"][slot], slab)

    # -- allocation / sharing --------------------------------------------------

    def _pop_block_unlocked(self) -> int:
        bid = heapq.heappop(self._free_blocks)
        self._refs[bid] = 1
        return bid

    def _drop_unlocked(self, bid: int) -> None:
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
            for j, bid in enumerate(block_ids):
                self._refs[bid] += 1
                self._tables[slot, start + j] = bid
            self.version += 1

    def alloc_blocks(self, k: int) -> list[int]:
        """Allocate ``k`` blocks owned by no slot (refcount 1); freed by
        :meth:`decref`."""
        with self._lock:
            if k > len(self._free_blocks):
                raise RuntimeError("no free KV blocks")
            return [self._pop_block_unlocked() for _ in range(k)]

    def incref(self, block_ids) -> None:
        with self._lock:
            for bid in block_ids:
                self._refs[bid] += 1

    def decref(self, block_ids) -> None:
        """Drop one reference per id; blocks reaching zero return to the
        free heap."""
        with self._lock:
            for bid in block_ids:
                self._drop_unlocked(bid)

    def release(self, slot: int) -> None:
        """Slot release plus block teardown: every non-sentinel entry drops
        one reference (shared blocks survive under their other holders) and
        the table row resets to the sentinel."""
        super().release(slot)
        with self._lock:
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

