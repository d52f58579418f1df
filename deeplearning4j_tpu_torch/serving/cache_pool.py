"""KV-slot pool: slot recycling over ONE pre-allocated decode cache (port of
``deeplearning4j_tpu/serving/cache_pool.py`` ``KVSlotPool``, slab layout).

The batch axis of ``init_caches`` IS the slot pool: the buffer
(n_layers, 2, n_slots, Tpad, Hkv*K) is allocated once on the engine's device
and never re-allocated. Admitting a request rewrites that slot's whole slab
(zeroed, then prefilled), so no stale rows of the previous occupant survive;
releasing a slot is free-list bookkeeping only. Slots are handed out
lowest-index-first so admission order is deterministic; a per-slot
generation, bumped on acquire, lets the pipelined engine tell a token block
of a previous occupant from the current one's.
"""

from __future__ import annotations

import heapq
import threading

import torch

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig,
    _decode_builder,
)


class KVSlotPool:
    """Free-list of decode-cache slots over one device allocation."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_total: int,
                 device: torch.device):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        _, init_caches, _, _ = _decode_builder(cfg)
        self.n_slots = n_slots
        self.caches = init_caches(n_slots, max_total, device)
        self.tpad = self.caches.shape[3]
        # acquire/release run on the engine thread while the gauges read
        # from HTTP threads: the free list moves under the lock
        self._lock = threading.Lock()
        self._free = list(range(n_slots))  # a heap; guarded-by: _lock
        self._in_use: set[int] = set()  # guarded-by: _lock
        self._gen = [0] * n_slots  # guarded-by: _lock

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

    def slab(self, slot: int) -> torch.Tensor:
        """The (n_layers, 2, 1, Tpad, Hkv*K) view of one slot's rows;
        writes through it land in the pool."""
        return self.caches[:, :, slot:slot + 1]
