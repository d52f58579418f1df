"""Disk-backed FIFO queue.

≙ reference util/DiskBasedQueue.java:187 — spill queue elements to disk so
unbounded producers don't exhaust memory (used for worker update spill,
LocalFileUpdateSaver-style).  JSON-serializable payloads only.

The port's copy of ``deeplearning4j_tpu/utils/disk_queue.py``.
"""

from __future__ import annotations

import json
import tempfile
import threading
from pathlib import Path


class DiskBasedQueue:
    def __init__(self, directory: str | Path | None = None):
        self.dir = Path(directory) if directory else Path(tempfile.mkdtemp(prefix="dl4jq_"))
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._head = 0
        self._tail = 0
        # resume from existing files
        existing = sorted(int(p.stem) for p in self.dir.glob("*.json"))
        if existing:
            self._head = existing[0]
            self._tail = existing[-1] + 1

    def add(self, item) -> None:
        with self._lock:
            (self.dir / f"{self._tail}.json").write_text(json.dumps(item))
            self._tail += 1

    def poll(self):
        with self._lock:
            if self._head >= self._tail:
                return None
            p = self.dir / f"{self._head}.json"
            item = json.loads(p.read_text())
            p.unlink()
            self._head += 1
            return item

    def peek(self):
        with self._lock:
            if self._head >= self._tail:
                return None
            return json.loads((self.dir / f"{self._head}.json").read_text())

    def __len__(self) -> int:
        with self._lock:
            return self._tail - self._head

    def is_empty(self) -> bool:
        return len(self) == 0
