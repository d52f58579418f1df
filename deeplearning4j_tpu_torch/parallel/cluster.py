"""Host-side cluster coordination: worker registry, heartbeats, eviction,
the early-stopping blackboard and the REST status and control of a
trainer (a copy of the reference's ``deeplearning4j_tpu/parallel/
cluster.py``; stdlib only at import: no ``torch``).

- :class:`ClusterService`: workers heartbeat (``heartbeat``) and the
  master evicts those silent ``evict_after`` seconds (``evict_stale``);
  ``report_loss`` keeps the best loss and a patience counter and says when
  training should stop; ``start_rest_api`` serves ``GET
  /statetracker[/{workers,phase,minibatch,numbatchessofar,printmodel}]``
  and the control POSTs (``minibatch``, ``earlystop``, ``heartbeat``,
  ``phase``). On a non-loopback bind the POSTs need ``X-Auth-Token``; a
  generated secret goes to a 0600 file (only its first 8 characters are
  logged) that ``stop_rest_api`` unlinks.
- :class:`FileRegistry`: discovery through a shared directory, the
  interface of ``parallel/registry.NetworkRegistry``.
- :func:`initialize_distributed`: ``torch.distributed.init_process_group``
  over ``tcp://<coordinator>``, its backend chosen by a printed rule
  (:func:`distributed_backend`).
"""

from __future__ import annotations

import hmac
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any


@dataclass
class WorkerInfo:
    worker_id: str
    last_heartbeat: float = field(default_factory=time.time)
    meta: dict = field(default_factory=dict)


class ClusterService:
    """In-process blackboard (one per host; the master's is authoritative)."""

    def __init__(self, evict_after: float = 120.0):
        self.evict_after = evict_after
        self._workers: dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()
        self.phase = "init"
        self.minibatch = 0
        self.batches_so_far = 0
        # early-stopping blackboard (≙ BaseHazelCastStateTracker.java:51-77,562-577)
        self.best_loss = float("inf")
        self.patience = 5
        self.patience_counter = 0
        self.early_stop = False
        # human-readable model summary served at GET /statetracker/
        # printmodel (≙ StateTrackerDropWizardResource.printModel); the
        # trainer sets it
        self.model_description = ""
        # shared secret for control POSTs on non-loopback binds (set by
        # start_rest_api; None = no auth, loopback-only default)
        self.auth_token: str | None = None
        # path of the 0600 file holding a *generated* secret (None when
        # the operator supplied the token); unlinked by stop_rest_api
        self.auth_token_file: str | None = None
        self._server: ThreadingHTTPServer | None = None

    # -- worker registry / heartbeats -------------------------------------
    def heartbeat(self, worker_id: str, **meta) -> None:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                self._workers[worker_id] = WorkerInfo(worker_id, meta=meta)
            else:
                info.last_heartbeat = time.time()
                info.meta.update(meta)

    def evict_stale(self) -> list[str]:
        """≙ MasterActor's 1-min sweep evicting workers silent >=120 s."""
        now = time.time()
        evicted = []
        with self._lock:
            for wid, info in list(self._workers.items()):
                if now - info.last_heartbeat >= self.evict_after:
                    del self._workers[wid]
                    evicted.append(wid)
        return evicted

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    # -- early stopping ----------------------------------------------------
    def report_loss(self, loss: float) -> bool:
        """Update the blackboard; returns True when training should stop."""
        if loss < self.best_loss - 1e-12:
            self.best_loss = loss
            self.patience_counter = 0
        else:
            self.patience_counter += 1
            if self.patience_counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    # -- status ------------------------------------------------------------
    def status(self) -> dict[str, Any]:
        return {
            "phase": self.phase,
            "workers": self.workers(),
            "minibatch": self.minibatch,
            "numbatchessofar": self.batches_so_far,
            "bestloss": self.best_loss,
            "earlystop": self.early_stop,
        }

    # -- REST (≙ StateTrackerDropWizardResource) ---------------------------
    def start_rest_api(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        auth_token: str | None = None,
    ) -> int:
        """GET status + POST *control*, matching the reference resource
        (StateTrackerDropWizardResource.java:29-96: GET jobs/phase/
        minibatch/printmodel, POST minibatch). POSTs change live trainer
        behavior: the training loop reads ``minibatch`` each step and
        ``early_stop`` on its report cadence.

        ``host`` defaults to loopback for safety; multi-host
        deployments pass a routable interface (e.g. ``"0.0.0.0"``) so
        workers on other machines can reach the heartbeat/control
        endpoints.  On a non-loopback bind the control POSTs are
        network-writable, so they require a shared secret: pass
        ``auth_token`` (clients send it as the ``X-Auth-Token`` header)
        or one is generated and logged.  GETs stay open (read-only
        status)."""
        service = self
        loopback = host in ("127.0.0.1", "localhost", "::1")
        generated = auth_token is None and not loopback
        if generated:
            import secrets

            auth_token = secrets.token_hex(16)
        self.auth_token = auth_token

        from deeplearning4j_tpu_torch.utils.httpjson import (
            QuietHandler,
            read_json_body,
            send_json,
        )

        class Handler(QuietHandler):
            def _json(self, code, payload):
                send_json(self, code, payload)

            def do_GET(self):  # noqa: N802
                parts = self.path.strip("/").split("/")
                status = service.status()
                if len(parts) == 2 and parts[0] == "statetracker":
                    if parts[1] == "printmodel":
                        return self._json(
                            200, {"model": service.model_description}
                        )
                    payload = status.get(parts[1])
                    if payload is None:
                        return self._json(404, {"error": "unknown field"})
                else:
                    payload = status
                self._json(200, payload)

            def do_POST(self):  # noqa: N802
                if service.auth_token is not None and not hmac.compare_digest(
                    self.headers.get("X-Auth-Token") or "",
                    service.auth_token,
                ):
                    return self._json(401, {"error": "bad or missing "
                                            "X-Auth-Token"})
                parts = self.path.strip("/").split("/")
                req = read_json_body(self)
                if req is None:
                    return self._json(400, {"error": "bad json"})
                if len(parts) != 2 or parts[0] != "statetracker":
                    return self._json(404, {"error": "unknown endpoint"})
                if parts[1] == "minibatch":
                    # ≙ POST /statetracker/minibatch (runtime batch-size
                    # control). Bounded: a fat-fingered value must not
                    # be able to OOM-kill the live training process.
                    try:
                        value = int(req["value"])
                    except (KeyError, TypeError, ValueError):
                        return self._json(400, {"error": "need int value"})
                    if not 1 <= value <= 1_000_000:
                        return self._json(
                            400,
                            {"error": "minibatch out of range [1, 1e6]"},
                        )
                    service.minibatch = value
                    return self._json(200, {"minibatch": service.minibatch})
                if parts[1] == "earlystop":
                    service.early_stop = True
                    return self._json(200, {"earlystop": True})
                if parts[1] == "heartbeat":
                    # cross-process worker heartbeat (≙ WorkerActor
                    # .heartbeat:152-170 re-registering with the master)
                    wid = req.get("worker")
                    if not wid:
                        return self._json(400, {"error": "need worker"})
                    meta = req.get("meta", {})
                    if not isinstance(meta, dict):
                        return self._json(400, {"error": "meta must be "
                                                "an object"})
                    # drop keys that would collide with the positional
                    # worker_id parameter of heartbeat(**meta)
                    meta = {
                        k: v for k, v in meta.items() if k != "worker_id"
                    }
                    service.heartbeat(str(wid), **meta)
                    return self._json(200, {"workers": service.workers()})
                if parts[1] == "phase":
                    service.phase = str(req.get("value", service.phase))
                    return self._json(200, {"phase": service.phase})
                return self._json(404, {"error": "unknown endpoint"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        # any successful (re)start invalidates a previously generated
        # secret file — even when the new token is operator-supplied,
        # the old file must not outlive the token it held
        self._discard_token_file()
        if generated:
            # Persist + log the generated secret only AFTER the bind
            # succeeded: a failed bind must not orphan a secret file (the
            # caller never reaches stop_rest_api). Never write the full
            # secret to the log stream (CWE-532): logs are
            # routinely shipped with wider read access than the box.
            # Mode-0600 file + fingerprint prefix in the log lets an
            # operator correlate without gaining mutation rights.
            import logging
            import os
            import tempfile

            # mkstemp creates the file 0600 per POSIX — no chmod needed
            fd, token_path = tempfile.mkstemp(prefix="dl4j_tpu_token_")
            with os.fdopen(fd, "w") as f:
                f.write(auth_token)
            self.auth_token_file = token_path
            logging.getLogger(__name__).warning(
                "ClusterService REST bound to %s: control POSTs are "
                "network-writable; generated auth token %s… (full secret "
                "in %s, mode 0600 — clients send it as X-Auth-Token)",
                host, auth_token[:8], token_path,
            )
        thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        thread.start()
        return self._server.server_address[1]

    def _discard_token_file(self) -> None:
        """Unlink the generated-secret file (if any); one lifecycle site."""
        if self.auth_token_file is not None:
            import contextlib
            import os

            with contextlib.suppress(OSError):
                os.unlink(self.auth_token_file)
            self.auth_token_file = None

    def stop_rest_api(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server = None
        self._discard_token_file()


class FileRegistry:
    """Worker discovery via a shared directory.

    ≙ ZooKeeperConfigurationRegister semantics (serialized config at a
    well-known path, workers poll to retrieve) for environments without a
    ZK ensemble; the interface matches the ZooKeeper variant.
    """

    def __init__(self, root: str | Path, job_id: str):
        self.root = Path(root) / job_id
        self.root.mkdir(parents=True, exist_ok=True)

    def register_master(self, config: dict) -> None:
        (self.root / "master.json").write_text(json.dumps(config))

    def retrieve_master(self, timeout: float = 30.0) -> dict:
        deadline = time.time() + timeout
        path = self.root / "master.json"
        while time.time() < deadline:
            if path.exists():
                return json.loads(path.read_text())
            time.sleep(0.2)
        raise TimeoutError(f"no master registered under {self.root}")

    def register_worker(self, worker_id: str, info: dict | None = None) -> None:
        (self.root / f"worker_{worker_id}.json").write_text(json.dumps(info or {}))

    def list_workers(self) -> list[str]:
        return sorted(
            p.stem.removeprefix("worker_") for p in self.root.glob("worker_*.json")
        )


def distributed_backend(device=None, shared_card: bool = False
                        ) -> tuple[str, str]:
    """The collective backend of a multi-process run and why, a rule on
    the process's device (no fallback):

    - the CPU: ``gloo``;
    - a card named by the caller (``--device cuda:N``): ``gloo``. Every
      process of the run is given the same flags, so they share that card,
      and NCCL refuses two ranks on one card; gloo stages the CUDA
      buckets through the host, and the port counts those bytes
      (``parallel/mesh.all_reduce_mean``, ``parallel/mesh.collectives``);
    - no device named: each process owns the cards it sees (a launcher
      sets ``CUDA_VISIBLE_DEVICES`` per process): ``nccl`` when a card is
      visible, unless ``shared_card`` (two processes see one card, found
      by :func:`cards_shared` through the rendezvous store): then
      ``gloo``, for the same reason as a named card; ``gloo`` when no card
      is visible."""
    import torch

    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            return "gloo", "processes on the CPU"
        return "gloo", (f"processes share {dev}: NCCL takes one rank a card; "
                        f"gloo stages CUDA buckets through the host")
    if torch.cuda.is_available():
        if shared_card:
            return "gloo", ("processes share a card (the same device UUID "
                            "in the rendezvous store): NCCL takes one rank a "
                            "card; gloo stages CUDA tensors through the host")
        return "nccl", "each process owns its cards"
    return "gloo", "no card visible: processes on the CPU"


def card_ids() -> list[str]:
    """The visible cards' UUIDs (their PCI addresses where the build does
    not report one)."""
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        uuid = getattr(p, "uuid", None)
        out.append(str(uuid) if uuid is not None else
                   f"pci:{p.pci_domain_id}:{p.pci_bus_id}:{p.pci_device_id}")
    return out


def cards_shared(store, rank: int, world: int, ids) -> bool:
    """Whether any two of the ``world`` processes see one card: each
    publishes its cards' ``ids`` under its rank in the rendezvous
    ``store`` and reads every other's."""
    store.set(str(rank), json.dumps(list(ids)))
    seen: dict[str, int] = {}
    for r in range(world):
        for card in json.loads(store.get(str(r))):
            if seen.setdefault(card, r) != r:
                return True
    return False


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> str:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` on
    the store of torch's rendezvous at ``tcp://<coordinator>`` (``host:port``
    of process 0's store; with no coordinator, ``env://`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) with
    ``num_processes`` ranks, this one ``process_id``, on the backend
    :func:`distributed_backend` picks for ``device`` (with no device and
    a card visible, after the processes compare their cards through the
    store), which it prints. Returns the backend. After this call every
    process runs the same training program over a mesh whose data axis,
    model axis or both span the processes (``parallel/mesh.hybrid_mesh``)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        where = f"tcp://{coordinator}"
        kw = dict(rank=process_id, world_size=num_processes)
    else:
        where, kw = "env://", {}
    # torch's own rendezvous, as init_process_group makes it (its store
    # keys under "default_pg"): the store serves the card comparison first
    store, rank, world = next(dist.rendezvous(
        where, timeout=timedelta(minutes=10), **kw))
    shared = (device is None and torch.cuda.is_available()
              and cards_shared(dist.PrefixStore("dl4j_cards", store), rank,
                               world, card_ids()))
    backend, why = distributed_backend(device, shared)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank, world_size=world)
    print(f"torch.distributed: process {dist.get_rank()} of "
          f"{dist.get_world_size()} at {where}, backend {backend} ({why})",
          flush=True)
    return backend
