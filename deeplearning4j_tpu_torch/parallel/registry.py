"""Network service registry: discovery with no shared filesystem (a copy
of the reference's ``deeplearning4j_tpu/parallel/registry.py``, stdlib
only: it imports no ``torch``).

The reference's ZooKeeper role (a job's configuration at a well-known key,
workers as ephemeral entries kept alive by heartbeats) over a small HTTP
key-value server:

- :class:`RegistryServer`: in-memory KV over HTTP (stdlib
  ``ThreadingHTTPServer``): PUT/GET/DELETE ``/kv/<key>``, prefix listing
  ``/ls/<prefix>``, TTL-based ephemeral entries, create-if-absent and
  owner-checked renew and delete (the primitives of the lease lock);
- :class:`NetworkRegistry`: the client, with the interface of
  ``parallel/cluster.FileRegistry`` (``register_master``,
  ``retrieve_master``, ``register_worker``, ``list_workers``) and a
  lease lock (:class:`RegistryLock`).

The wire format is the reference's byte for byte (JSON bodies
``{"value", "ttl", "if_absent", "if_owner"}``, 409 for a lost race, 404
for a missing key), so a client of either package talks to a server of
either. A multi-process training run finds its ``torch.distributed``
coordinator through it: process 0 publishes the address, the others
retrieve it.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import ThreadingHTTPServer

from deeplearning4j_tpu_torch.utils.httpjson import (
    QuietHandler,
    read_json_body,
    send_json,
)


@dataclass
class _Entry:
    value: object
    ttl: float | None  # seconds; None = persistent
    touched: float = field(default_factory=time.monotonic)


class RegistryServer:
    """In-memory HTTP KV with TTL ephemerals (the coordinator runs one).

    Endpoints (all JSON):
      PUT    /kv/<key>      body {"value": ..., "ttl": seconds|null}
      GET    /kv/<key>      -> {"value": ...} | 404
      DELETE /kv/<key>
      GET    /ls/<prefix>   -> {"keys": [...]} (prefix match, sorted)
    A PUT on an existing key refreshes its TTL clock — clients keep
    ephemeral entries alive by re-PUTting them (≙ ZK session heartbeat).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 sweep_every: float = 1.0):
        self._store: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        server = self

        class Handler(QuietHandler):
            def _send(self, code: int, payload=None):
                send_json(self, code, payload)

            def do_PUT(self):  # noqa: N802
                if not self.path.startswith("/kv/"):
                    return self._send(404)
                # expired leases must not block an if_absent create
                server._sweep()
                key = self.path[len("/kv/"):]
                req = read_json_body(self)
                if req is None:
                    return self._send(400, {"error": "bad json"})
                with server._lock:
                    if req.get("if_absent") and key in server._store:
                        # atomic create-if-absent under the store lock —
                        # the primitive the lease lock builds on
                        return self._send(409, {"error": "exists"})
                    if "if_owner" in req:
                        # atomic renew: only the current holder may
                        # refresh; an expired (absent) or stolen entry
                        # means the lease was lost
                        cur = server._store.get(key)
                        if cur is None or cur.value != req["if_owner"]:
                            return self._send(409, {"error": "not owner"})
                        # a renew that omits "value" or "ttl" keeps the
                        # held one — overwriting value with null would
                        # orphan the lock (the real holder's later
                        # renews would 409 against owner None), and
                        # overwriting ttl with null would silently turn
                        # the lease into a never-expiring lock
                        value = req.get("value", cur.value)
                        ttl = req.get("ttl", cur.ttl)
                    else:
                        value = req.get("value")
                        ttl = req.get("ttl")
                    server._store[key] = _Entry(value, ttl)
                self._send(200)

            do_POST = do_PUT  # tolerate POST for the same write semantics

            def do_GET(self):  # noqa: N802
                server._sweep()
                if self.path.startswith("/kv/"):
                    key = self.path[len("/kv/"):]
                    with server._lock:
                        e = server._store.get(key)
                    if e is None:
                        return self._send(404)
                    return self._send(200, {"value": e.value})
                if self.path.startswith("/ls/"):
                    prefix = self.path[len("/ls/"):]
                    with server._lock:
                        keys = sorted(
                            k for k in server._store if k.startswith(prefix)
                        )
                    return self._send(200, {"keys": keys})
                self._send(404)

            def do_DELETE(self):  # noqa: N802
                if not self.path.startswith("/kv/"):
                    return self._send(404)
                path = self.path[len("/kv/"):]
                key, _, query = path.partition("?")
                owner = None
                if query.startswith("owner="):
                    owner = urllib.parse.unquote(query[len("owner="):])
                server._sweep()
                with server._lock:
                    cur = server._store.get(key)
                    if cur is None:
                        return self._send(404)
                    if owner is not None and cur.value != owner:
                        # compare-and-delete: a holder whose lease
                        # expired must not destroy the new holder's lock
                        return self._send(409, {"error": "not owner"})
                    del server._store[key]
                self._send(200)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._sweep_every = sweep_every
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        # background sweeper: expired ephemerals disappear even on an
        # idle registry (requests additionally sweep inline so reads
        # never observe a stale entry)
        self._sweeper = threading.Thread(target=self._sweep_loop, daemon=True)

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self._sweep_every):
            self._sweep()

    def _sweep(self) -> None:
        now = time.monotonic()
        with self._lock:
            dead = [
                k for k, e in self._store.items()
                if e.ttl is not None and now - e.touched >= e.ttl
            ]
            for k in dead:
                del self._store[k]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> str:
        self._thread.start()
        self._sweeper.start()
        return self.address

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()


class NetworkRegistry:
    """FileRegistry-compatible discovery client over a RegistryServer.

    The only shared state between processes is the registry address: no
    shared filesystem.
    """

    def __init__(self, address: str, job_id: str,
                 worker_ttl: float | None = 30.0):
        self.address = address
        self.job_id = job_id
        self.worker_ttl = worker_ttl

    # -- HTTP plumbing ------------------------------------------------------
    def _url(self, path: str) -> str:
        return f"http://{self.address}/{path}"

    def _put(self, key: str, value, ttl: float | None = None) -> None:
        data = json.dumps({"value": value, "ttl": ttl}).encode()
        req = urllib.request.Request(
            self._url(f"kv/{key}"), data=data, method="PUT",
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=10).read()

    def _get(self, key: str):
        try:
            with urllib.request.urlopen(
                self._url(f"kv/{key}"), timeout=10
            ) as r:
                return json.loads(r.read())["value"]
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _ls(self, prefix: str) -> list[str]:
        with urllib.request.urlopen(
            self._url(f"ls/{prefix}"), timeout=10
        ) as r:
            return json.loads(r.read())["keys"]

    # -- FileRegistry interface --------------------------------------------
    def register_master(self, config: dict) -> None:
        """≙ ZooKeeperConfigurationRegister.register (config at a
        well-known path)."""
        self._put(f"{self.job_id}/master", config)

    def retrieve_master(self, timeout: float = 30.0) -> dict:
        """≙ ZooKeeperConfigurationRetriever.retrieve: poll until the
        master's config appears."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            cfg = self._get(f"{self.job_id}/master")
            if cfg is not None:
                return cfg
            time.sleep(0.2)
        raise TimeoutError(
            f"no master registered for job {self.job_id!r} at {self.address}"
        )

    def register_worker(self, worker_id: str, info: dict | None = None) -> None:
        """Ephemeral registration — call again within ``worker_ttl`` to
        stay listed (≙ ZK ephemeral node + session heartbeat)."""
        self._put(
            f"{self.job_id}/worker/{worker_id}", info or {},
            ttl=self.worker_ttl,
        )

    def list_workers(self) -> list[str]:
        prefix = f"{self.job_id}/worker/"
        return sorted(k[len(prefix):] for k in self._ls(prefix))

    # -- distributed lock ---------------------------------------------------
    def _put_if_absent(self, key: str, value, ttl: float | None) -> bool:
        data = json.dumps(
            {"value": value, "ttl": ttl, "if_absent": True}
        ).encode()
        req = urllib.request.Request(
            self._url(f"kv/{key}"), data=data, method="PUT",
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=10).read()
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False
            raise

    def lock(self, name: str, owner: str, lease: float = 30.0) -> "RegistryLock":
        """A lease-based distributed mutex (create a well-known key to
        take the lock, delete it to release). The lease TTL means a crashed
        holder releases automatically."""
        return RegistryLock(self, f"{self.job_id}/lock/{name}", owner, lease)


class LeaseLostError(RuntimeError):
    """The lock lease expired (or was taken over) out from under the
    holder; the critical section is no longer protected."""


class RegistryLock:
    """Acquire/release a named lease lock on the registry (create-if-absent
    with a TTL; refresh with :meth:`renew` for long critical sections).
    Release and renew are owner-checked on the server (compare-and-delete
    / compare-and-swap), so an expired holder cannot destroy or steal the
    lock from whoever acquired it next."""

    def __init__(self, reg: NetworkRegistry, key: str, owner: str,
                 lease: float):
        self._reg = reg
        self._key = key
        self.owner = owner
        self.lease = lease

    def acquire(self, timeout: float = 30.0, poll: float = 0.1) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if self._reg._put_if_absent(self._key, self.owner, self.lease):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll)

    def renew(self) -> None:
        """Refresh the lease clock. Raises :class:`LeaseLostError` when
        this holder's lease already expired (or was taken over) — the
        caller must stop treating the critical section as protected."""
        data = json.dumps({
            "value": self.owner, "ttl": self.lease, "if_owner": self.owner,
        }).encode()
        req = urllib.request.Request(
            self._reg._url(f"kv/{self._key}"), data=data, method="PUT",
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except urllib.error.HTTPError as e:
            if e.code == 409:
                raise LeaseLostError(
                    f"lease on {self._key} lost by {self.owner}"
                ) from None
            raise

    def release(self) -> None:
        """Owner-checked release (compare-and-delete): if the lease
        already expired and someone else holds the lock now, this is a
        no-op — an expired holder must never destroy the new holder's
        entry."""
        owner_q = urllib.parse.quote(str(self.owner), safe="")
        req = urllib.request.Request(
            self._reg._url(f"kv/{self._key}?owner={owner_q}"),
            method="DELETE",
        )
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except urllib.error.HTTPError as e:
            if e.code not in (404, 409):
                raise

    def __enter__(self):
        if not self.acquire():
            raise TimeoutError(f"could not acquire lock {self._key}")
        return self

    def __exit__(self, *exc):
        self.release()
