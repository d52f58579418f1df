"""Seeded in-process network chaos proxy for fleet tests (the port's own
copy of ``deeplearning4j_tpu/serving/netfaults.py``, stdlib only).

``serving/faults.py`` injects faults INSIDE an engine at its host-side
boundaries; this module injects them BETWEEN fleet processes, on the
wire, where the resilient-RPC layer (deadlines, hedging, breakers) and
the KVSG frame validation are the code under test. A
:class:`ChaosProxy` listens on an ephemeral local port and forwards
TCP byte streams to a real target address, corrupting them per plan:

- ``refuse`` — accept then immediately close (connection refused-ish;
  drives breaker opens and hedge wins).
- ``drop`` — read the client's first chunk, forward NOTHING, close
  both sides (a request that vanishes; the client sees a reset/short
  read bounded by its socket timeout).
- ``truncate`` — forward only half of the first server→client chunk,
  then close: a mid-frame truncation. KVSG receivers must 400 this,
  HTTP clients must see a clean error — never a hang.
- ``corrupt`` — flip bytes in the first client→server chunk (corrupt
  header bytes on a KVSG push → wire validation declines with 400).
- ``latency`` — sleep ``latency_s`` before forwarding each chunk
  (drives the p99 hedge trigger deterministically).

Two injection modes, mirroring :class:`~.faults.FaultInjector`:
scripted ``plan(kind, at=k)`` fires on the k-th accepted connection
(1-based connection index, 0-based ``at``), and seeded per-connection
Bernoulli rates drawn from one ``random.Random(seed)`` in a fixed
order per connection — a given seed replays the same chaos.

``set_partition(True)`` refuses every new connection: an asymmetric
partition is two proxies with only one partitioned (A can reach B but
not vice versa). Partitions are hang-free by construction — the victim
sees connect/read errors immediately, and anything already connected
is bounded by its deadline-derived socket timeout.
"""

from __future__ import annotations

import random
import socket
import threading
import time

_KINDS = ("refuse", "drop", "truncate", "corrupt", "latency")
_CHUNK = 65536


class _Planned:
    __slots__ = ("kind", "at", "times")

    def __init__(self, kind: str, at: int, times: int):
        self.kind = kind
        self.at = at
        self.times = times


class ChaosProxy:
    """TCP forwarder to ``target=(host, port)`` with seeded faults.

    Point a fleet client at ``proxy.address`` instead of the real
    replica; per-connection faults follow the scripted plans first,
    then one seeded draw per kind in ``_KINDS`` order. Counters in
    ``self.counts`` record what actually fired.
    """

    def __init__(self, target: tuple[str, int], *, seed: int = 0,
                 latency_s: float = 0.05, latency_rate: float = 0.0,
                 drop_rate: float = 0.0, truncate_rate: float = 0.0,
                 corrupt_rate: float = 0.0, refuse_rate: float = 0.0):
        self.target = (str(target[0]), int(target[1]))
        self.latency_s = float(latency_s)
        self.rates = {
            "refuse": float(refuse_rate),
            "drop": float(drop_rate),
            "truncate": float(truncate_rate),
            "corrupt": float(corrupt_rate),
            "latency": float(latency_rate),
        }
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._plans: list[_Planned] = []
        self._partitioned = False
        self._stopping = False
        self.n_connections = 0
        self.counts = {k: 0 for k in _KINDS}
        self.counts["refused_partition"] = 0
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self.host = "127.0.0.1"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaos-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def plan(self, kind: str, at: int, *, times: int = 1) -> "ChaosProxy":
        """Script fault ``kind`` on the ``at``-th accepted connection
        (0-based, ``times`` consecutive). Returns self (chain)."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        with self._lock:
            self._plans.append(_Planned(kind, int(at), int(times)))
        return self

    def set_partition(self, on: bool) -> None:
        """Refuse all NEW connections while on — one direction of an
        asymmetric partition (run a proxy per direction for both)."""
        with self._lock:
            self._partitioned = bool(on)

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)

    # -- internals ---------------------------------------------------

    def _faults_for(self, conn_idx: int) -> list[str]:
        out = []
        with self._lock:
            partitioned = self._partitioned
            for p in self._plans:
                if p.at <= conn_idx < p.at + p.times:
                    out.append(p.kind)
        if partitioned:
            return ["__partition__"]
        # seeded draws happen in fixed kind order so one seed replays
        # the same per-connection pattern regardless of thread timing
        with self._rng_lock:
            for kind in _KINDS:
                if self.rates[kind] > 0.0 and \
                        self._rng.random() < self.rates[kind]:
                    out.append(kind)
        return out

    def _accept_loop(self) -> None:
        while True:
            try:
                client, _ = self._srv.accept()
            except OSError:
                return  # listener closed by stop()
            with self._lock:
                if self._stopping:
                    client.close()
                    return
                idx = self.n_connections
                self.n_connections += 1
            faults = self._faults_for(idx)
            if "__partition__" in faults:
                self.counts["refused_partition"] += 1
                client.close()
                continue
            if "refuse" in faults:
                self.counts["refuse"] += 1
                client.close()
                continue
            threading.Thread(
                target=self._serve_conn, args=(client, faults),
                name=f"chaos-conn-{idx}", daemon=True
            ).start()

    def _serve_conn(self, client: socket.socket, faults: list[str]) -> None:
        try:
            upstream = socket.create_connection(self.target, timeout=5.0)
        except OSError:
            client.close()
            return
        for s in (client, upstream):
            s.settimeout(30.0)  # backstop; tests bound waits themselves
        for kind in faults:
            if kind in self.counts and kind != "refuse":
                self.counts[kind] += 1
        fwd = threading.Thread(
            target=self._pump, args=(client, upstream, faults, True),
            daemon=True,
        )
        rev = threading.Thread(
            target=self._pump, args=(upstream, client, faults, False),
            daemon=True,
        )
        fwd.start()
        rev.start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              faults: list[str], client_to_server: bool) -> None:
        """Forward src→dst applying faults. ``drop``/``corrupt`` act on
        the first client→server chunk (the request/frame head);
        ``truncate`` acts on the first server→client chunk so the
        CLIENT sees a mid-frame cut. Any error tears down both sides —
        half-open connections are the hangs this suite exists to
        catch, so teardown is always bilateral."""
        first = True
        try:
            while True:
                try:
                    buf = src.recv(_CHUNK)
                except OSError:
                    break
                if not buf:
                    break
                if "latency" in faults:
                    time.sleep(self.latency_s)
                if first and client_to_server and "drop" in faults:
                    break  # swallow the request entirely
                if first and client_to_server and "corrupt" in faults:
                    b = bytearray(buf)
                    for i in range(0, len(b), max(1, len(b) // 16)):
                        b[i] ^= 0xFF
                    buf = bytes(b)
                if first and not client_to_server and "truncate" in faults:
                    try:
                        dst.sendall(buf[: max(1, len(buf) // 2)])
                    except OSError:
                        pass
                    break  # cut mid-frame
                try:
                    dst.sendall(buf)
                except OSError:
                    break
                first = False
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
