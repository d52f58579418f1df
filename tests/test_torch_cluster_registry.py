"""The port's network registry, lease lock, cluster service and its REST
status and control (``parallel/registry.py``, ``parallel/cluster.py``),
held to the reference's cases (``tests/test_cluster_registry.py``, all but
the t-SNE page) and to the reference's modules themselves: a port client
against a reference server and the other way round, and the port's
``/statetracker`` JSON against the reference service's after the same
calls.
"""

import json
import logging
import os
import stat
import threading
import time
import urllib.error
import urllib.request

import pytest

from deeplearning4j_tpu.parallel import cluster as jcluster
from deeplearning4j_tpu.parallel import registry as jregistry
from deeplearning4j_tpu_torch.parallel import cluster as pcluster
from deeplearning4j_tpu_torch.parallel import registry as pregistry


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture
def server():
    srv = pregistry.RegistryServer()
    addr = srv.start()
    yield addr
    srv.stop()


def test_network_registry_master_discovery_and_ephemeral_workers(server):
    master = pregistry.NetworkRegistry(server, "job1", worker_ttl=0.5)
    worker = pregistry.NetworkRegistry(server, "job1", worker_ttl=0.5)
    got = {}

    def retrieve():
        got["cfg"] = worker.retrieve_master(timeout=10.0)

    t = threading.Thread(target=retrieve)
    t.start()
    time.sleep(0.3)
    master.register_master({"coordinator": "10.0.0.1:1234"})
    t.join(timeout=10)
    assert got["cfg"] == {"coordinator": "10.0.0.1:1234"}
    worker.register_worker("w0", {"devices": 4})
    worker.register_worker("w1")
    assert master.list_workers() == ["w0", "w1"]
    time.sleep(0.8)  # past the TTL, no re-registration
    assert master.list_workers() == []
    other = pregistry.NetworkRegistry(server, "job2")
    other.register_worker("x")
    assert master.list_workers() == []
    assert other.list_workers() == ["x"]


def test_registry_lock_mutual_exclusion_and_lease_expiry(server):
    def lock(name, owner, lease=30.0):
        return pregistry.NetworkRegistry(server, "job").lock(
            name, owner=owner, lease=lease)

    a, b = lock("ckpt", "a"), lock("ckpt", "b")
    assert a.acquire(timeout=1.0)
    assert not b.acquire(timeout=0.4)
    a.release()
    assert b.acquire(timeout=1.0)
    b.release()
    crash = lock("ckpt", "crash", lease=0.4)
    assert crash.acquire(timeout=1.0)
    assert b.acquire(timeout=5.0)  # waits out the dead lease
    b.release()
    with lock("other", "cm") as lk:
        assert lk.owner == "cm"
    stale = lock("own", "stale", lease=0.3)
    assert stale.acquire(timeout=1.0)
    time.sleep(0.5)
    fresh = lock("own", "fresh")
    assert fresh.acquire(timeout=2.0)
    stale.release()  # compare-and-delete: a no-op
    with pytest.raises(pregistry.LeaseLostError):
        stale.renew()
    assert not lock("own", "third").acquire(timeout=0.4)
    fresh.renew()
    fresh.release()
    # a raw renew without "value" keeps the held owner
    holder = lock("raw", "h")
    assert holder.acquire(timeout=1.0)
    req = urllib.request.Request(
        f"http://{server}/kv/job/lock/raw",
        data=json.dumps({"if_owner": "h", "ttl": 30.0}).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5).read()
    holder.renew()
    holder.release()


def test_statetracker_rest_auth_token():
    svc = pcluster.ClusterService()
    svc.minibatch = 32
    port = svc.start_rest_api(0, auth_token="sekrit")
    base = f"http://127.0.0.1:{port}/statetracker"
    try:
        assert _get(f"{base}/minibatch") == 32
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/minibatch", {"value": 64})
        assert e.value.code == 401
        assert svc.minibatch == 32
        assert _post(f"{base}/minibatch", {"value": 64},
                     {"X-Auth-Token": "sekrit"}) == {"minibatch": 64}
        assert svc.minibatch == 64
    finally:
        svc.stop_rest_api()


def test_statetracker_generated_token_not_logged(caplog):
    svc = pcluster.ClusterService()
    with caplog.at_level(logging.WARNING, logger=pcluster.__name__):
        svc.start_rest_api(0, host="0.0.0.0")
    try:
        token = svc.auth_token
        assert token is not None and len(token) == 32
        assert token not in caplog.text
        assert token[:8] in caplog.text
        path = svc.auth_token_file
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        with open(path) as f:
            assert f.read() == token
    finally:
        svc.stop_rest_api()
    assert svc.auth_token_file is None and not os.path.exists(path)


def test_statetracker_rest_post_control():
    svc = pcluster.ClusterService()
    svc.model_description = "transformer d_model=16"
    svc.minibatch = 32
    port = svc.start_rest_api(0)
    base = f"http://127.0.0.1:{port}/statetracker"
    try:
        assert _get(f"{base}/minibatch") == 32
        assert _get(f"{base}/phase") == "init"
        assert _get(base)["numbatchessofar"] == 0
        assert "transformer" in _get(f"{base}/printmodel")["model"]
        assert _post(f"{base}/minibatch", {"value": 64}) == {"minibatch": 64}
        assert svc.minibatch == 64
        for bad in ({"value": 0}, {"value": "x"}, {}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/minibatch", bad)
            assert e.value.code == 400
        _post(f"{base}/phase", {"value": "finetune"})
        assert svc.phase == "finetune"
        assert not svc.report_loss(1.0)
        _post(f"{base}/earlystop", {})
        assert svc.report_loss(0.5) is True
        _post(f"{base}/heartbeat", {"worker": "w9", "meta": {"step": 3}})
        assert svc.workers() == ["w9"]
        for bad in ({"worker": "w9", "meta": [1, 2]}, {"meta": {"step": 1}}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/heartbeat", bad)
            assert e.value.code == 400
        _post(f"{base}/heartbeat",
              {"worker": "w9", "meta": {"worker_id": "evil", "step": 4}})
        assert svc.workers() == ["w9"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/nosuchfield")
        assert e.value.code == 404
    finally:
        svc.stop_rest_api()


def test_heartbeat_eviction_and_patience():
    svc = pcluster.ClusterService(evict_after=0.3)
    svc.heartbeat("a", step=1)
    svc.heartbeat("b")
    time.sleep(0.2)
    svc.heartbeat("a", step=2)  # a stays fresh
    time.sleep(0.15)
    assert svc.evict_stale() == ["b"]
    assert svc.workers() == ["a"]
    assert svc._workers["a"].meta == {"step": 2}
    svc.patience = 2
    assert [svc.report_loss(x) for x in (3.0, 2.0, 2.5, 2.0)] == [
        False, False, False, True]
    assert svc.status()["bestloss"] == 2.0 and svc.status()["earlystop"]


def test_file_registry(tmp_path):
    reg = pcluster.FileRegistry(tmp_path, "job")
    with pytest.raises(TimeoutError):
        reg.retrieve_master(timeout=0.3)
    reg.register_master({"coordinator": "h:1"})
    other = pcluster.FileRegistry(tmp_path, "job")
    assert other.retrieve_master(timeout=1.0) == {"coordinator": "h:1"}
    reg.register_worker("1", {"devices": 2})
    other.register_worker("0")
    assert reg.list_workers() == ["0", "1"]
    # the reference's registry reads the port's directory, and back
    ref = jcluster.FileRegistry(tmp_path, "job")
    assert ref.retrieve_master(timeout=1.0) == {"coordinator": "h:1"}
    assert ref.list_workers() == ["0", "1"]


@pytest.mark.parametrize("server_pkg,client_pkg", [
    (jregistry, pregistry), (pregistry, jregistry)],
    ids=["port-client-reference-server", "reference-client-port-server"])
def test_registry_wire_both_ways(server_pkg, client_pkg):
    """Discovery, ephemeral workers and the lease lock across the
    packages: the wire formats are the same."""
    srv = server_pkg.RegistryServer()
    addr = srv.start()
    try:
        a = client_pkg.NetworkRegistry(addr, "job", worker_ttl=0.4)
        b = (pregistry if client_pkg is jregistry
             else jregistry).NetworkRegistry(addr, "job", worker_ttl=0.4)
        a.register_master({"coordinator": "127.0.0.1:9"})
        assert b.retrieve_master(timeout=2.0) == {"coordinator": "127.0.0.1:9"}
        a.register_worker("0", {"devices": 4})
        b.register_worker("1")
        assert a.list_workers() == b.list_workers() == ["0", "1"]
        time.sleep(0.6)
        assert a.list_workers() == []
        la = a.lock("ck", owner="a", lease=30.0)
        lb = b.lock("ck", owner="b", lease=30.0)
        assert la.acquire(timeout=1.0)
        assert not lb.acquire(timeout=0.3)
        la.renew()
        la.release()
        assert lb.acquire(timeout=1.0)
        with pytest.raises(client_pkg.LeaseLostError):
            la.renew()
        lb.release()
    finally:
        srv.stop()


def test_statetracker_json_matches_reference():
    """The same calls on the port's and the reference's services give the
    same ``/statetracker`` JSON, field by field."""
    services = [pcluster.ClusterService(), jcluster.ClusterService()]
    ports = [s.start_rest_api(0) for s in services]
    try:
        for port, svc in zip(ports, services):
            base = f"http://127.0.0.1:{port}/statetracker"
            svc.model_description = "m"
            _post(f"{base}/minibatch", {"value": 48})
            _post(f"{base}/heartbeat", {"worker": "w1", "meta": {"s": 1}})
            _post(f"{base}/phase", {"value": "train"})
            svc.batches_so_far = 7
            svc.report_loss(2.5)
        fields = ["", "/workers", "/phase", "/minibatch",
                  "/numbatchessofar", "/printmodel"]
        got = [[_get(f"http://127.0.0.1:{p}/statetracker{f}")
                for f in fields] for p in ports]
        assert got[0] == got[1]
        assert got[0][0] == {"phase": "train", "workers": ["w1"],
                             "minibatch": 48, "numbatchessofar": 7,
                             "bestloss": 2.5, "earlystop": False}
    finally:
        for s in services:
            s.stop_rest_api()
