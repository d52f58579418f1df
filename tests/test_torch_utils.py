"""The port's ``utils/`` against the JAX package's: the cases of
``tests/test_aux_utils.py`` (distributions, profiling, the metrics writer
and listener, collections, strings, the object-store savers), the copied
helpers held equal to the reference's on the same inputs, and
``provision`` through a ``RecordingRunner``: the reference
``ClusterSetup``'s steps in its order, for the same hosts and scripts,
with the GPU VM's commands in place of the TPU VM's.
"""

import io
import json
import shlex

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.utils import collections_util as ref_coll
from deeplearning4j_tpu.utils import counters as ref_counters
from deeplearning4j_tpu.utils import dedup as ref_dedup
from deeplearning4j_tpu.utils import math_utils as ref_math
from deeplearning4j_tpu.utils import provision as ref_prov
from deeplearning4j_tpu.utils import string_utils as ref_strings
from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.utils import distributions as dist
from deeplearning4j_tpu_torch.utils.cloud_io import (
    GCSModelSaver,
    LocalModelSaver,
    S3ModelSaver,
    get_saver,
    render_gpu_vm_provision,
)
from deeplearning4j_tpu_torch.utils.collections_util import (
    MultiDimensionalMap,
    SummaryStatistics,
    extract_archive,
)
from deeplearning4j_tpu_torch.utils.metrics import (
    MetricsIterationListener,
    MetricsWriter,
)
from deeplearning4j_tpu_torch.utils.profiling import (
    StopWatch,
    annotate,
    timed,
    trace,
)
from deeplearning4j_tpu_torch.utils.provision import (
    ClusterSetup,
    ClusterSpec,
    CommandResult,
    HostProvisioner,
    ProvisionError,
    RecordingRunner,
)

torch.set_num_threads(1)


# -- distributions --------------------------------------------------------


def test_distributions():
    key = rng.key_for(0)
    n = dist.get("normal", 1.0, 0.5)(key, (2000,), device="cpu")
    assert abs(float(n.mean()) - 1.0) < 0.05
    u = dist.get("uniform", -2, 2)(key, (1000,), device="cpu")
    assert float(u.min()) >= -2 and float(u.max()) <= 2
    b = dist.get("binomial", 1, 0.3)(key, (3000,), device="cpu")
    assert abs(float(b.mean()) - 0.3) < 0.05
    b5 = dist.get("binomial", 5, 0.3)(key, (4000,), device="cpu")
    assert set(np.unique(b5.numpy())) <= set(range(6))
    assert abs(float(b5.mean()) - 1.5) < 0.1
    with pytest.raises(ValueError, match="Unknown distribution"):
        dist.get("cauchy")


def test_distributions_draw_the_reference_streams():
    """normal, uniform and binomial(1, p) take the reference's key stream:
    the same key gives the reference sampler's values (the uniforms and
    the Bernoulli draws bitwise, the normals within 1e-6 relative, the
    inverse erf being evaluated on another library)."""
    jax = pytest.importorskip("jax")
    from deeplearning4j_tpu.utils import distributions as ref_dist

    key, jkey = rng.key_for(5), jax.random.key(5)
    for args, rel in ((("uniform", -2, 2), 0.0), (("binomial", 1, 0.3), 0.0),
                      (("normal", 1.0, 0.5), 1e-6)):
        mine = dist.get(*args)(key, (257,), device="cpu").numpy()
        theirs = np.asarray(ref_dist.get(*args)(jkey, (257,)))
        if rel:
            np.testing.assert_allclose(mine, theirs, rtol=rel, atol=0)
        else:
            np.testing.assert_array_equal(mine, theirs)


def test_distributions_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.get("normal")(rng.key_for(0), (4,))


# -- profiling ------------------------------------------------------------


def test_stopwatch_and_timed():
    sw = StopWatch()
    with sw.lap():
        sum(range(1000))
    assert sw.total > 0 and len(sw.laps) == 1
    records = []
    with timed("x", sink=lambda label, dt: records.append((label, dt))):
        pass
    assert records and records[0][0] == "x"


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with trace(tmp_path / "tr") as prof:
        with annotate("my_region"):
            torch.ones(8) @ torch.ones(8)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert prof.trace_path == str(tmp_path / "tr" / "trace.json")
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "my_region" in names


# -- metrics writer + listener --------------------------------------------


def test_metrics_writer_and_listener(tmp_path):
    w = MetricsWriter(tmp_path / "m.jsonl")
    listener = MetricsIterationListener(w)
    for i in range(3):
        listener.iteration_done({"iteration": i, "score": 1.0 / (i + 1)})
    w.close()
    recs = MetricsWriter.read(tmp_path / "m.jsonl")
    scores = [r for r in recs if r["tag"] == "train/score"]
    assert len(scores) == 3 and scores[-1]["value"] == pytest.approx(1 / 3)
    assert sum(r["tag"] == "train/step_seconds" for r in recs) == 2


def test_metrics_listener_on_a_port_solver(tmp_path):
    """The listener rides the port's ``optimize/api.py`` interface."""
    from deeplearning4j_tpu_torch.optimize.api import IterationListener

    w = MetricsWriter(tmp_path / "s.jsonl")
    assert isinstance(MetricsIterationListener(w), IterationListener)
    w.close()


# -- collections, strings, counters, math, dedup, disk queue --------------


def test_collections_util(tmp_path):
    m = MultiDimensionalMap()
    m.put("a", 1, "x")
    assert m.get("a", 1) == "x" and m.contains("a", 1) and len(m) == 1
    s = SummaryStatistics()
    for v in [1.0, 2.0, 3.0, 4.0]:
        s.add(v)
    assert s.mean == pytest.approx(2.5)
    assert s.std == pytest.approx(np.std([1, 2, 3, 4], ddof=1))
    assert s.min == 1.0 and s.max == 4.0
    import tarfile

    archive = tmp_path / "a.tar.gz"
    (tmp_path / "payload.txt").write_text("hi")
    with tarfile.open(archive, "w:gz") as t:
        t.add(tmp_path / "payload.txt", arcname="payload.txt")
    out = extract_archive(archive, tmp_path / "out")
    assert (out / "payload.txt").read_text() == "hi"
    ref_out = ref_coll.extract_archive(archive, tmp_path / "ref_out")
    assert (ref_out / "payload.txt").read_text() == "hi"


def test_string_utils_equal_the_reference():
    from deeplearning4j_tpu_torch.utils.string_utils import (
        edit_distance,
        longest_common_substring,
        ngrams,
    )

    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance("", "abc") == 3
    assert longest_common_substring("deeplearning", "earnings") == "earning"
    assert longest_common_substring("abc", "xyz") == ""
    assert ngrams(["a", "b", "c"], 2) == [("a", "b"), ("b", "c")]
    assert ngrams(["a"], 2) == []
    for a, b in (("flaw", "lawn"), ("intention", "execution"), ("", "")):
        assert edit_distance(a, b) == ref_strings.edit_distance(a, b)
        assert longest_common_substring(a, b) == (
            ref_strings.longest_common_substring(a, b))


def test_counters_equal_the_reference():
    from deeplearning4j_tpu_torch.utils.counters import Counter, CounterMap

    words = "the cat and the hat and the bat".split()
    mine, theirs = Counter(words), ref_counters.Counter(words)
    assert mine.arg_max() == theirs.arg_max() == "the"
    assert mine.sorted_keys() == theirs.sorted_keys()
    mine.normalize()
    theirs.normalize()
    assert dict(mine.items()) == dict(theirs.items())
    cm, rcm = CounterMap(), ref_counters.CounterMap()
    for a, b in zip(words, words[1:]):
        cm.increment_count(a, b)
        rcm.increment_count(a, b)
    assert cm.get_count("the", "cat") == rcm.get_count("the", "cat") == 1.0


def test_math_utils_equal_the_reference():
    from deeplearning4j_tpu_torch.utils import math_utils as mu

    a, b = [0.2, 0.5, 0.3], [0.1, 0.6, 0.3]
    assert mu.entropy(a) == ref_math.entropy(a)
    assert mu.log_sum_exp([1.0, 2.0, 3.0]) == ref_math.log_sum_exp(
        [1.0, 2.0, 3.0])
    assert mu.cosine_similarity(a, b) == ref_math.cosine_similarity(a, b)
    assert mu.correlation(a, b) == ref_math.correlation(a, b)
    assert mu.next_power_of_2(37) == ref_math.next_power_of_2(37) == 64
    assert mu.combinations(6, 2) == ref_math.combinations(6, 2) == 15


def test_dedup_and_disk_queue(tmp_path):
    from deeplearning4j_tpu_torch.utils.dedup import StringGrid, fingerprint
    from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue

    for s in ("  Hello, World!", "world hello", "Café  au lait"):
        assert fingerprint(s) == ref_dedup.fingerprint(s)
    lines = ["a,Hello World", "b,world hello", "c,other"]
    g, rg = StringGrid.from_lines(lines), ref_dedup.StringGrid.from_lines(
        lines)
    assert g.clusters_by_fingerprint(1) == rg.clusters_by_fingerprint(1)
    q = DiskBasedQueue(tmp_path / "q")
    for i in range(3):
        q.add({"i": i})
    assert len(q) == 3 and q.peek() == {"i": 0}
    assert [q.poll()["i"] for _ in range(3)] == [0, 1, 2]
    assert q.is_empty()


# -- the savers -----------------------------------------------------------


def test_s3_and_gcs_savers_via_injected_clients():
    class FakeS3:
        def __init__(self):
            self.store = {}

        def put_object(self, Bucket, Key, Body):
            self.store[(Bucket, Key)] = bytes(Body)

        def get_object(self, Bucket, Key):
            return {"Body": io.BytesIO(self.store[(Bucket, Key)])}

    s3 = S3ModelSaver("models", prefix="runs/a/", client=FakeS3())
    assert s3.save(b"weights-blob", "ckpt_5.npz") == (
        "s3://models/runs/a/ckpt_5.npz")
    assert s3.load("ckpt_5.npz") == b"weights-blob"

    class FakeBlob:
        def __init__(self, store, key):
            self.store, self.key = store, key

        def upload_from_string(self, data):
            self.store[self.key] = (data if isinstance(data, bytes)
                                    else data.encode())

        def download_as_bytes(self):
            return self.store[self.key]

    class FakeBucket:
        name = "models"

        def __init__(self):
            self.store = {}

        def blob(self, key):
            return FakeBlob(self.store, key)

    gcs = GCSModelSaver("models", prefix="runs/b", bucket_client=FakeBucket())
    assert gcs.save(b"gcs-blob", "final.npz") == "gs://models/runs/b/final.npz"
    assert gcs.load("final.npz") == b"gcs-blob"


def test_cloud_io_local_and_dispatch(tmp_path):
    saver = get_saver(str(tmp_path))
    assert isinstance(saver, LocalModelSaver)
    path = saver.save(b"hello", "model.bin")
    assert saver.load("model.bin") == b"hello"
    assert path.endswith("model.bin")


def test_render_gpu_vm_provision():
    cmd = render_gpu_vm_provision("x", zone="us-east1-d",
                                  machine_type="a3-highgpu-8g",
                                  startup_script="setup.sh")
    assert cmd[:5] == ["gcloud", "compute", "instances", "create", "x"]
    assert "--zone=us-east1-d" in cmd
    assert "--machine-type=a3-highgpu-8g" in cmd
    assert "--maintenance-policy=TERMINATE" in cmd
    assert cmd[-1] == "--metadata=startup-script=setup.sh"


# -- provisioning (≙ ClusterSetup.java:24) --------------------------------


def _kinds(commands, tpu: bool):
    """Each command's step (create, scp, ssh, delete) and its host and
    payload, with the VM flavor's own words taken out."""
    out = []
    for c in commands:
        # after "gcloud compute tpus tpu-vm" / "gcloud compute [instances]"
        words = c[4:] if tpu else c[2:]
        if words[0] == "instances":
            words = words[1:]
        step = words[0]
        rest = [w for w in words[1:] if not w.startswith(
            ("--accelerator-type", "--version", "--machine-type",
             "--image-family", "--image-project", "--maintenance-policy"))]
        out.append((step, rest))
    return out


def test_cluster_setup_mirrors_the_reference_steps(tmp_path):
    script = tmp_path / "setup.sh"
    script.write_text("#!/bin/sh\necho hi\n")
    runner, ref_runner = RecordingRunner(), ref_prov.RecordingRunner()
    names = ClusterSetup(ClusterSpec(
        name="dl4j", num_workers=2, zone="us-z", worker_script=str(script),
        master_script=str(script)), runner=runner).provision()
    ref_names = ref_prov.ClusterSetup(ref_prov.ClusterSpec(
        name="dl4j", num_workers=2, zone="us-z", worker_script=str(script),
        master_script=str(script)), runner=ref_runner).provision()
    assert names == ref_names == ["dl4j-master", "dl4j-worker-0",
                                  "dl4j-worker-1"]
    assert _kinds(runner.commands, False) == _kinds(ref_runner.commands,
                                                    True)
    joined = [" ".join(c) for c in runner.commands]
    assert sum("compute instances create" in c for c in joined) == 3
    assert sum("compute scp" in c for c in joined) == 3
    run_cmds = [c for c in joined if "compute ssh" in c]
    assert len(run_cmds) == 3
    assert "chmod +x setup.sh && ./setup.sh" in run_cmds[0]
    assert "--zone=us-z" in joined[0]
    assert "--machine-type=a3-highgpu-1g" in joined[0]


def test_cluster_setup_teardown_reverses():
    runner, ref_runner = RecordingRunner(), ref_prov.RecordingRunner()
    ClusterSetup(ClusterSpec(num_workers=1), runner=runner).teardown()
    ref_prov.ClusterSetup(ref_prov.ClusterSpec(num_workers=1),
                          runner=ref_runner).teardown()
    deleted = [c[4] for c in runner.commands]
    assert deleted == [c[5] for c in ref_runner.commands] == [
        "dl4j-worker-0", "dl4j-master"]
    assert all(c[:4] == ["gcloud", "compute", "instances", "delete"]
               for c in runner.commands)


def test_provision_failure_raises_with_command():
    runner = RecordingRunner(responses={
        "create dl4j-worker-0": CommandResult(1, stderr="quota exceeded")})
    with pytest.raises(ProvisionError, match="quota exceeded"):
        ClusterSetup(ClusterSpec(num_workers=1), runner=runner).provision()


def test_teardown_attempts_every_delete():
    runner = RecordingRunner(responses={
        "delete dl4j-worker-0": CommandResult(1, stderr="gone")})
    with pytest.raises(ProvisionError, match="1 delete"):
        ClusterSetup(ClusterSpec(num_workers=1), runner=runner).teardown()
    assert len(runner.commands) == 2


def test_host_provisioner_ssh_forms(tmp_path):
    key = tmp_path / "id.pub"
    key.write_text("ssh-ed25519 AAAA me@host\n")
    runner = RecordingRunner()
    hp = HostProvisioner("10.0.0.5", user="ubuntu", key_file="/k",
                         runner=runner)
    hp.run_remote_command("ls /")
    hp.upload_for_deployment("/src/a.tar", "/dst/a.tar")
    hp.add_key_file(str(key))
    cmds = [" ".join(c) for c in runner.commands]
    assert cmds[0] == "ssh -i /k ubuntu@10.0.0.5 ls /"
    assert cmds[1] == "scp -i /k /src/a.tar ubuntu@10.0.0.5:/dst/a.tar"
    assert "authorized_keys" in cmds[2]
    gpu = HostProvisioner("node-1", zone="z", gpu_vm=True, runner=runner)
    gpu.run_remote_command("hostname")
    assert runner.commands[-1] == ["gcloud", "compute", "ssh", "node-1",
                                   "--zone=z", "--command=hostname"]
    gpu.upload_and_run("/home/me/setup script.sh", root_dir="/srv")
    assert runner.commands[-2] == ["gcloud", "compute", "scp",
                                   "/home/me/setup script.sh",
                                   "node-1:/srv/setup script.sh", "--zone=z"]
    assert shlex.quote("/srv/setup script.sh") in runner.commands[-1][-1]


def test_cli_provision_dry_run(capsys):
    from deeplearning4j_tpu_torch.cli import main

    assert main(["provision", "mypod", "--zone", "us-east1-d",
                 "--num-workers", "1"]) == 0
    out = capsys.readouterr().out
    assert "gcloud compute instances create mypod-master" in out
    assert "gcloud compute instances create mypod-worker-0" in out
    assert "--zone=us-east1-d" in out
    assert "# dry run: 2 commands for mypod-master, mypod-worker-0" in out
