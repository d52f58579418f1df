"""Pluggable model/data storage backends (the port's version of
``deeplearning4j_tpu/utils/cloud_io.py``).

≙ reference ops IO: ``ModelSaver`` impls (DefaultModelSaver file, HDFS
HdfsModelSaver.java:19, S3 S3ModelSaver) plus the S3/HDFS dataset
iterators (BaseS3DataSetIterator, BaseHdfsDataSetIterator) and AWS
provisioning glue (deeplearning4j-aws, SURVEY §2).

Cloud SDKs are *gated*: the interface always exists, object-store
backends activate only when their client library is importable. The
savers are the JAX package's, copied. EC2-style provisioning is a
*command renderer*: where the JAX package renders a TPU VM, the port
renders its counterpart, a GPU VM with H100s (``gcloud compute instances
create`` with the A3 machine type as a flag; the VM is then reached with
``gcloud compute ssh``/``scp``). Cloud CLIs do the work, so the framework
emits the commands rather than shelling out.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol


class ModelSaver(Protocol):
    def save(self, blob: bytes, name: str) -> str: ...
    def load(self, name: str) -> bytes: ...


class LocalModelSaver:
    """≙ DefaultModelSaver.java:19."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, blob: bytes, name: str) -> str:
        p = self.dir / name
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(blob)
        tmp.replace(p)
        return str(p)

    def load(self, name: str) -> bytes:
        return (self.dir / name).read_bytes()


class S3ModelSaver:
    """≙ S3ModelSaver (deeplearning4j-aws). Requires boto3 — or an
    injected ``client`` implementing put_object/get_object (boto3's S3
    surface), which also makes the saver logic exercisable offline."""

    def __init__(self, bucket: str, prefix: str = "", client=None):
        if client is None:
            try:
                import boto3
            except ImportError as e:
                raise RuntimeError("S3ModelSaver requires boto3") from e
            client = boto3.client("s3")
        self.client = client
        self.bucket = bucket
        self.prefix = prefix.rstrip("/")

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def save(self, blob: bytes, name: str) -> str:
        self.client.put_object(Bucket=self.bucket, Key=self._key(name), Body=blob)
        return f"s3://{self.bucket}/{self._key(name)}"

    def load(self, name: str) -> bytes:
        return self.client.get_object(Bucket=self.bucket, Key=self._key(name))[
            "Body"
        ].read()


class GCSModelSaver:
    """GCS twin of S3ModelSaver. Requires google-cloud-storage."""

    def __init__(self, bucket: str, prefix: str = "", bucket_client=None):
        if bucket_client is None:
            try:
                from google.cloud import storage
            except ImportError as e:
                raise RuntimeError(
                    "GCSModelSaver requires google-cloud-storage"
                ) from e
            bucket_client = storage.Client().bucket(bucket)
        self.bucket = bucket_client
        self.prefix = prefix.rstrip("/")

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def save(self, blob: bytes, name: str) -> str:
        self.bucket.blob(self._key(name)).upload_from_string(blob)
        return f"gs://{self.bucket.name}/{self._key(name)}"

    def load(self, name: str) -> bytes:
        return self.bucket.blob(self._key(name)).download_as_bytes()


def get_saver(uri: str) -> ModelSaver:
    """Scheme-dispatch: s3://bucket/prefix, gs://bucket/prefix, or a path."""
    if uri.startswith("s3://"):
        bucket, _, prefix = uri[5:].partition("/")
        return S3ModelSaver(bucket, prefix)
    if uri.startswith("gs://"):
        bucket, _, prefix = uri[5:].partition("/")
        return GCSModelSaver(bucket, prefix)
    return LocalModelSaver(uri)


#: the GPU VM's defaults: an A3 machine (H100s; ``a3-highgpu-1g`` holds
#: one, ``-8g`` eight) from a Deep Learning VM image with PyTorch and CUDA
GPU_MACHINE_TYPE = "a3-highgpu-1g"
GPU_IMAGE_FAMILY = "pytorch-latest-gpu"
GPU_IMAGE_PROJECT = "deeplearning-platform-release"


def render_gpu_vm_provision(
    name: str,
    machine_type: str = GPU_MACHINE_TYPE,
    zone: str = "us-central1-a",
    image_family: str = GPU_IMAGE_FAMILY,
    image_project: str = GPU_IMAGE_PROJECT,
    startup_script: str | None = None,
) -> list[str]:
    """GPU-VM provisioning command (≙ Ec2BoxCreator/ClusterSetup.java:24
    spinning up EC2 workers; the port's counterpart of the JAX package's
    TPU-VM renderer): a ``gcloud compute instances create`` invocation for
    the operator or an orchestrator to run. The H100s come with the A3
    machine type; a GPU VM cannot live-migrate, so host maintenance
    terminates it."""
    cmd = [
        "gcloud", "compute", "instances", "create", name,
        f"--zone={zone}", f"--machine-type={machine_type}",
        f"--image-family={image_family}", f"--image-project={image_project}",
        "--maintenance-policy=TERMINATE",
    ]
    if startup_script:
        cmd.append(f"--metadata=startup-script={startup_script}")
    return cmd
