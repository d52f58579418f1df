"""Bucket-backed DataSet iteration.

≙ reference deeplearning4j-aws ``BucketIterator`` (iterate S3 objects),
``BaseS3DataSetIterator`` (each object -> one DataSet) and the HDFS twin
``BaseHdfsDataSetIterator`` (hadoop-yarn/deeplearning4j-hadoop) — the
cloud-storage leg of the data pipeline (SURVEY §2, aws module).

Re-design: one ``BucketClient`` protocol (list/get/put) with local-dir,
S3 and GCS implementations; DataSets travel as npz blobs.  The local
implementation doubles as the zero-egress test double, the role the
reference's fake-cluster fixtures play (SURVEY §4.3).

The port's copy of ``deeplearning4j_tpu/datasets/cloud.py`` (host IO: no torch).
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Iterator, Protocol

import numpy as np

from deeplearning4j_tpu_torch.datasets.base import DataSet


class BucketClient(Protocol):
    def list_keys(self) -> list[str]: ...
    def get(self, key: str) -> bytes: ...
    def put(self, key: str, blob: bytes) -> None: ...


class LocalBucketClient:
    """Directory-as-bucket; the test double for the S3/GCS clients."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def list_keys(self) -> list[str]:
        return sorted(p.name for p in self.dir.iterdir() if p.is_file())

    def get(self, key: str) -> bytes:
        return (self.dir / key).read_bytes()

    def put(self, key: str, blob: bytes) -> None:
        (self.dir / key).write_bytes(blob)


class S3BucketClient:
    """≙ BucketIterator over an S3 bucket. Requires boto3 (gated)."""

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            import boto3
        except ImportError as e:  # zero-egress image: surfaced, not hidden
            raise RuntimeError("S3BucketClient requires boto3") from e
        self.client = boto3.client("s3")
        self.bucket = bucket
        self.prefix = prefix.rstrip("/")

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def list_keys(self) -> list[str]:
        list_prefix = self.prefix + "/" if self.prefix else ""
        pages = self.client.get_paginator("list_objects_v2").paginate(
            Bucket=self.bucket, Prefix=list_prefix
        )
        out = []
        for page in pages:
            for obj in page.get("Contents", []):
                out.append(obj["Key"][len(list_prefix) :])
        return sorted(out)

    def get(self, key: str) -> bytes:
        return self.client.get_object(Bucket=self.bucket, Key=self._key(key))[
            "Body"
        ].read()

    def put(self, key: str, blob: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=blob)


class GCSBucketClient:
    """GCS twin of S3BucketClient.
    Requires google-cloud-storage (gated)."""

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            from google.cloud import storage
        except ImportError as e:
            raise RuntimeError("GCSBucketClient requires google-cloud-storage") from e
        self.bucket = storage.Client().bucket(bucket)
        self.prefix = prefix.rstrip("/")

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def list_keys(self) -> list[str]:
        list_prefix = self.prefix + "/" if self.prefix else ""
        return sorted(
            b.name[len(list_prefix) :]
            for b in self.bucket.list_blobs(prefix=list_prefix)
        )

    def get(self, key: str) -> bytes:
        return self.bucket.blob(self._key(key)).download_as_bytes()

    def put(self, key: str, blob: bytes) -> None:
        self.bucket.blob(self._key(key)).upload_from_string(blob)


class TransientStorageError(RuntimeError):
    """A retryable remote-storage failure (network blip, truncated read,
    checksum mismatch)."""


class RetryingBucketClient:
    """Retry/integrity decorator for any :class:`BucketClient` — the
    operational hardening the reference's HDFS/S3 streams relied on
    their client libraries for (BaseHdfsDataSetIterator /
    BucketIterator simply trusted the SDK).

    - every operation retries with exponential backoff on ANY exception
      (bounded by ``retries``);
    - ``put`` writes a ``<key>.sha256`` sidecar; ``get`` verifies it
      when present, so a PARTIAL/truncated read surfaces as a
      :class:`TransientStorageError` and is retried instead of feeding
      corrupt bytes to ``np.load``;
    - checksum sidecars are hidden from ``list_keys``.

    ``sleep`` is injectable so tests run without real waits.
    ``not_found`` is the exception type(s) the wrapped client raises for
    a MISSING key — the default covers the local/dict doubles; wrapping
    a real SDK client, pass its not-found type (e.g. botocore's
    ``ClientError`` won't match ``FileNotFoundError``, and without it a
    sidecar-less object would retry to exhaustion instead of falling
    back to unverified reads).
    """

    SUFFIX = ".sha256"

    def __init__(self, inner: BucketClient, retries: int = 4,
                 backoff: float = 0.1, sleep=None,
                 not_found: tuple = (FileNotFoundError, KeyError)):
        import time as _time

        self.inner = inner
        self.retries = retries
        self.backoff = backoff
        self.sleep = sleep or _time.sleep
        self.not_found = not_found
        self.attempts = 0  # total low-level attempts (observability)

    def _with_retries(self, fn, fatal: tuple = ()):
        """``fatal`` exception types propagate immediately — retrying a
        genuinely-missing key would burn the whole backoff schedule per
        miss for existence probes."""
        delay = self.backoff
        for attempt in range(self.retries + 1):
            self.attempts += 1
            try:
                return fn()
            except fatal:
                raise
            except Exception:
                if attempt == self.retries:
                    raise
                self.sleep(delay)
                delay *= 2

    def list_keys(self) -> list[str]:
        keys = self._with_retries(self.inner.list_keys)
        return [k for k in keys if not k.endswith(self.SUFFIX)]

    def get(self, key: str) -> bytes:
        import hashlib

        def attempt():
            blob = self.inner.get(key)
            try:
                digest = self.inner.get(key + self.SUFFIX).decode()
            except self.not_found:
                # sidecar genuinely ABSENT: integrity not enforced.
                # Any other failure (a transient error on the sidecar
                # fetch) must propagate and retry the whole attempt —
                # swallowing it would silently disable verification
                # and hand truncated bytes downstream.
                return blob
            actual = hashlib.sha256(blob).hexdigest()
            if actual != digest:
                raise TransientStorageError(
                    f"checksum mismatch on {key} "
                    f"(partial/corrupt read: {len(blob)} bytes)"
                )
            return blob

        # a missing PRIMARY key is fatal, not retryable (the sidecar
        # not_found is handled inside attempt and never escapes)
        return self._with_retries(attempt, fatal=self.not_found)

    def put(self, key: str, blob: bytes) -> None:
        import hashlib

        digest = hashlib.sha256(blob).hexdigest().encode()

        def attempt():
            self.inner.put(key, blob)
            self.inner.put(key + self.SUFFIX, digest)

        self._with_retries(attempt)


class FlakyBucketClient:
    """Fault-injection double: wraps any client and fails the first
    ``fail_times`` calls of each (op, key) with a transient error;
    ``truncate_first`` serves a HALF-READ blob on each key's first
    successful ``get`` (caught by the retry client's checksum). The
    zero-egress stand-in for a misbehaving remote store."""

    def __init__(self, inner: BucketClient, fail_times: int = 0,
                 truncate_first: bool = False):
        self.inner = inner
        self.fail_times = fail_times
        self.truncate_first = truncate_first
        self._counts: dict = {}

    def _tick(self, op: str, key: str = "") -> int:
        n = self._counts.get((op, key), 0)
        self._counts[(op, key)] = n + 1
        return n

    def list_keys(self) -> list[str]:
        if self._tick("list") < self.fail_times:
            raise ConnectionError("injected: list failed")
        return self.inner.list_keys()

    def get(self, key: str) -> bytes:
        n = self._tick("get", key)
        if n < self.fail_times:
            raise ConnectionError(f"injected: get {key} failed")
        blob = self.inner.get(key)
        if (self.truncate_first and n == self.fail_times
                and not key.endswith(RetryingBucketClient.SUFFIX)):
            return blob[: len(blob) // 2]  # partial read
        return blob

    def put(self, key: str, blob: bytes) -> None:
        if self._tick("put", key) < self.fail_times:
            raise ConnectionError(f"injected: put {key} failed")
        self.inner.put(key, blob)


def dataset_to_bytes(ds: DataSet) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, features=ds.features, labels=ds.labels)
    return buf.getvalue()


def dataset_from_bytes(blob: bytes) -> DataSet:
    with np.load(io.BytesIO(blob)) as z:
        return DataSet(z["features"], z["labels"])


class CloudDataSetIterator:
    """Iterates DataSets stored one-per-object in a bucket
    (≙ BaseS3DataSetIterator).  ``preprocessor`` hook matches the local
    iterators' DataSetPreProcessor contract."""

    def __init__(self, client: BucketClient, preprocessor=None):
        self.client = client
        self.preprocessor = preprocessor
        self._keys = client.list_keys()
        self._pos = 0

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._pos >= len(self._keys):
            raise StopIteration
        ds = dataset_from_bytes(self.client.get(self._keys[self._pos]))
        self._pos += 1
        if self.preprocessor is not None:
            ds = self.preprocessor(ds)
        return ds

    def has_next(self) -> bool:
        return self._pos < len(self._keys)

    def next(self) -> DataSet:
        return self.__next__()

    def reset(self) -> None:
        self._pos = 0


def upload_dataset_shards(
    client: BucketClient, ds: DataSet, batch_size: int, prefix: str = "part"
) -> list[str]:
    """Splits a DataSet into batch-sized objects (writer side of the
    iterator; ≙ the aws module's DataSetLoader upload path)."""
    keys = []
    for i, batch in enumerate(ds.batches(batch_size)):
        key = f"{prefix}-{i:05d}.npz"
        client.put(key, dataset_to_bytes(batch))
        keys.append(key)
    return keys
