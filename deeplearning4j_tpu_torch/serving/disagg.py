"""KV-segment wire format for disaggregated prefill/decode serving (the
port's own copy of ``deeplearning4j_tpu/serving/disagg.py``; a frame either
package writes, the other reads).

Disaggregation splits the two phases of a generate request across
replicas: a PREFILL replica computes the prompt's KV rows, and a DECODE
replica seats them and runs the token loop. The hop between them is one
self-describing binary frame carrying a prefix segment (the batch-1 slab
of the engine's segment programs, or its paged block-list form) plus the
stored last-row logits, so decode seats it through the ordinary
zero-prefill full-hit path.

The frame: a fixed magic + version + JSON header (sorted keys: model-config
hash, token ids, layout, per-leaf dtype/shape specs) followed by the raw
C-order array bytes, concatenated in header order. int8 segments ship
their f32 scale planes as ordinary leaves, in key order (``kv``, then
``scale``). bf16 leaves ship as raw 2-byte words under the dtype name
``"bfloat16"``: numpy has no bf16 type, so the port writes them from
torch tensors (or any array whose dtype is named ``bfloat16``) and
:func:`decode_segment` returns them as torch ``bfloat16`` tensors; every
other leaf decodes to a numpy array, as in the reference.

Receivers validate before touching a device: bad magic or version,
truncated or oversized payloads and malformed headers raise
:class:`WireError` with status 400; a model-config-hash mismatch raises
with status 409. Senders fall back to local prefill on any rejection,
which is byte-identical anyway: a rejected transfer costs latency, never
correctness.
"""

from __future__ import annotations

import hashlib
import json
import struct

import numpy as np

#: frame magic: the first 4 bytes of every KV-segment frame
WIRE_MAGIC = b"KVSG"

#: wire format version; bumped on any header or payload layout change
#: (optional header fields such as the migration ``gen`` block are
#: additive and do not bump it)
WIRE_VERSION = 1

_PREAMBLE = struct.Struct("<4sHI")  # magic, version, header length

#: the dtype name bf16 leaves carry on the wire
BF16 = "bfloat16"


class WireError(ValueError):
    """A KV-segment frame the receiver must not seat. ``status`` is the
    HTTP response code: 400 for malformed or truncated frames, 409 for a
    model-config-hash mismatch (well-formed, wrong model)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = int(status)


def model_config_hash(cfg) -> str:
    """sha256 over the config's canonical JSON (``to_json``): two engines
    agree on it iff they run the same architecture, dtypes and geometry.
    The port's ``TransformerConfig.to_json`` is the reference's string, so
    the hash agrees across the packages."""
    return hashlib.sha256(cfg.to_json().encode("utf-8")).hexdigest()


def _host_leaf(a) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, raw C-order bytes) of one leaf: a numpy array
    or a torch tensor (bf16 as its 2-byte words)."""
    if hasattr(a, "detach"):  # a torch tensor, without importing torch
        t = a.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name == BF16:
            import torch

            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return name, tuple(t.shape), raw
    a = np.ascontiguousarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def slab_to_blocks(leaves: list, block_size: int) -> list:
    """Reshape batch-1 slab leaves ``(L, C, 1, Tpad, H)`` into block-list
    leaves ``(L, C, Tpad/bs, bs, H)``: the paged wire layout (rows are
    block-contiguous in the slab, so it is a view)."""
    out = []
    for a in leaves:
        L, C, one, tpad, H = a.shape
        if one != 1 or tpad % block_size:
            raise WireError(f"slab leaf {tuple(a.shape)} not block-alignable "
                            f"at block_size={block_size}")
        out.append(a.reshape(L, C, tpad // block_size, block_size, H))
    return out


def blocks_to_slab(leaves: list) -> list:
    """Inverse of :func:`slab_to_blocks`."""
    out = []
    for a in leaves:
        L, C, nb, bs, H = a.shape
        out.append(a.reshape(L, C, 1, nb * bs, H))
    return out


def encode_segment(*, config_hash: str, tokens, leaves, logits,
                   layout: str = "slab", block_size: int = 0,
                   gen: dict | None = None) -> bytes:
    """Frame one prefix segment for the wire: ``leaves`` the segment's
    cache arrays in batch-1 slab form ``(L, C, 1, Tpad, H)`` for
    ``layout="slab"`` or block-list form for ``"paged"``
    (:func:`slab_to_blocks`), ``logits`` the stored ``(1, V)`` last-row
    logits, ``gen`` the optional live-session block of a migration frame.
    Leaves and logits are numpy arrays or torch tensors."""
    if layout not in ("slab", "paged"):
        raise WireError(f"unknown layout {layout!r}")
    if layout == "paged" and int(block_size) <= 0:
        raise WireError("paged layout requires a positive block_size")
    arrs = [_host_leaf(a) for a in leaves]
    lg = _host_leaf(logits)
    header = {
        "version": WIRE_VERSION,
        "config_hash": str(config_hash),
        "layout": layout,
        "block_size": int(block_size),
        "tokens": [int(t) for t in np.asarray(tokens).reshape(-1)],
        "leaves": [{"dtype": n, "shape": list(s)} for n, s, _ in arrs],
        "logits": {"dtype": lg[0], "shape": list(lg[1])},
    }
    if gen is not None:
        header["gen"] = dict(gen)
    hjson = json.dumps(header, sort_keys=True).encode("utf-8")
    parts = [_PREAMBLE.pack(WIRE_MAGIC, WIRE_VERSION, len(hjson)), hjson]
    parts += [raw for _, _, raw in arrs]
    parts.append(lg[2])
    return b"".join(parts)


def _read_array(data: bytes, spec: dict, off: int, what: str):
    try:
        name = str(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
    except (KeyError, TypeError, ValueError):
        raise WireError(f"malformed {what} spec {spec!r}") from None
    try:
        dt = np.dtype(np.uint16 if name == BF16 else name)
    except TypeError:
        raise WireError(f"unknown leaf dtype {name!r}") from None
    count = 1
    for d in shape:
        if d < 0:
            raise WireError(f"negative dimension in {what} spec")
        count *= d
    nbytes = count * dt.itemsize
    if off + nbytes > len(data):
        raise WireError(f"truncated payload: {what} needs {nbytes} bytes at "
                        f"offset {off}, frame has {len(data)}")
    arr = np.frombuffer(data, dt, count=count, offset=off).reshape(shape)
    if name == BF16:
        import torch

        arr = torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr, off + nbytes


def decode_segment(data: bytes, *, expect_hash: str | None = None) -> dict:
    """Parse and validate one wire frame; the inverse of
    :func:`encode_segment`. Returns ``{"config_hash", "layout",
    "block_size", "tokens" (int32 array), "leaves" (batch-1 slab form;
    paged frames are reassembled), "logits", "gen" (None for plain
    segments), "nbytes"}``. Raises :class:`WireError` (400) on bad magic
    or version, malformed headers or a byte count that disagrees with the
    specs, and (409) when ``expect_hash`` is given and differs."""
    if len(data) < _PREAMBLE.size:
        raise WireError("frame shorter than preamble")
    magic, version, hlen = _PREAMBLE.unpack_from(data)
    if magic != WIRE_MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireError(f"unsupported wire version {version} "
                        f"(speaking {WIRE_VERSION})")
    if _PREAMBLE.size + hlen > len(data):
        raise WireError("truncated header")
    try:
        header = json.loads(
            data[_PREAMBLE.size:_PREAMBLE.size + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise WireError("malformed header JSON") from None
    try:
        config_hash = str(header["config_hash"])
        layout = str(header["layout"])
        block_size = int(header["block_size"])
        tokens = np.asarray([int(t) for t in header["tokens"]], np.int32)
        leaf_specs = list(header["leaves"])
        logit_spec = dict(header["logits"])
    except (KeyError, TypeError, ValueError):
        raise WireError("header missing required fields") from None
    gen = header.get("gen")
    if gen is not None and not isinstance(gen, dict):
        raise WireError("gen header field must be an object")
    if layout not in ("slab", "paged"):
        raise WireError(f"unknown layout {layout!r}")
    if expect_hash is not None and config_hash != expect_hash:
        raise WireError(
            f"model config hash mismatch: frame {config_hash[:12]}..., "
            f"receiver {expect_hash[:12]}...", status=409)
    off = _PREAMBLE.size + hlen
    leaves = []
    for i, spec in enumerate(leaf_specs):
        arr, off = _read_array(data, spec, off, f"leaf {i}")
        leaves.append(arr)
    logits, off = _read_array(data, logit_spec, off, "logits")
    if off != len(data):
        raise WireError(f"{len(data) - off} trailing bytes after declared "
                        f"payload")
    if layout == "paged":
        if block_size <= 0:
            raise WireError("paged frame with non-positive block_size")
        leaves = blocks_to_slab(leaves)
    return {
        "config_hash": config_hash,
        "layout": layout,
        "block_size": block_size,
        "tokens": tokens,
        "leaves": leaves,
        "logits": logits,
        "gen": gen,
        "nbytes": len(data),
    }
