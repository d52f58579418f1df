"""The port's KV-segment wire format (``serving/disagg.py``) held against the
reference's (``deeplearning4j_tpu/serving/disagg.py``).

Frames are byte-compatible: for the same f32 and int8 leaves (slab and
paged layouts, with and without a migration ``gen`` block) the port's
``encode_segment`` writes the reference's bytes, and bf16 frames cross
both ways (the port writes bf16 torch tensors as raw 2-byte words under
the dtype name ``"bfloat16"``; the reference decodes them with
``ml_dtypes``, and the port decodes the reference's into torch bf16
tensors). The reference's six wire tests are cases of the port's here.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jt
from deeplearning4j_tpu.serving import disagg as jdisagg
from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.serving import disagg
from deeplearning4j_tpu_torch.serving.disagg import (
    WIRE_MAGIC,
    WireError,
    blocks_to_slab,
    decode_segment,
    encode_segment,
    slab_to_blocks,
)

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

V = 64


def _slab_leaves(dtype, seed=0):
    """Two (L, C, 1, Tpad, H) numpy leaves in ``dtype``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 2, 1, 16, 8)).astype(dtype)
            for _ in range(2)]


def _bf16_tensors(seed=0):
    """Two (L, C, 1, Tpad, H) torch bf16 leaves."""
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _slab_leaves(np.float32, seed)]


def _logits(seed=1):
    return np.random.default_rng(seed).standard_normal((1, V)).astype(
        np.float32)


def _roundtrip(leaves, logits, **kw):
    frame = encode_segment(config_hash="h" * 64, tokens=[3, 5, 7],
                           leaves=leaves, logits=logits, **kw)
    return frame, decode_segment(frame)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.int16).numpy().tobytes()


# -- the reference's six wire tests, as the port's -------------------------


def test_wire_roundtrip_bf16_exact():
    leaves = _bf16_tensors()
    logits = _logits()
    frame, dec = _roundtrip(leaves, logits)
    assert dec["config_hash"] == "h" * 64
    assert dec["layout"] == "slab" and dec["block_size"] == 0
    np.testing.assert_array_equal(dec["tokens"],
                                  np.asarray([3, 5, 7], np.int32))
    assert dec["tokens"].dtype == np.int32
    assert dec["nbytes"] == len(frame)
    for a, b in zip(leaves, dec["leaves"]):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
        assert b.shape == a.shape
        assert _bits(b) == _bits(a)  # bitwise, not approx
    assert dec["logits"].tobytes() == logits.tobytes()


def test_wire_roundtrip_int8_with_scale_planes():
    """int8 segments ship their f32 scale planes as ordinary leaves: mixed
    dtypes in one frame round-trip bitwise (numpy and torch leaves
    alike)."""
    rng = np.random.default_rng(2)
    q = rng.integers(-128, 128, (2, 2, 1, 16, 8)).astype(np.int8)
    scales = rng.standard_normal((2, 2, 1, 16, 1)).astype(np.float32)
    for leaves in ([q, scales],
                   [torch.from_numpy(q), torch.from_numpy(scales)]):
        frame, dec = _roundtrip(leaves, _logits())
        assert dec["leaves"][0].dtype == np.int8
        assert dec["leaves"][1].dtype == np.float32
        assert dec["leaves"][0].tobytes() == q.tobytes()
        assert dec["leaves"][1].tobytes() == scales.tobytes()


def test_wire_paged_blocklist_layout_roundtrip():
    """Paged frames carry block-list leaves and the receiver reassembles
    the batch-1 slab; slab -> blocks -> slab is the identity."""
    leaves = _slab_leaves(np.float32, seed=3)
    blocks = slab_to_blocks(leaves, block_size=4)
    assert blocks[0].shape == (2, 2, 4, 4, 8)
    for a, b in zip(leaves, blocks_to_slab(blocks)):
        assert b.shape == a.shape and b.tobytes() == a.tobytes()
    logits = np.zeros((1, V), np.float32)
    _, dec = _roundtrip(blocks, logits, layout="paged", block_size=4)
    assert dec["layout"] == "paged" and dec["block_size"] == 4
    for a, b in zip(leaves, dec["leaves"]):  # slab form comes back
        assert b.shape == a.shape and b.tobytes() == a.tobytes()
    with pytest.raises(WireError):  # 16 rows do not split into 5-blocks
        slab_to_blocks(leaves, block_size=5)
    with pytest.raises(WireError):
        encode_segment(config_hash="h", tokens=[1], leaves=blocks,
                       logits=logits, layout="paged", block_size=0)


def test_wire_rejects_truncated_and_trailing():
    frame, _ = _roundtrip(_slab_leaves(np.float32),
                          np.zeros((1, V), np.float32))
    for cut in (3, len(frame) // 2, len(frame) - 1):
        with pytest.raises(WireError) as ei:
            decode_segment(frame[:cut])
        assert ei.value.status == 400
    with pytest.raises(WireError, match="trailing"):
        decode_segment(frame + b"\x00")


def test_wire_rejects_bad_magic_version_and_header():
    frame, _ = _roundtrip(_slab_leaves(np.float32),
                          np.zeros((1, V), np.float32))
    assert frame[:4] == WIRE_MAGIC
    with pytest.raises(WireError, match="magic"):
        decode_segment(b"XXXX" + frame[4:])
    with pytest.raises(WireError, match="version"):
        decode_segment(frame[:4] + b"\xff\x00" + frame[6:])
    with pytest.raises(WireError):  # garbage where the header should be
        decode_segment(frame[:10] + b"\xff" * (len(frame) - 10))


def test_wire_config_hash_mismatch_is_409():
    frame, _ = _roundtrip(_slab_leaves(np.float32),
                          np.zeros((1, V), np.float32))
    with pytest.raises(WireError) as ei:
        decode_segment(frame, expect_hash="x" * 64)
    assert ei.value.status == 409
    # no expectation: it parses (the engine checks again at seat time)
    assert decode_segment(frame)["config_hash"] == "h" * 64


# -- across the packages -----------------------------------------------------


def _cases():
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, (2, 2, 1, 16, 8)).astype(np.int8)
    sc = rng.standard_normal((2, 2, 1, 16, 1)).astype(np.float32)
    f32 = _slab_leaves(np.float32, seed=6)
    gen = {"n_prompt": 2, "tokens": [7], "max_new": 4, "eos_token": None,
           "adapter": 0, "key_data": [0, 4294967295], "req_id": "req-9"}
    return {
        "f32_slab": dict(leaves=f32),
        "int8_slab": dict(leaves=[q, sc]),
        "f32_paged": dict(leaves=slab_to_blocks(f32, 4), layout="paged",
                          block_size=4),
        "int8_paged_gen": dict(leaves=slab_to_blocks([q, sc], 8),
                               layout="paged", block_size=8, gen=gen),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_frames_are_the_references_bytes(case):
    """The same f32 or int8 leaves frame to the reference's bytes, from
    numpy arrays and from torch tensors, and each package decodes the
    other's frame."""
    kw = _cases()[case]
    common = dict(config_hash="c" * 64, tokens=np.asarray([1, 2, 3]),
                  logits=_logits(7))
    ref = jdisagg.encode_segment(**common, **kw)
    assert encode_segment(**common, **kw) == ref
    tkw = dict(kw, leaves=[torch.from_numpy(a.copy()) for a in kw["leaves"]])
    tcommon = dict(common, logits=torch.from_numpy(common["logits"]))
    assert encode_segment(**tcommon, **tkw) == ref
    mine, theirs = decode_segment(ref), jdisagg.decode_segment(ref)
    for k in ("config_hash", "layout", "block_size", "gen", "nbytes"):
        assert mine[k] == theirs[k], k
    np.testing.assert_array_equal(mine["tokens"], theirs["tokens"])
    for a, b in zip(mine["leaves"], theirs["leaves"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert mine["logits"].tobytes() == theirs["logits"].tobytes()


def test_bf16_frames_cross_both_ways():
    """The port's bf16 frame (from torch tensors) is the reference's frame
    for the same values as ``ml_dtypes`` arrays, byte for byte; the
    reference decodes the port's and the port the reference's."""
    tensors = _bf16_tensors(seed=8)
    arrays = [np.frombuffer(_bits(t), ml_dtypes.bfloat16).reshape(t.shape)
              for t in tensors]
    common = dict(config_hash="b" * 64, tokens=[4, 5], logits=_logits(9))
    mine = encode_segment(leaves=tensors, **common)
    theirs = jdisagg.encode_segment(leaves=arrays, **common)
    assert mine == theirs
    dec = jdisagg.decode_segment(mine)
    for a, t in zip(dec["leaves"], tensors):
        assert a.dtype == ml_dtypes.bfloat16 and a.tobytes() == _bits(t)
    dec = decode_segment(theirs)
    for t, a in zip(dec["leaves"], arrays):
        assert t.dtype == torch.bfloat16 and _bits(t) == a.tobytes()
    # the port also frames an ml_dtypes array it is handed, by name
    assert encode_segment(leaves=arrays, **common) == theirs


def test_model_config_hash_agrees_across_packages():
    """The two ``TransformerConfig.to_json()`` strings are equal, so a
    frame's config hash names the model in both packages (and another
    config, int8 or longer, another hash)."""
    jcfg = jt.TransformerConfig(vocab_size=V, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_len=32)
    cfg = pt.TransformerConfig.from_json(jcfg.to_json())
    assert disagg.model_config_hash(cfg) == jdisagg.model_config_hash(jcfg)
    for kw in ({"decode_int8": True}, {"max_len": 48}):
        j2 = dataclasses.replace(jcfg, **kw)
        p2 = pt.TransformerConfig.from_json(j2.to_json())
        assert disagg.model_config_hash(p2) == jdisagg.model_config_hash(j2)
        assert disagg.model_config_hash(p2) != disagg.model_config_hash(cfg)
