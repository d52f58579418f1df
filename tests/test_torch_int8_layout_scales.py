"""Kernel #3's int8 mode with its two scales from outside, and the maxima
pass that gives the softmax-weight scale, on the CPU (plain versions):

- the maxima pass against the values the full pass reduces into each
  tile's weight scale (one tile, ten tiles, the two-tile default at Tpad
  8,704);
- the full pass with scales from outside equal to its own: bitwise the
  pass without them;
- a (data, model) layout's ranks (``_MeshDecode.decode_ranks``: KV heads
  split, wkv whole, FSDP), each launching over its own heads under the
  row's scales: their outputs, put back in the single device's lane order,
  bitwise the single-device launch, and within the reference's bar of the
  reference's Pallas kernel (interpret mode); without the row's scales
  they are not;
- a rank's tile is the whole row's default, not its own narrower cache's;
- q scales that differ across the (group, KV head) lanes of one launch:
  each lane takes its own.

The ``cuda`` cases hold the kernel's two new modes against their plain
versions on the card: bitwise with the row's scales over a rank's lanes;
with q scales that differ across every lane of one launch, the maxima
pass bitwise, the full pass within one bf16 step (l, a tile's sum of
softmax weights, is added up in another order) and each lane bitwise its
KV head launched alone.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import flash_decode as fd
from deeplearning4j_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

#: 4 query heads over 2 KV heads of 128: the row's Hkv*K is 256 (the
#: long-context width, whose default tile at Tpad 8,704 is 4,352 rows), a
#: rank's 128 (one 8,704-row tile by its own default)
CFG = pt.TransformerConfig(vocab_size=64, d_model=512, n_heads=4, n_layers=1,
                           d_ff=64, max_len=96, n_kv_heads=2,
                           decode_int8=True)
KD, HKV = CFG.head_dim, CFG.kv_heads
G = CFG.n_heads // CFG.kv_heads
#: (dp, tp, fsdp): KV heads split over 2 ranks, wkv whole over 4 (each
#: rank its query head's expanded KV), the (4, 2) layout split over the
#: data axis too (tests/test_torch_mesh_generate.py's int8 layouts)
LAYOUTS = {"split wkv": (2, 2, False), "whole wkv": (1, 4, False),
           "fsdp": (4, 2, True)}
#: (Tpad, block_t, positions of the two rows): one tile, ten tiles (the
#: second row's position leaves five of them unread), and the two-tile
#: default (positions past and before the second tile's first row)
TILES = {"one tile": (160, None, [159, 77]),
         "ten tiles": (640, 64, [639, 300]),
         "two tiles": (8704, None, [8447, 4351])}
#: the reference's bar for the port's plain int8 decode against its Pallas
#: kernel (tests/test_torch_int8_decode.py): the sums' order and exp's
#: last bit differ
REF_ATOL = 1e-5


def _inputs(tpad: int, seed: int, b: int = 2):
    """q (b, G, Hkv*K), an int8 cache of one layer and its f32 scales, as
    the long-context tests draw them."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, G, HKV * KD))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.integers(-127, 128, (1, 2, b, tpad, HKV * KD))
                          .astype(np.int8))
    sc = torch.from_numpy((rng.random((1, 2, b, tpad, 1)) * 0.02)
                          .astype(np.float32))
    return q, kv, sc


def _own_q_scales(q):
    """The launch's own q scales a lane: each group's over ALL heads."""
    b = q.shape[0]
    qsc = fd._div127(q.abs().amax(-1).clamp_min(1e-8))
    return qsc[..., None].expand(b, G, HKV).contiguous()


@pytest.mark.parametrize("tiles", sorted(TILES))
def test_maxima_pass_is_what_the_full_pass_divides(monkeypatch, tiles):
    """Each tile's maximum from the maxima pass is the value the full
    pass clamps and divides by 127 for that tile's weight scale (0 past
    pos[b], where the full pass's clamp gives 1e-30)."""
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = _inputs(tpad, 1)
    p = torch.tensor(pos)
    got = fd.flash_decode_int8_maxima(q, kv, p, HKV, 0, bt, sc)
    tile = bt or fd.default_block_t(tpad, HKV * KD, 1)
    n_t = -(-tpad // tile)
    assert got.shape == (2, n_t) and got.dtype == torch.float32
    divided = []
    real = fd._div127
    monkeypatch.setattr(fd, "_div127",
                        lambda x: divided.append(x.clone()) or real(x))
    fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc)
    # the q scale first, then one weight scale a tile
    assert len(divided) == 1 + n_t
    assert torch.equal(torch.stack(divided[1:], 1), got.clamp_min(1e-30))
    past = torch.arange(n_t)[None] * tile > p[:, None]
    assert bool(past.any()) == (tiles != "one tile")
    assert torch.equal(got[past], torch.zeros(int(past.sum())))
    assert (got[~past] > 0).all()


@pytest.mark.parametrize("tiles", sorted(TILES))
def test_own_scales_from_outside_are_bitwise_the_pass_without(tiles):
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = _inputs(tpad, 2)
    p = torch.tensor(pos)
    want = fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc)
    q_scales = _own_q_scales(q)
    p_scales = fd._div127(fd.flash_decode_int8_maxima(
        q, kv, p, HKV, 0, bt, sc, q_scales).clamp_min(1e-30))
    got = fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc, q_scales,
                                    p_scales)
    assert torch.equal(got, want)
    # each alone, too
    assert torch.equal(fd.flash_decode_attention(
        q, kv, p, HKV, 0, bt, sc, q_scales=q_scales), want)
    assert torch.equal(fd.flash_decode_attention(
        q, kv, p, HKV, 0, bt, sc, p_scales=p_scales), want)


def test_scales_from_outside_are_checked():
    q, kv, sc = _inputs(160, 3)
    with pytest.raises(ValueError, match="need int8 mode"):
        fd.flash_decode_attention(q, kv.float(), 159, HKV,
                                  q_scales=_own_q_scales(q))
    with pytest.raises(ValueError, match="p_scales"):
        fd.flash_decode_attention(q, kv, 159, HKV, kv_scales=sc,
                                  p_scales=torch.ones(2, 2))
    with pytest.raises(ValueError, match="q_scales"):
        fd.flash_decode_int8_maxima(q, kv, 159, HKV, 0, None, sc,
                                    torch.ones(2, G))
    with pytest.raises(ValueError, match="needs kv_scales"):
        fd.flash_decode_int8_maxima(q, kv, 159, HKV, 0, None, None)


@pytest.fixture(scope="module")
def quantized():
    return pt.quantize_decode_params(pt.init_params(CFG, seed=0,
                                                    device="cpu"), CFG)


def _mesh_decode(quantized, layout):
    dp, tp, fsdp = LAYOUTS[layout]
    mesh = pmesh.dp_mp_mesh(dp, tp, ["cpu"] * (dp * tp))
    return pt._MeshDecode(CFG, pt.place_transformer_params(
        mesh, quantized, CFG, fsdp))


def _ranks(md, q, kv, sc):
    """The single device's q and cache as each rank of ``md``'s row holds
    them: its query heads packed (b, grp, kv_r*K), its KV heads (or its
    query heads' expanded KV) under the row's one scale a cache row."""
    b, tpad = q.shape[0], kv.shape[3]
    heads = q.view(b, G, HKV, KD).transpose(1, 2).reshape(b, -1, KD)
    qps, kvs = [], []
    for m in range(md.tp):
        mine = torch.arange(m * md.hs, (m + 1) * md.hs)
        qps.append(heads[:, mine].reshape(b, md.kv_r, md.grp, KD)
                   .transpose(1, 2).reshape(b, md.grp, -1).contiguous())
        kvh = (torch.arange(m * md.kv_r, (m + 1) * md.kv_r) if md.kv_split
               else mine // G)
        kvs.append(kv.view(1, 2, b, tpad, HKV, KD)[:, :, :, :, kvh]
                   .reshape(1, 2, b, tpad, -1).contiguous())
    caches = {"kv": pt.Shards(kvs), "scale": pt.Shards([sc] * md.tp)}
    return qps, caches


def _single_order(md, outs):
    """The ranks' outputs (b, grp, kv_r*K) in the single device's (b, G,
    Hkv*K) lane order."""
    b = outs[0].shape[0]
    heads = torch.cat([o.view(b, md.grp, md.kv_r, KD).transpose(1, 2)
                       .reshape(b, md.hs, KD) for o in outs], 1)
    return heads.view(b, HKV, G, KD).transpose(1, 2).reshape(b, G, -1)


def _row_tile(monkeypatch, bt):
    """``_MeshDecode`` takes the row's default tile; a test's other tile
    stands in for that default."""
    if bt is not None:
        monkeypatch.setattr(pt, "default_block_t", lambda *a: bt)


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ranks_under_the_rows_scales_are_the_single_launch(
        quantized, monkeypatch, layout, tiles):
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = _inputs(tpad, 4)
    p = torch.tensor(pos)
    md = _mesh_decode(quantized, layout)
    want = fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc)
    qps, caches = _ranks(md, q, kv, sc)
    _row_tile(monkeypatch, bt)
    got = _single_order(md, md.decode_ranks(caches, 0, p, qps))
    assert torch.equal(got, want), (layout, tiles)


@pytest.mark.parametrize("layout", ["split wkv", "whole wkv"])
def test_ranks_under_the_rows_scales_match_reference(quantized, monkeypatch,
                                                     layout):
    """The reassembled ranks against the reference's Pallas kernel over
    the single device's operands (interpret mode), one tile and ten."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    md = _mesh_decode(quantized, layout)
    for tiles in ("one tile", "ten tiles"):
        tpad, bt, pos = TILES[tiles]
        q, kv, sc = _inputs(tpad, 5)
        p = torch.tensor(pos, dtype=torch.int32)
        qps, caches = _ranks(md, q, kv, sc)
        monkeypatch.undo()
        _row_tile(monkeypatch, bt)
        got = _single_order(md, md.decode_ranks(caches, 0, p, qps))
        ref = pk.flash_decode_attention(
            jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
            jnp.asarray(p.numpy()), HKV, block_t=bt, interpret=True,
            kv_scales=jnp.asarray(sc.numpy()))
        err = np.abs(np.asarray(ref) - got.numpy()).max()
        assert err <= REF_ATOL, (layout, tiles, err)


def test_a_ranks_own_scales_leave_the_single_launch(quantized):
    """The control: each rank's launch under its own scales (over its
    own heads) is not the single-device launch on its lanes."""
    tpad, bt, pos = TILES["one tile"]
    q, kv, sc = _inputs(tpad, 4)
    p = torch.tensor(pos)
    want = fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc)
    for layout in ("split wkv", "whole wkv"):
        md = _mesh_decode(quantized, layout)
        qps, caches = _ranks(md, q, kv, sc)
        own = [fd.flash_decode_attention(qp, caches["kv"][m], p, md.kv_r, 0,
                                         bt, sc)
               for m, qp in enumerate(qps)]
        assert not torch.equal(_single_order(md, own), want), layout


def test_a_ranks_tile_is_the_rows_default(quantized, monkeypatch):
    """At Tpad 8,704 the row's default tile (Hkv*K 256) is 4,352 rows, a
    rank's own (Hkv*K 128) one tile of 8,704: every rank launch, the
    maxima pass and the full pass, takes the row's, and the ranks are
    bitwise the single device's default launch."""
    tpad, _, pos = TILES["two tiles"]
    assert fd.default_block_t(tpad, HKV * KD, 1) == 4352
    assert fd.default_block_t(tpad, KD, 1) == tpad
    q, kv, sc = _inputs(tpad, 6)
    p = torch.tensor(pos)
    want = fd.flash_decode_attention(q, kv, p, HKV, kv_scales=sc)
    md = _mesh_decode(quantized, "split wkv")
    qps, caches = _ranks(md, q, kv, sc)
    tiles = []

    def spy(fn):
        def call(q, kvcache, pos, n_kv_heads, layer=0, block_t=None,
                 *rest, **kw):
            tiles.append(fd._tile(block_t, kvcache, kvcache.shape[3], True))
            return fn(q, kvcache, pos, n_kv_heads, layer, block_t, *rest,
                      **kw)
        return call

    monkeypatch.setattr(pt, "flash_decode_attention",
                        spy(fd.flash_decode_attention))
    monkeypatch.setattr(pt, "flash_decode_int8_maxima",
                        spy(fd.flash_decode_int8_maxima))
    got = _single_order(md, md.decode_ranks(caches, 0, p, qps))
    assert tiles == [4352] * (2 * md.tp)
    assert torch.equal(got, want)


def _random_lane_scales(q, seed: int):
    """Positive q scales that differ across every (group, KV head) lane:
    each lane's own-group scale times a factor in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.random(tuple(q.shape[:2]) + (HKV,))
                         .astype(np.float32) + 0.5).to(q.device)
    return (_own_q_scales(q.float()) * f).contiguous()


@pytest.mark.parametrize("tiles", sorted(TILES))
def test_each_lane_takes_its_own_q_scale(tiles):
    """q scales from outside that differ across the (group, KV head)
    lanes of one launch: each lane's output is that of a launch over its
    KV head alone under its lane's scale (the same weight scales), so a
    lane reads its own (g, h) scale and no other."""
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = _inputs(tpad, 8)
    p = torch.tensor(pos)
    tile = bt or fd.default_block_t(tpad, HKV * KD, 1)
    q_scales = _random_lane_scales(q, 8)
    assert len(set(q_scales[0].flatten().tolist())) == G * HKV
    p_scales = fd._div127(fd.flash_decode_int8_maxima(
        q, kv, p, HKV, 0, tile, sc, q_scales).clamp_min(1e-30))
    got = fd.flash_decode_attention(q, kv, p, HKV, 0, tile, sc, q_scales,
                                    p_scales)
    for h in range(HKV):
        alone = fd.flash_decode_attention(
            q.view(2, G, HKV, KD)[:, :, h].contiguous(),
            kv.view(1, 2, 2, tpad, HKV, KD)[..., h, :].contiguous(), p, 1, 0,
            tile, sc, q_scales[:, :, h:h + 1].contiguous(), p_scales)
        assert torch.equal(got.view(2, G, HKV, KD)[:, :, h], alone), h


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", sorted(TILES))
def test_kernel_modes_bitwise_plain_on_card(cuda_device, tiles):
    """The maxima pass and the full pass under scales from outside (a
    rank's half of the row's lanes, the row's scales, the row's tile)
    bitwise their plain versions; the ranks' rows bitwise the single
    launch's."""
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = (x.to(cuda_device) for x in _inputs(tpad, 7))
    q = q.bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    # the row's tile: a rank's narrower cache would default to its own
    tile = bt or fd.default_block_t(tpad, HKV * KD, 1)
    want = fd.flash_decode_attention(q, kv, p, HKV, 0, bt, sc)
    q_scales = _own_q_scales(q.float())
    ranks = [(q.view(2, G, HKV, KD)[:, :, m].contiguous(),
              kv.view(1, 2, 2, tpad, HKV, KD)[..., m, :].contiguous())
             for m in range(HKV)]
    lane_scales = [q_scales[:, :, m:m + 1].contiguous() for m in range(HKV)]
    maxima = [fd.flash_decode_int8_maxima(qm, kvm, p, 1, 0, tile, sc, qs)
              for (qm, kvm), qs in zip(ranks, lane_scales)]
    plain = [fd.flash_decode_int8_maxima_plain(qm, kvm, p, 1, 0, tile, sc,
                                               qs)
             for (qm, kvm), qs in zip(ranks, lane_scales)]
    assert all(torch.equal(a, b) for a, b in zip(maxima, plain))
    p_scales = fd._div127(torch.stack(maxima).amax(0).clamp_min(1e-30))
    outs = []
    for (qm, kvm), qs in zip(ranks, lane_scales):
        o = fd.flash_decode_attention(qm, kvm, p, 1, 0, tile, sc, qs,
                                      p_scales)
        assert torch.equal(o, fd.flash_decode_attention_plain(
            qm, kvm, p, 1, 0, tile, sc, qs, p_scales))
        outs.append(o)
    assert torch.equal(torch.stack(outs, 2).reshape(want.shape), want)


#: int8 mode on the card against its plain version, in bf16 steps of the
#: output: l, the sum of a tile's softmax weights, is added up in another
#: order, which can move the output's rounding by one step (chip_smoke.py's
#: INT8_STEPS)
INT8_STEPS = 1


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", sorted(TILES))
def test_per_lane_q_scales_on_card(cuda_device, tiles):
    """q scales that differ across every (group, KV head) lane of one
    launch (G 2 x Hkv 2): the maxima pass bitwise its plain version, the
    full pass within one bf16 step of it, and each lane bitwise its KV
    head launched alone under that lane's scale, so the kernel reads
    lane (g, h)'s own scale."""
    tpad, bt, pos = TILES[tiles]
    q, kv, sc = (x.to(cuda_device) for x in _inputs(tpad, 9))
    q = q.bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    tile = bt or fd.default_block_t(tpad, HKV * KD, 1)
    q_scales = _random_lane_scales(q, 9)
    maxima = fd.flash_decode_int8_maxima(q, kv, p, HKV, 0, tile, sc,
                                         q_scales)
    assert torch.equal(maxima, fd.flash_decode_int8_maxima_plain(
        q, kv, p, HKV, 0, tile, sc, q_scales))
    p_scales = fd._div127(maxima.clamp_min(1e-30))
    out = fd.flash_decode_attention(q, kv, p, HKV, 0, tile, sc, q_scales,
                                    p_scales)
    ref = fd.flash_decode_attention_plain(q, kv, p, HKV, 0, tile, sc,
                                          q_scales, p_scales).float()
    step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    assert ((out.float() - ref).abs() / step).max().item() <= INT8_STEPS
    for h in range(HKV):
        alone = fd.flash_decode_attention(
            q.view(2, G, HKV, KD)[:, :, h].contiguous(),
            kv.view(1, 2, 2, tpad, HKV, KD)[..., h, :].contiguous(), p, 1, 0,
            tile, sc, q_scales[:, :, h:h + 1].contiguous(), p_scales)
        assert torch.equal(out.view(2, G, HKV, KD)[:, :, h], alone), h
