"""int8 decode in the port, held against the reference on the same numpy
inputs and weights:

- ``quantize_decode_params`` bitwise per leaf, and ``params_from_jax`` of a
  quantized tree;
- the int8 mode of kernel #3's plain version against the reference's
  Pallas kernel in interpret mode, at ``block_t`` 8 and one tile over T,
  and at both sides' default tiles past 64 rows; the default tile rule
  against the reference's;
- ``_decode_builder`` logits (prefill and decode steps) with the int8 KV
  cache over quantized weights, and the weights-only split;
- greedy streams of the port's int8 engine against the reference's int8
  engine, at max_len 32 and 128;
- on the card, the CUDA int8 mode against its plain version (at split
  edges and several tiles), B 1 against B 8 and run against run bitwise.

The reference is imported by fixtures, so the CUDA cases also run where JAX
is not installed (``pytest --noconftest -m cuda`` on the card's machine).
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as pt
from deeplearning4j_tpu_torch.ops import flash_decode as fd

# one intra-op thread: the suite runs several pytest workers on one
# host, where every worker's spinning thread pool would contend for the
# cores
torch.set_num_threads(1)

# f32 on both sides: the integer products are exact and every rounding
# point is the reference's; the summation order and exp's last bit differ
ATOL = 1e-5
# int8 kernel vs plain on the card, in bf16 steps of the output: only l,
# the sum of a tile's softmax weights, is added up in another order, which
# can move the output's bf16 rounding by one step
INT8_STEPS = 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The reference: jax.numpy and its Pallas decode kernel."""
    jnp = pytest.importorskip("jax.numpy")
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    return jnp, pk.flash_decode_attention


def _int8_inputs(b, g, hkv, kd, t, nl, seed):
    """The reference test's inputs (tests/test_pallas_kernels.py:193-210):
    q, and per-row quantized cache planes with their f32 scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, hkv * kd)).astype(np.float32)
    raw = rng.standard_normal((nl, 2, b, t, hkv * kd)).astype(np.float32)
    amax = np.maximum(np.abs(raw).max(-1, keepdims=True), 1e-8)
    scales = (amax / 127.0).astype(np.float32)
    qcache = np.clip(np.round(raw / scales), -127, 127).astype(np.int8)
    return q, qcache, scales


@pytest.mark.parametrize(
    "b,g,hkv,t,pos,layer",
    [
        (2, 1, 2, 32, 31, 0),
        (1, 4, 2, 32, 13, 1),
        (2, 2, 3, 24, 7, 0),
        (3, 2, 2, 32, np.array([0, 31, 9], np.int32), 1),
    ],
)
@pytest.mark.parametrize("one_tile", [False, True], ids=["bt8", "one_tile"])
def test_int8_plain_matches_pallas(ref, b, g, hkv, t, pos, layer, one_tile):
    jnp, flash_decode_attention = ref
    q, qcache, scales = _int8_inputs(b, g, hkv, 16, t, nl=2, seed=3 + b + g)
    bt = t if one_tile else 8
    out_ref = flash_decode_attention(
        jnp.asarray(q), jnp.asarray(qcache), jnp.asarray(pos), hkv,
        layer=layer, block_t=bt, interpret=True,
        kv_scales=jnp.asarray(scales))
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    out = fd.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(qcache), tpos, hkv, layer,
        block_t=bt, kv_scales=torch.from_numpy(scales))
    assert out.shape == q.shape and out.dtype == torch.float32
    assert np.abs(np.asarray(out_ref) - out.numpy()).max() <= ATOL


def test_int8_default_tile_is_one_tile_up_to_64_rows():
    """The port's default int8 tile is the reference's rule
    (:func:`fd.default_block_t`): at these widths one tile over the whole
    128-row cache. Up to 64 rows that is also the 64-row tiling; past 64
    rows the tiling changes the function (one softmax-weight scale per
    tile), and the default is the one-tile function."""
    q, qcache, scales = _int8_inputs(2, 1, 2, 16, 128, nl=1, seed=8)
    assert fd.default_block_t(128, 32, 1) == 128
    args = (torch.from_numpy(q), torch.from_numpy(qcache))
    sc = torch.from_numpy(scales)
    for pos in (40, 63):
        a = fd.flash_decode_attention(*args, pos, 2, kv_scales=sc)
        b = fd.flash_decode_attention(*args, pos, 2, block_t=64, kv_scales=sc)
        c = fd.flash_decode_attention(*args, pos, 2, block_t=128,
                                      kv_scales=sc)
        assert torch.equal(a, b) and torch.equal(a, c)
    a = fd.flash_decode_attention(*args, 127, 2, kv_scales=sc)
    b = fd.flash_decode_attention(*args, 127, 2, block_t=128, kv_scales=sc)
    c = fd.flash_decode_attention(*args, 127, 2, block_t=64, kv_scales=sc)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize(
    "t,g,hkv,kd",
    [
        (256, 1, 2, 16),
        (640, 2, 3, 16),
    ],
)
def test_int8_default_tile_matches_reference_default(ref, t, g, hkv, kd):
    """The port's int8 decode at its default tile against the reference's
    at ITS default ``block_t`` (neither side passes one), with positions
    past 64 rows: a 64-row default tile is a different function there."""
    jnp, flash_decode_attention = ref
    q, qcache, scales = _int8_inputs(4, g, hkv, kd, t, nl=1, seed=t + hkv)
    pos = np.array([0, 64, 65, t - 1], np.int32)
    out_ref = flash_decode_attention(
        jnp.asarray(q), jnp.asarray(qcache), jnp.asarray(pos), hkv,
        interpret=True, kv_scales=jnp.asarray(scales))
    out = fd.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(qcache), torch.from_numpy(pos),
        hkv, kv_scales=torch.from_numpy(scales))
    assert np.abs(np.asarray(out_ref) - out.numpy()).max() <= ATOL


class _Stop(Exception):
    pass


@pytest.mark.parametrize(
    "t,hk,dtype",
    [
        (24, 32, "float32"),
        (640, 768, "int8"),
        (640, 2048, "int8"),
        (8704, 256, "int8"),
        (8704, 256, "bfloat16"),
        (1000, 2048, "bfloat16"),
        (1024, 4096, "float32"),
    ],
)
def test_default_block_t_is_the_references(ref, monkeypatch, t, hk, dtype):
    """:func:`fd.default_block_t` against the tile the reference's
    ``flash_decode_attention`` picks for the same cache (read off the grid
    it hands to ``pallas_call``, which is stopped before it runs)."""
    jnp, flash_decode_attention = ref
    pk = pytest.importorskip("deeplearning4j_tpu.ops.pallas_kernels")
    seen = {}

    def stop(kernel, *, grid, **kw):
        seen["n_t"] = grid[1]
        raise _Stop

    monkeypatch.setattr(pk.pl, "pallas_call", stop)
    cache = jnp.zeros((1, 2, 1, t, hk), getattr(jnp, dtype))
    scales = (jnp.zeros((1, 2, 1, t, 1), jnp.float32) if dtype == "int8"
              else None)
    with pytest.raises(_Stop):
        flash_decode_attention(jnp.zeros((1, 1, hk), jnp.float32), cache, 0,
                               1, kv_scales=scales)
    itemsize = np.dtype(jnp.dtype(getattr(jnp, dtype))).itemsize
    assert fd.default_block_t(t, hk, itemsize) == t // seen["n_t"]


def _card_case(device, g, hkv, seed, b=8):
    """GPT-2-small's decode shape in int8 (B 8, 12 layers, Tpad 640, head
    dim 128), positions 0 and 639 among them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kd, nl, t = 128, 12, 640
    q = torch.randn((b, g, hkv * kd), generator=gen, device=device,
                    dtype=torch.bfloat16)
    cache = torch.randint(-127, 128, (nl, 2, b, t, hkv * kd), generator=gen,
                          device=device, dtype=torch.int8)
    scales = torch.rand((nl, 2, b, t, 1), generator=gen, device=device) * 0.02
    pos = torch.tensor([0, 639, 1, 63, 64, 65, 300, 511], dtype=torch.int32,
                       device=device)
    return q, cache, scales, pos


def _steps(out, ref):
    """max |out - ref| in bf16 steps (ulps) of ref's binade."""
    r = ref.float()
    step = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return ((out.float() - r).abs() / step).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("g,hkv", [(1, 6), (3, 2), (1, 12)])
def test_int8_kernel_matches_plain_on_card(cuda_device, g, hkv):
    q, cache, scales, pos = _card_case(cuda_device, g, hkv, seed=10 + g)
    before = (fd.launches, fd.int8_launches)
    out = fd.flash_decode_attention(q, cache, pos, hkv, layer=7,
                                    kv_scales=scales)
    assert (fd.launches, fd.int8_launches) == (before[0], before[1] + 1)
    ref = fd.flash_decode_attention_plain(q, cache, pos, hkv, layer=7,
                                          kv_scales=scales)
    assert _steps(out, ref) <= INT8_STEPS
    # a tile that is not a multiple of 8 is refused; 8 is honoured
    with pytest.raises(ValueError, match="block_t"):
        fd.flash_decode_attention(q, cache, pos, hkv, layer=7, block_t=12,
                                  kv_scales=scales)
    out8 = fd.flash_decode_attention(q, cache, pos, hkv, layer=7, block_t=8,
                                     kv_scales=scales)
    ref8 = fd.flash_decode_attention_plain(q, cache, pos, hkv, layer=7,
                                           block_t=8, kv_scales=scales)
    assert _steps(out8, ref8) <= INT8_STEPS


#: n = pos + 1 on either side of the kernels' split edges (rows per split a
#: multiple of 8 of n / 16: 8 -> 16 at n 129, 32 -> 40 at n 513), and 0
SPLIT_EDGE_POS = [0, 7, 8, 127, 128, 511, 512, 639]


@pytest.mark.cuda
@pytest.mark.parametrize("block_t", [None, 320, 64, 8])
def test_int8_kernel_split_edges_on_card(cuda_device, block_t):
    """Kernel vs plain at positions on either side of every split edge,
    at the default tile (640 here), a tile the rule yields at hk 2048
    (320) and smaller ones (64, and 8 = the reference's paged tiling at
    block size 8)."""
    q, cache, scales, _ = _card_case(cuda_device, 1, 6, seed=21)
    pos = torch.tensor(SPLIT_EDGE_POS, dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, pos, 6, layer=3,
                                    block_t=block_t, kv_scales=scales)
    ref = fd.flash_decode_attention_plain(q, cache, pos, 6, layer=3,
                                          block_t=block_t, kv_scales=scales)
    assert _steps(out, ref) <= INT8_STEPS


@pytest.mark.cuda
def test_int8_kernel_scores_in_scratch_on_card(cuda_device):
    """A tile whose scores do not fit in shared memory (G 8 x Hkv 8 lanes,
    one 2048-row tile: 256 rows a block) goes through the wrapper's scratch
    tensor: kernel vs plain as at the serving shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    b, g, hkv, kd, t = 2, 8, 8, 16, 2048
    assert fd.default_block_t(t, hkv * kd, 1) == t
    q = torch.randn((b, g, hkv * kd), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    cache = torch.randint(-127, 128, (1, 2, b, t, hkv * kd), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    scales = torch.rand((1, 2, b, t, 1), generator=gen,
                        device=cuda_device) * 0.02
    assert fd._scratch(q, hkv, t, t, True, cache) is not None
    pos = torch.tensor([t - 1, 1000], dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, pos, hkv, kv_scales=scales)
    ref = fd.flash_decode_attention_plain(q, cache, pos, hkv,
                                          kv_scales=scales)
    assert _steps(out, ref) <= INT8_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("g,hkv", [(1, 6), (3, 2)])
def test_int8_kernel_rows_are_batch_independent_on_card(cuda_device, g, hkv):
    """Each row decodes bitwise the same alone (B 1) as in the batch of 8,
    and a second launch repeats the first bitwise."""
    q, cache, scales, _ = _card_case(cuda_device, g, hkv, seed=31)
    pos = torch.tensor(SPLIT_EDGE_POS, dtype=torch.int32, device=cuda_device)
    out = fd.flash_decode_attention(q, cache, pos, hkv, layer=5,
                                    kv_scales=scales)
    again = fd.flash_decode_attention(q, cache, pos, hkv, layer=5,
                                      kv_scales=scales)
    assert torch.equal(out, again)
    for i in range(q.shape[0]):
        one = fd.flash_decode_attention(
            q[i:i + 1].contiguous(), cache[:, :, i:i + 1].contiguous(),
            pos[i:i + 1], hkv, layer=5,
            kv_scales=scales[:, :, i:i + 1].contiguous())
        assert torch.equal(one[0], out[i])


# -- weights, decode builder and engine against the reference -------------------

@pytest.fixture(scope="module")
def jt():
    """The reference's transformer module (JAX on the CPU)."""
    return pytest.importorskip("deeplearning4j_tpu.models.transformer")


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _configs(jt):
    base = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, max_len=32)
    return {
        "mha": base,
        # the reference engine test's int8 config (tests/test_serving.py
        # :109-112): GQA + RoPE
        "gqa_rope": dataclasses.replace(base, n_kv_heads=2, rope=True),
    }


def _pair(jt, name, decode_int8, seed=0, **kw):
    """Reference config + float params, and the port's counterparts."""
    import jax

    jcfg = dataclasses.replace(_configs(jt)[name], decode_int8=decode_int8,
                               **kw)
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    tcfg = pt.TransformerConfig.from_json(jcfg.to_json())
    tparams = pt.params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("name", ["mha", "gqa_rope"])
def test_quantize_decode_params_bitwise(jt, name):
    jcfg, jparams, tcfg, tparams = _pair(jt, name, decode_int8=True)
    jq = _np_tree(jt.quantize_decode_params(jparams, jcfg))
    tq = pt.quantize_decode_params(tparams, tcfg)
    flat = lambda t: dict(pt._leaves(t))  # noqa: E731
    jflat, tflat = flat(jq), flat(tq)
    assert set(jflat) == set(tflat)
    for path, ref in jflat.items():
        got = tflat[path].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=str(path))
    # a quantized reference tree carries over leaf for leaf
    loaded = flat(pt.params_from_jax(jq, tcfg, device="cpu"))
    for path, ref in jflat.items():
        np.testing.assert_array_equal(loaded[path].numpy(), ref)
    # cast_params passes int8 leaves and their scales, not the norms
    bcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    cast = pt._decode_builder(bcfg)[3](tq)
    assert cast["head"].dtype == torch.int8
    assert cast["head_scale"].dtype == torch.float32
    blocks = cast["blocks"]
    assert blocks["w1"].dtype == torch.int8
    assert blocks["w1_scale"].dtype == torch.float32
    assert blocks["ln1_scale"].dtype == torch.bfloat16
    assert blocks["b1"].dtype == torch.bfloat16


def test_params_from_jax_checks_scale_shapes(jt):
    jcfg, jparams, tcfg, _ = _pair(jt, "mha", decode_int8=True)
    jq = _np_tree(jt.quantize_decode_params(jparams, jcfg))
    jq["blocks"]["wo_scale"] = jq["blocks"]["wo_scale"][..., :1]
    with pytest.raises(ValueError, match="wo_scale"):
        pt.params_from_jax(jq, tcfg, device="cpu")


# f32 logits through int8 weights and an int8 cache: the frameworks'
# matmuls sum in different orders, and every quantization rounds the same
LOGIT_ATOL = 1e-4


@pytest.mark.parametrize("name", ["mha", "gqa_rope"])
@pytest.mark.parametrize("decode_int8", [True, False], ids=["full",
                                                            "weights"])
def test_decode_builder_int8_logits(jt, name, decode_int8):
    """Prefill plus 3 decode steps (scalar positions, then per-row ones)
    with quantized weights, over the int8 KV cache ("full") or a float one
    ("weights", the reference's weights-only split)."""
    import jax
    import jax.numpy as jnp

    jcfg, jparams, tcfg, tparams = _pair(jt, name, decode_int8)
    jq = jt.quantize_decode_params(jparams, jcfg)
    tq = pt.quantize_decode_params(tparams, tcfg)
    jfwd, jinit, jprefill, jcast = jt._decode_builder(jcfg)
    jfwd, jprefill = jax.jit(jfwd), jax.jit(jprefill)
    tfwd, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    jp, tp_ = jcast(jq), tcast(tq)
    prompt = np.random.default_rng(1).integers(0, 64, (2, 9)).astype(
        np.int32)
    jcache, jl = jprefill(jp, jinit(2, 24), jnp.asarray(prompt))
    tcache, tl = tprefill(tp_, tinit(2, 24, "cpu"), torch.from_numpy(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    if decode_int8:
        assert tcache["kv"].dtype == torch.int8
        assert tcache["scale"].shape == (2, 2, 2, 24, 1)
        np.testing.assert_array_equal(tcache["kv"].numpy(),
                                      np.asarray(jcache["kv"]))
    toks = np.random.default_rng(5).integers(0, 64, (2, 3)).astype(np.int32)
    for i in range(3):
        jl, jcache = jfwd(jp, jcache, jnp.asarray(toks[:, i]), 9 + i)
        tl, tcache = tfwd(tp_, tcache, torch.from_numpy(toks[:, i]), 9 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    pos = np.array([12, 4], np.int32)
    jl, _ = jfwd(jp, jcache, jnp.asarray(toks[:, 0]), jnp.asarray(pos))
    tl, _ = tfwd(tp_, tcache, torch.from_numpy(toks[:, 0]),
                 torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


def test_int8_dense_chunk_path(jt):
    """decode_kernel=False and the chunked forward over an int8 cache: the
    rows are quantized on write and the cache dequantized for the dense
    attention."""
    import jax
    import jax.numpy as jnp

    jcfg, jparams, tcfg, tparams = _pair(jt, "gqa_rope", decode_int8=True)
    jcfg = dataclasses.replace(jcfg, decode_kernel=False)
    tcfg = dataclasses.replace(tcfg, decode_kernel=False)
    jq = jt.quantize_decode_params(jparams, jcfg)
    tq = pt.quantize_decode_params(tparams, tcfg)
    _, jinit, jprefill, jcast = jt._decode_builder(jcfg)
    jfwd = jax.jit(jt._decode_builder(jcfg)[0])
    tfwd, tinit, tprefill, tcast = pt._decode_builder(tcfg)
    jp, tp_ = jcast(jq), tcast(tq)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 8)).astype(
        np.int32)
    jcache, _ = jax.jit(jprefill)(jp, jinit(2, 24), jnp.asarray(prompt))
    tcache, _ = tprefill(tp_, tinit(2, 24, "cpu"), torch.from_numpy(prompt))
    chunk = np.random.default_rng(9).integers(0, 64, (2, 8)).astype(np.int32)
    jchunk = jax.jit(jt._chunk_builder(jcfg), static_argnames="last_idx")
    jl, jcache = jchunk(jp, jcache, jnp.asarray(chunk), 8)
    tl, tcache = pt._chunk_builder(tcfg)(tp_, tcache,
                                         torch.from_numpy(chunk), 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    pos = np.array([16, 9], np.int32)
    tok = np.array([3, 7], np.int32)
    jl, _ = jfwd(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = tfwd(tp_, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


# a greedy token may differ across frameworks only where the top-2 logit
# gap is below this
NEAR_TIE = 1e-4


def _engine_parity(jt, max_len, prompt_range, new_range, seed):
    """Greedy streams of the reference's int8 engine and the port's, on the
    reference test's config (GQA + RoPE, full int8) at ``max_len``, the
    same requests and weights; both engines' streams also equal the port's
    generate."""
    from deeplearning4j_tpu.serving import Request as JRequest
    from deeplearning4j_tpu.serving import ServingEngine as JEngine
    from deeplearning4j_tpu_torch.serving import Request, ServingEngine

    jcfg, jparams, tcfg, tparams = _pair(jt, "gqa_rope", decode_int8=True,
                                         max_len=max_len)
    jq = jt.quantize_decode_params(jparams, jcfg)
    tq = pt.quantize_decode_params(tparams, tcfg)
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(5):
        tp = int(rng.integers(*prompt_range))
        specs.append((rng.integers(0, 64, (tp,)).astype(np.int32),
                      int(rng.integers(new_range[0],
                                       min(new_range[1], max_len - tp)))))
    jengine = JEngine(jcfg, jq, n_slots=2, temperature=0.0)
    jreqs = [JRequest(prompt=p, max_new=m) for p, m in specs]
    for r in jreqs:
        jengine.submit(r)
    jres = jengine.run()
    engine = ServingEngine(tcfg, tq, n_slots=2, decode_horizon=4,
                           device="cpu")
    reqs = [Request(prompt=p, max_new=m) for p, m in specs]
    for r in reqs:
        engine.submit(r)
    res = engine.run()
    gen = pt.transformer_generate(tcfg)
    for jr, r in zip(jreqs, reqs):
        ref, logits = gen(tq, torch.from_numpy(r.prompt[None]).long(),
                          r.max_new, temperature=0.0, return_logits=True)
        np.testing.assert_array_equal(res[r.id], ref[0].numpy())
        a, b = np.asarray(jres[jr.id]), res[r.id]
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            i = int(diff[0]) - len(r.prompt)
            top2 = np.sort(logits[i, 0].numpy())[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (r.id, i, top2)
    return specs


def test_int8_engine_matches_reference_engine(jt):
    """The reference engine test's setting: max_len 32 (one tile either
    way)."""
    _engine_parity(jt, 32, (3, 10), (4, 12), seed=3)


def test_int8_engine_matches_reference_engine_past_64_rows(jt):
    """max_len 128: prompts of 50-80 tokens decode past row 64, where the
    reference's one-tile default and a 64-row tiling differ."""
    specs = _engine_parity(jt, 128, (50, 80), (16, 40), seed=4)
    assert max(len(p) + m for p, m in specs) > 80
