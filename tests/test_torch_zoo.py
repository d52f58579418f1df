"""The rest of the DL4J model zoo in the port, held against the JAX
package's on the CPU: AlexNet (its synthetic CIFAR, init, three-channel
NHWC rows and the conv -> dense flatten, a trainer step, ``train --model
alexnet``), the char-LSTM (fit, sample, beam decode) with the LSTM layer's
beam search (the reference's three beam tests of ``tests/test_layers.py``),
and ``train --model lenet --coordinator`` over two gloo processes against
one process.

Tolerances: ``OUT_ATOL`` for f32 probabilities, ``LOSS_RTOL`` for f32
losses after a few steps (sums in other orders), ``BEAM_TOL`` for beam
scores (the reference's bar), ``PROC_RTOL`` for two processes against one
(here they agree bitwise) and ``DP_RTOL`` for two data ranks against one
(the f32 gradients averaged over the ranks, where one rank's are the
batch's)."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.models import alexnet as jalexnet
from deeplearning4j_tpu.models.char_lstm import CharLSTM as JCharLSTM
from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu_torch import cli, rng
from deeplearning4j_tpu_torch.models import alexnet, lenet, multilayer
from deeplearning4j_tpu_torch.models.char_lstm import CharLSTM
from deeplearning4j_tpu_torch.models.multilayer import (
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.parallel.data_parallel import DataParallelTrainer
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
OUT_ATOL = 1e-5
LOSS_RTOL = 1e-4
BEAM_TOL = 1e-5
PROC_RTOL = 1e-5
DP_RTOL = 1e-6
TEXT = "hello world " * 40


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


# -- AlexNet ------------------------------------------------------------------

def test_alexnet_data_init_and_forward_match_the_reference():
    """synthetic_cifar's arrays and the seed-0 init bit for bit; the
    probabilities from the reference's params within OUT_ATOL."""
    ds, jds = alexnet.synthetic_cifar(16, seed=2), jalexnet.synthetic_cifar(
        16, seed=2)
    np.testing.assert_array_equal(ds.features, jds.features)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    jnet, jparams = jalexnet.build_alexnet(0)
    net, params = alexnet.build_alexnet(0, device="cpu")
    for got, want in zip(params_to_jax(params, net.conf), _np(jparams)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = net.output(ds.features[:4])
    assert out.shape == (4, 10)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnet.output(ds.features[:4])),
                               rtol=0, atol=OUT_ATOL)


def test_alexnet_reads_three_channel_rows_and_flattens_nhwc(monkeypatch):
    """A flat row is the reference's (32, 32, 3) NHWC image and the last
    256 x 2 x 2 block reaches the dense head flattened H, W, C: reading
    the row as C, H, W, or flattening the block as C, H, W, moves the
    probabilities far off the reference's (this test sees either)."""
    jnet, jparams = jalexnet.build_alexnet(1)
    net = multilayer.MultiLayerNetwork(alexnet.alexnet_cifar_config(),
                                       device="cpu")
    net.params = params_from_jax(_np(jparams), net.conf, device="cpu")
    x = alexnet.synthetic_cifar(8, seed=5).features
    ref = np.asarray(jnet.output(x))
    np.testing.assert_allclose(net.output(x).numpy(), ref, rtol=0,
                               atol=OUT_ATOL)
    real = multilayer._adapt_input

    def chw_rows(x, layer_type, channels):
        if layer_type == "conv_downsample" and x.ndim == 2:
            return x.reshape(x.shape[0], channels, 32, 32)
        return real(x, layer_type, channels)

    def chw_flatten(x, layer_type, channels):
        if layer_type == "dense" and x.ndim == 4:
            return x.reshape(x.shape[0], -1)
        return real(x, layer_type, channels)

    for wrong in (chw_rows, chw_flatten):
        monkeypatch.setattr(multilayer, "_adapt_input", wrong)
        assert np.abs(net.output(x).numpy() - ref).max() > 1e-3, wrong
    monkeypatch.setattr(multilayer, "_adapt_input", real)


def test_alexnet_forward_and_one_step():
    """The reference's case on the port, and 2 trainer steps over two data
    ranks equal to one rank's (``DP_RTOL``; the CLI test below holds the
    trainer against the reference's)."""
    net, params = alexnet.build_alexnet(0, device="cpu")
    ds = alexnet.synthetic_cifar(16)
    assert net.output(ds.features[:4]).shape == (4, 10)
    loss_fn = lenet.lenet_loss(net)
    l0 = loss_fn(params, torch.from_numpy(ds.features),
                 torch.from_numpy(ds.labels)).item()
    assert np.isfinite(l0)
    runs = {}
    for dp in (1, 2):
        trainer = DataParallelTrainer(loss_fn, mesh=data_parallel_mesh(
            devices=["cpu"] * dp))
        state, runs[dp] = trainer.init(params), []
        for i in range(2):
            state, value = trainer.step(state, *trainer.shard_batch(
                ds.features, ds.labels), rng.key_for(i))
            runs[dp].append(value.item())
    np.testing.assert_allclose(runs[2], runs[1], rtol=DP_RTOL)


def _final(text: str, unrounded: bool = False) -> float:
    pattern = (r"^final loss unrounded (\S+)$" if unrounded
               else r"^final loss ([0-9.]+)$")
    m = re.search(pattern, text, re.M)
    assert m is not None, text
    return float(m.group(1))


def test_train_cli_alexnet_matches_the_reference(capsys):
    """``train --model alexnet --device cpu --examples 64 --batch 32``
    against the reference's ``cmd_train`` at the same flags: the final
    loss within LOSS_RTOL (printed to 4 places)."""
    flags = ["train", "--model", "alexnet", "--examples", "64", "--batch",
             "32"]
    assert cli.main([*flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"ms a step over steps 2-2 \(batch 32, 1 data rank",
                     out), out
    assert jcli.main(flags) == 0
    ref = _final(capsys.readouterr().out)
    assert abs(_final(out) - ref) <= max(LOSS_RTOL * ref, 1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_lenet_over_two_processes(capsys):
    """Two ``train --model lenet --coordinator`` processes over gloo on
    the CPU (global data axis 2, each process its rows of every batch):
    both print the one-process run's unrounded final loss within
    PROC_RTOL, and the bucket line."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    flags = ["train", "--model", "lenet", "--device", "cpu", "--examples",
             "128", "--batch", "64"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", *flags,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(2)]
    assert cli.main(flags) == 0
    want = _final(capsys.readouterr().out, unrounded=True)
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out)
    for i, out in enumerate(outs):
        assert (f"training on a data axis of 2 across 2 processes (process "
                f"{i}: data rows {i}-{i})") in out
        assert re.search(r"^data axis across 2 processes \(gloo\): one "
                         r"bucket of \d+ bytes", out, re.M), out
        assert abs(_final(out, unrounded=True) - want) <= PROC_RTOL * want


# -- the char-LSTM and the LSTM's beam search ---------------------------------

def test_char_lstm_learns_and_samples():
    """The reference's case on the port."""
    m = CharLSTM(seq_len=12, lr=1.0, seed=0, device="cpu")
    losses = m.fit(TEXT, epochs=25, batch=8)
    assert losses[-1] < losses[0] * 0.3, losses
    out = m.sample("h", length=20, rng_seed=1)
    assert len(out) == 21
    assert set(out) <= set(TEXT)
    beams = m.beam_decode("h", beam_size=2, n_steps=4)
    assert beams and all(lp <= 0 for _, lp in beams)


def test_char_lstm_matches_the_reference():
    """The seed's init bit for bit; 3 epochs' losses within LOSS_RTOL;
    from the reference's fitted params, the samples (two temperatures, on
    the reference's key chain) and the beams equal, scores within
    BEAM_TOL."""
    jm, m = JCharLSTM(seq_len=12, lr=1.0, seed=0), CharLSTM(
        seq_len=12, lr=1.0, seed=0, device="cpu")
    jm.build_vocab(TEXT)
    m.build_vocab(TEXT)
    for k, v in jm.params.items():
        np.testing.assert_array_equal(m.params[k].numpy(), np.asarray(v))
    np.testing.assert_allclose(m.fit(TEXT, epochs=3, batch=8),
                               jm.fit(TEXT, epochs=3, batch=8),
                               rtol=LOSS_RTOL)
    m.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()})
    for temperature in (1.0, 0.7):
        assert (m.sample("h", length=30, temperature=temperature,
                         rng_seed=3)
                == jm.sample("h", length=30, temperature=temperature,
                             rng_seed=3))
    got, want = m.beam_decode("w", 3, 6), jm.beam_decode("w", 3, 6)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=BEAM_TOL, atol=BEAM_TOL)


def _lstm(v, seed):
    """The reference's LSTM layer (seed ``seed``) and the port's from its
    params: (jconf, jparams, conf, params)."""
    jc = JC.LayerConfig(layer_type="lstm", n_in=v, n_out=v)
    jp = JL.get("lstm").init(jax.random.key(seed), jc)
    p = {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}
    return jc, jp, C.LayerConfig(layer_type="lstm", n_in=v, n_out=v), p


def test_lstm_beam_search_decodes():
    mod = L.get("lstm")
    cfg = C.LayerConfig(layer_type="lstm", n_in=6, n_out=6)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    emb = torch.eye(6)
    beams = mod.beam_search(p, cfg, emb[1], emb, beam_size=3, n_steps=5)
    assert len(beams) <= 3
    for idxs, logp in beams:
        assert all(0 <= i < 6 for i in idxs)
        assert logp <= 0.0


def test_lstm_device_beam_matches_host_oracle():
    """The batched beam search reproduces the host loop (beams, scores,
    order) over several seeds, and both the reference's device beam."""
    mod, jmod = L.get("lstm"), JL.get("lstm")
    emb, jemb = torch.eye(7), jnp.eye(7)
    for seed in range(4):
        jc, jp, cfg, p = _lstm(7, seed)
        dev = mod.beam_search(p, cfg, emb[1], emb, beam_size=3, n_steps=6)
        host = mod.beam_search_host(p, cfg, emb[1], emb, beam_size=3,
                                    n_steps=6)
        ref = jmod.beam_search(jp, jc, jemb[1], jemb, beam_size=3, n_steps=6)
        assert [i for i, _ in dev] == [i for i, _ in host], (dev, host)
        assert [i for i, _ in dev] == [i for i, _ in ref], (dev, ref)
        np.testing.assert_allclose([s for _, s in dev], [s for _, s in host],
                                   rtol=BEAM_TOL, atol=BEAM_TOL)
        np.testing.assert_allclose([s for _, s in dev], [s for _, s in ref],
                                   rtol=BEAM_TOL, atol=BEAM_TOL)


def test_beam_ties_take_the_lower_index():
    """Equal candidates go in index order, as ``lax.top_k`` takes them: a
    decoder that scores every token alike gives beams 0, 1, 2 (W 3) of
    the first step, where ``torch.topk``'s order is not promised."""
    mod = L.get("lstm")
    cfg = C.LayerConfig(layer_type="lstm", n_in=5, n_out=5)
    p = mod.init(rng.key_for(0), cfg, device="cpu")
    p["decoderweights"] = torch.zeros_like(p["decoderweights"])
    emb = torch.eye(5)
    beams = mod.beam_search(p, cfg, emb[2], emb, beam_size=3, n_steps=1)
    assert [t for t, _ in beams] == [[0], [1], [2]]
    assert beams == mod.beam_search_host(p, cfg, emb[2], emb, beam_size=3,
                                         n_steps=1)


def test_lstm_beam_width1_equals_greedy():
    mod = L.get("lstm")
    cfg = C.LayerConfig(layer_type="lstm", n_in=5, n_out=5)
    p = mod.init(rng.key_for(3), cfg, device="cpu")
    emb = torch.eye(5)
    n = 6
    (beam_idxs, beam_lp), = mod.beam_search(p, cfg, emb[2], emb,
                                            beam_size=1, n_steps=n)
    h, c = torch.zeros(5), torch.zeros(5)
    _, h, c = mod.tick(p, cfg, emb[2], h, c)
    greedy, lp, prev = [], 0.0, 0
    for _ in range(n):
        y, h, c = mod.tick(p, cfg, emb[prev], h, c)
        logp = torch.log_softmax(y, dim=-1)
        prev = int(torch.argmax(logp))
        lp += float(logp[prev])
        greedy.append(prev)
        if prev == 0:
            break
    assert beam_idxs == greedy, (beam_idxs, greedy)
    np.testing.assert_allclose(beam_lp, lp, rtol=BEAM_TOL, atol=BEAM_TOL)
