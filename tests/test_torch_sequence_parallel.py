"""The sequence-sharded LSTM of the port (``parallel/sequence_parallel.py``
``sequence_sharded_lstm``) on ``["cpu"] * 8``, held against the layer's
own ``scan_hidden`` and the JAX package's ``sequence_sharded_lstm`` on its
8 virtual devices (the LSTM case of ``tests/test_sequence_parallel.py``).

Tolerance: ``ATOL`` against the reference (the reference's bar); the
port's chunked scan is its ``scan_hidden`` bit for bit (the same steps in
the same order)."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.parallel import data_parallel_mesh as jmesh
from deeplearning4j_tpu.parallel.sequence_parallel import (
    sequence_sharded_lstm as jsharded,
)
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    sequence_sharded_lstm,
)

torch.set_num_threads(1)

ATOL = 1e-4


def test_sequence_sharded_lstm_matches_single_device():
    v = 8
    jc = JC.LayerConfig(layer_type="lstm", n_in=v, n_out=v, activation="tanh")
    jp = JL.get("lstm").init(jax.random.key(0), jc)
    x = np.array(jax.random.normal(jax.random.key(1), (2, 32, v)))
    cfg = C.LayerConfig(layer_type="lstm", n_in=v, n_out=v, activation="tanh")
    mod = L.get("lstm")
    params = {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}
    fn = sequence_sharded_lstm(data_parallel_mesh(devices=["cpu"] * 8), mod,
                               cfg)
    hs, cs = fn(params, torch.from_numpy(x))
    hs_ref, cs_ref = mod.scan_hidden(params, cfg, torch.from_numpy(x))
    assert torch.equal(hs, hs_ref) and torch.equal(cs, cs_ref)
    jhs, jcs = jsharded(jmesh(8), JL.get("lstm"), jc)(jp, x)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="does not split"):
        fn(params, torch.from_numpy(x[:, :30]))
