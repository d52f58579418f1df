"""LSTM, Karpathy char-RNN style (the JAX package's ``nn/layers/lstm.py``):
each step's input is ``[1, x_t, h_{t-1}]`` against one fused
``recurrentweights`` matrix of shape ``(1 + n_in + hidden, 4*hidden)``
(hidden == n_in, the char-RNN convention); gates ``i, f, o`` (sigmoid) then
``g`` (tanh); ``c_t = i*g + f*c_{t-1}``, ``h_t = o*tanh(c_t)`` (``o*c_t``
for a non-tanh activation); the decoder ``y = h @ decoderweights +
decoderbias``. The reference's ``lax.scan`` over time is a Python loop and
BPTT is autodiff through it.

Beam-search decoding (the reference's ``beam_search`` and
``beam_search_host``) comes with the char-LSTM model in a later slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import (
    DECODER_BIAS,
    DECODER_WEIGHTS,
    RECURRENT_WEIGHTS,
    Params,
)


@api.register("lstm")
class LSTMLayer:
    """conf.n_in = input feature size (== hidden size); conf.n_out =
    decoder output size (vocab)."""

    def hidden_size(self, conf: LayerConfig) -> int:
        return conf.n_in

    def init(self, key, conf: LayerConfig, device=None) -> Params:
        device = resolve_device(device)
        d = self.hidden_size(conf)
        k1, k2 = rng.split(key)
        return {
            RECURRENT_WEIGHTS: weights.init_weights(
                k1, (1 + conf.n_in + d, 4 * d), conf.weight_init, conf.dist,
                device=device),
            DECODER_WEIGHTS: weights.init_weights(
                k2, (d, conf.n_out), conf.weight_init, conf.dist,
                device=device),
            DECODER_BIAS: torch.zeros((conf.n_out,),
                                      dtype=dtypes.get_policy().param_dtype,
                                      device=device),
        }

    # -- core recurrence ---------------------------------------------------
    def _gates(self, conf: LayerConfig, wr: torch.Tensor, x_t, h_prev):
        """Fused gate computation for one step; x_t/h_prev are (B, F)."""
        d = self.hidden_size(conf)
        ones = torch.ones(x_t.shape[:-1] + (1,), dtype=x_t.dtype,
                          device=x_t.device)
        with dtypes.precision():
            ifog = torch.cat([ones, x_t, h_prev], dim=-1) @ wr
        i = torch.sigmoid(ifog[..., :d])
        f = torch.sigmoid(ifog[..., d:2 * d])
        o = torch.sigmoid(ifog[..., 2 * d:3 * d])
        g = torch.tanh(ifog[..., 3 * d:])
        return i, f, o, g

    def _hout(self, conf: LayerConfig, o, c):
        if conf.activation == "tanh":
            return o * torch.tanh(c)
        return o * c

    def scan_hidden(self, params: Params, conf: LayerConfig, x: torch.Tensor):
        """Run the recurrence over (B, T, F) input -> (hs, cs) each (B, T, d)."""
        policy = dtypes.get_policy()
        wr = policy.cast_to_compute(params[RECURRENT_WEIGHTS])
        x = policy.cast_to_compute(x)
        d = self.hidden_size(conf)
        h = torch.zeros((x.shape[0], d), dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        hs, cs = [], []
        for t in range(x.shape[1]):
            i, f, o, g = self._gates(conf, wr, x[:, t], h)
            c = i * g + f * c
            h = self._hout(conf, o, c)
            hs.append(h)
            cs.append(c)
        return torch.stack(hs, dim=1), torch.stack(cs, dim=1)

    def decode(self, params: Params, conf: LayerConfig,
               h: torch.Tensor) -> torch.Tensor:
        policy = dtypes.get_policy()
        wd = policy.cast_to_compute(params[DECODER_WEIGHTS])
        with dtypes.precision(policy):
            return h @ wd + params[DECODER_BIAS].to(wd.dtype)

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        """(B, T, n_in) -> (B, T, n_out) decoder logits (all T outputs; the
        caller aligns targets). The same key masks the input and the hidden
        states, as the reference's."""
        x = api.apply_dropout(x, conf, key, training)
        hs, _ = self.scan_hidden(params, conf, x)
        hs = api.apply_dropout(hs, conf, key, training)
        return self.decode(params, conf, hs)

    def supervised_score(self, params: Params, conf: LayerConfig,
                         x: torch.Tensor, labels: torch.Tensor, key=None,
                         training: bool = False) -> torch.Tensor:
        """Next-step cross-entropy over the sequence (one-hot labels (B,T,V))."""
        logits = self.activate(params, conf, x, key, training)
        logp = torch.log_softmax(logits, dim=-1)
        return (-torch.mean(torch.sum(labels * logp, dim=-1))
                + api.l2_penalty(params, conf))

    def tick(self, params: Params, conf: LayerConfig, x_t, h, c):
        """One decode step: (y_logits, h', c'); x_t/h/c are (F,)/(d,)."""
        i, f, o, g = self._gates(conf, params[RECURRENT_WEIGHTS], x_t[None, :],
                                 h[None, :])
        c2 = (i * g + f * c[None, :])[0]
        h2 = self._hout(conf, o[0], c2)
        y = self.decode(params, conf, h2[None, :])[0]
        return y, h2, c2
