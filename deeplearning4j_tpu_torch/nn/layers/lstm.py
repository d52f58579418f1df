"""LSTM, Karpathy char-RNN style (the JAX package's ``nn/layers/lstm.py``):
each step's input is ``[1, x_t, h_{t-1}]`` against one fused
``recurrentweights`` matrix of shape ``(1 + n_in + hidden, 4*hidden)``
(hidden == n_in, the char-RNN convention); gates ``i, f, o`` (sigmoid) then
``g`` (tanh); ``c_t = i*g + f*c_{t-1}``, ``h_t = o*tanh(c_t)`` (``o*c_t``
for a non-tanh activation); the decoder ``y = h @ decoderweights +
decoderbias``. The reference's ``lax.scan`` over time is a Python loop and
BPTT is autodiff through it.

Beam search (the reference's :149-297): :meth:`LSTMLayer.beam_search` runs
the W beams as one batch a step on the params' device and takes the global
top W of the W x V candidates, ties to the lower index as ``lax.top_k``
(a stable sort on the scores, descending); :meth:`LSTMLayer.beam_search_host`
is the reference-shaped host loop, kept as its oracle.
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

    def _batch_tick(self, params: Params, conf: LayerConfig, x, h, c):
        i, f, o, g = self._gates(conf, params[RECURRENT_WEIGHTS], x, h)
        c2 = i * g + f * c
        h2 = self._hout(conf, o, c2)
        return self.decode(params, conf, h2), h2, c2

    @torch.no_grad()
    def beam_search(self, params: Params, conf: LayerConfig,
                    seed: torch.Tensor, embeddings: torch.Tensor,
                    beam_size: int = 5, n_steps: int = 20
                    ) -> list[tuple[list[int], float]]:
        """Beam-search decode: ``seed`` is the first input row,
        ``embeddings[i]`` the input row fed after token i is emitted.
        Each step the W beams tick as one batch, the top W continuations
        come from the W x V pool (ties to the lower flat index), and the
        hidden state and token history follow the surviving parents; a
        finished beam (stop token 0) offers one candidate, the stop token
        again at an unchanged score. Beam 0 starts live and the rest dead,
        so the first step takes W distinct tokens from it. Returns (tokens,
        logp) best first, each trimmed after its stop token."""
        w, v = beam_size, conf.n_out
        d = self.hidden_size(conf)
        dev = seed.device
        with dtypes.precision():
            zeros = torch.zeros((1, d), dtype=seed.dtype, device=dev)
            _, h0, c0 = self._batch_tick(params, conf, seed[None, :], zeros,
                                         zeros)
            h, c = h0.repeat(w, 1), c0.repeat(w, 1)
            scores = torch.full((w,), float("-inf"), device=dev)
            scores[0] = 0.0
            prev = torch.zeros((w,), dtype=torch.long, device=dev)
            finished = torch.zeros((w,), dtype=torch.bool, device=dev)
            tokens = torch.zeros((w, n_steps), dtype=torch.long, device=dev)
            fin_row = torch.full((v,), float("-inf"), device=dev)
            fin_row[0] = 0.0
            for i in range(n_steps):
                y, h2, c2 = self._batch_tick(params, conf, embeddings[prev],
                                             h, c)
                logp = torch.log_softmax(y, dim=-1)
                cand = scores[:, None] + torch.where(finished[:, None],
                                                     fin_row[None, :], logp)
                # lax.top_k's order: descending, the lower index first
                # among equals
                top, flat = torch.sort(cand.reshape(-1), descending=True,
                                       stable=True)
                scores, flat = top[:w], flat[:w]
                parent, tok = flat // v, flat % v
                keep = finished[parent][:, None]
                h = torch.where(keep, h[parent], h2[parent])
                c = torch.where(keep, c[parent], c2[parent])
                tokens = tokens[parent]
                tokens[:, i] = tok
                finished = finished[parent] | (tok == 0)
                prev = tok
        out = []
        for idxs, logp in zip(tokens.tolist(), scores.tolist()):
            if 0 in idxs:  # trim the re-emitted stops
                idxs = idxs[:idxs.index(0) + 1]
            out.append((idxs, float(logp)))
        return out

    @torch.no_grad()
    def beam_search_host(self, params: Params, conf: LayerConfig,
                         seed: torch.Tensor, embeddings: torch.Tensor,
                         beam_size: int = 5, n_steps: int = 20
                         ) -> list[tuple[list[int], float]]:
        """The reference-shaped host loop (a Python list of beams, one tick
        a beam, a host sort; scores summed as Python floats), kept as the
        oracle of :meth:`beam_search`."""
        d = self.hidden_size(conf)
        zeros = torch.zeros((d,), dtype=seed.dtype, device=seed.device)
        with dtypes.precision():
            _, h, c = self.tick(params, conf, seed, zeros, zeros)
            beams = [(0.0, [], h, c)]
            for _ in range(n_steps):
                candidates = []
                for logp, idxs, h, c in beams:
                    prev = idxs[-1] if idxs else 0
                    if idxs and prev == 0:  # finished beam
                        candidates.append((logp, idxs, h, c))
                        continue
                    y, h2, c2 = self.tick(params, conf, embeddings[prev], h,
                                          c)
                    logp_tok = torch.log_softmax(y, dim=-1)
                    top = torch.argsort(-logp_tok, stable=True)[:beam_size]
                    for t in top.tolist():
                        candidates.append((logp + float(logp_tok[t]),
                                           idxs + [t], h2, c2))
                candidates.sort(key=lambda b: -b[0])
                beams = candidates[:beam_size]
                if all(b[1] and b[1][-1] == 0 for b in beams):
                    break
        return [(idxs, logp) for logp, idxs, _, _ in beams]
