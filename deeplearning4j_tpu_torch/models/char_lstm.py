"""Character-level LSTM language model, the char-RNN (the JAX package's
``models/char_lstm.py``): one LSTM layer (``nn/layers/lstm.py``) over
one-hot characters, fit by plain SGD on its next-character cross-entropy,
sampled one character at a time on the reference's key chain, and decoded
by beam search."""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import rng
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.nn import conf as C
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.layers.api import value_and_grad
from deeplearning4j_tpu_torch.ops import threefry
from deeplearning4j_tpu_torch.utils import tree_math as tm


class CharLSTM:
    """On ``device`` (the card unless the caller names another)."""

    def __init__(self, seq_len: int = 32, lr: float = 0.1, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.lr = lr
        self.seed = seed
        self.chars: list[str] = []
        self.char_to_ix: dict[str, int] = {}
        self.mod = L.get("lstm")
        self.conf: C.LayerConfig | None = None
        self.params = None

    def build_vocab(self, text: str) -> None:
        """The sorted characters of ``text``, the layer's config (hidden =
        input = output = the vocabulary) and its params from ``key(seed)``,
        the reference's draws."""
        self.chars = sorted(set(text))
        self.char_to_ix = {c: i for i, c in enumerate(self.chars)}
        v = len(self.chars)
        self.conf = C.LayerConfig(layer_type="lstm", n_in=v, n_out=v,
                                  activation="tanh")
        self.params = self.mod.init(rng.key_for(self.seed), self.conf,
                                    device=self.device)

    def params_from_jax(self, params) -> None:
        """The reference's layer params (arrays, e.g. numpy) as this
        model's, after :meth:`build_vocab`."""
        self.params = {k: torch.tensor(np.asarray(v), device=self.device)
                       for k, v in params.items()}

    def _encode(self, text: str) -> np.ndarray:
        return np.array([self.char_to_ix[c] for c in text], np.int32)

    def _batches(self, ids: np.ndarray, batch: int):
        """One-hot (x, y) batches of ``batch`` sequences of ``seq_len``, y
        the next characters, in the reference's order; the last partial
        batch dropped."""
        v, t = len(self.chars), self.seq_len
        usable = (len(ids) - 1) // t * t
        xs = ids[:usable].reshape(-1, t)
        ys = ids[1:usable + 1].reshape(-1, t)
        eye = np.eye(v, dtype=np.float32)
        for s in range(0, len(xs) - batch + 1, batch):
            yield (upload(eye[xs[s:s + batch]], self.device),
                   upload(eye[ys[s:s + batch]], self.device))

    def fit(self, text: str, epochs: int = 5, batch: int = 16) -> list[float]:
        """``epochs`` passes of plain SGD (``p - lr * g``) on the supervised
        score; each epoch's mean batch loss (read back every batch, as the
        reference's)."""
        if not self.chars:
            self.build_vocab(text)
        ids = self._encode(text)
        mod, conf = self.mod, self.conf
        grad = value_and_grad(
            lambda p, x, y: mod.supervised_score(p, conf, x, y))
        losses = []
        for _ in range(epochs):
            total, n = 0.0, 0
            for x, y in self._batches(ids, batch):
                loss, g = grad(self.params, x, y)
                self.params = tm.tree_map(lambda p, gi: p - self.lr * gi,
                                          self.params, g)
                total += float(loss)
                n += 1
            losses.append(total / max(n, 1))
        return losses

    @torch.no_grad()
    def sample(self, seed_char: str, length: int = 50,
               temperature: float = 1.0, rng_seed: int = 0) -> str:
        """Ancestral sampling one character at a time: ``key(rng_seed)``,
        split each character, a categorical draw over ``y / temperature``
        (``ops/threefry``: the draw kernel on the card at R 1, V the
        vocabulary; its plain version on the CPU)."""
        v, d = len(self.chars), self.conf.n_in
        eye = torch.eye(v, device=self.device)
        h = torch.zeros((d,), device=self.device)
        c = torch.zeros((d,), device=self.device)
        # a true division, as the reference's (CUDA multiplies by the
        # reciprocal of a Python number)
        temp = torch.tensor(temperature, dtype=torch.float32,
                            device=self.device)
        ix = self.char_to_ix[seed_char]
        out = [seed_char]
        key = rng.key_for(rng_seed)
        for _ in range(length):
            y, h, c = self.mod.tick(self.params, self.conf, eye[ix], h, c)
            key, sub = rng.split(key)
            ix = int(threefry.categorical(
                (y / temp)[None, :].contiguous(),
                threefry.device_keys(sub, self.device))[0])
            out.append(self.chars[ix])
        return "".join(out)

    def beam_decode(self, seed_char: str, beam_size: int = 3,
                    n_steps: int = 10):
        """The layer's beam search from ``seed_char``, the one-hot rows as
        the embeddings."""
        emb = torch.eye(len(self.chars), device=self.device)
        return self.mod.beam_search(self.params, self.conf,
                                    emb[self.char_to_ix[seed_char]], emb,
                                    beam_size=beam_size, n_steps=n_steps)
