"""GloVe: AdaGrad weighted least squares on co-occurrence log-counts — the
port of ``deeplearning4j_tpu/models/glove.py``.

≙ reference models/glove/Glove.java:42 (fit:91, doIteration:151),
GloveWeightLookupTable (bias vectors and per-row AdaGrad) and
CoOccurrences.java:41 (window-weighted co-occurrence counting).

The co-occurrence triples (i, j, X_ij) are counted once on the host, in
numpy, equal bit for bit and in order to the reference's ``Counter``
(:func:`count_cooccurrences`); they go to the device once, and each epoch's
shuffled batches (numpy's ``permutation`` from the seed, as the reference's)
are gathered there. Every batch is one AdaGrad step of the whole batch, in
f32 (:func:`_glove_math`): every gather reads the pre-batch tables, each
accumulator takes the whole batch's squared gradients before its table reads
it, and colliding rows accumulate. A word's bias rides as the last column of
its row (``[w | b]``, ``[wc | bc]`` and their accumulators ``[hw | hb]``,
``[hwc | hbc]``: four (V, D + 1) tables), so a batch gathers and scatters
each side once; every element's arithmetic is the reference's eight-table
step's. On the card the scatter-adds take the port's deterministic sorted
scatter (``models/word2vec._scatter_plan`` and ``_scatter_apply``: one plan
for the batch's rows and one for its columns, each serving two tables), so
two fits from one seed are bitwise equal; the CPU adds with ``index_add_``
in index order, as the reference's scatter does.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import rng as rng_lib
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.models.word2vec import (
    _f32,
    _host,
    _scatter_apply,
    _scatter_plan,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib

#: the AdaGrad tables in the order of the reference's step's arguments
TABLES = ("w", "wc", "b", "bc", "hw", "hwc", "hb", "hbc")


def count_cooccurrences(
    encoded_sentences, window: int = 5
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window-weighted counts (weight 1/distance, ≙ CoOccurrences.fit:69):
    (rows, cols, values), int32, int32, f32, both orders of every pair.

    The reference adds ``1/off`` into a ``Counter`` keyed (a, b), looping
    over sentences, then positions i, then offsets, (a, b) before (b, a);
    its keys come out in first-occurrence order and each value is an f64
    sum in occurrence order, cast to f32. Here the occurrences are laid out
    in that loop's order with numpy, the keys ordered by first occurrence
    and the values summed by ``np.bincount``, which adds its weights one
    after another in index order: the same keys, order and bits."""
    sents = [np.asarray(s, np.int64).reshape(-1) for s in encoded_sentences]
    lens = np.array([len(s) for s in sents], np.int64)
    if not len(sents) or (lens < 2).all():
        return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
    ids = np.concatenate(sents)
    ends = np.repeat(np.cumsum(lens), lens)  # each position's sentence end
    pos = np.arange(len(ids), dtype=np.int64)
    offs = np.arange(1, window + 1, dtype=np.int64)
    j = pos[:, None] + offs[None, :]  # (positions, window), loop order
    valid = j < ends[:, None]
    a = ids[np.broadcast_to(pos[:, None], j.shape)[valid]]
    b = ids[j[valid]]
    weight = 1.0 / np.broadcast_to(offs, j.shape)[valid]
    n_ids = int(ids.max()) + 1
    # every occurrence in the loop's order: (a, b) then (b, a)
    keys = np.stack([a * n_ids + b, b * n_ids + a], axis=1).reshape(-1)
    vals = np.repeat(weight, 2)
    # the distinct keys and each one's first occurrence (an unstable sort
    # and the least position of each run: np.unique's, at half the cost)
    perm = np.argsort(keys)
    sk = keys[perm]
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    first = np.minimum.reduceat(perm, starts)
    order = np.argsort(first)  # first-occurrence order (distinct values)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    group = np.zeros(len(keys), np.int64)
    group[starts[1:]] = 1
    label = np.empty(len(keys), np.int64)
    label[perm] = rank[np.cumsum(group)]
    sums = np.bincount(label, weights=vals, minlength=len(order))
    keys = sk[starts][order]
    return ((keys // n_ids).astype(np.int32), (keys % n_ids).astype(np.int32),
            sums.astype(np.float32))


def _add_rows(S: torch.Tensor, rows: torch.Tensor, deltas: torch.Tensor,
              plan) -> None:
    """S[rows[i]] += deltas[i] in place, colliding rows accumulating: the
    sorted scatter's ``plan`` on the card, ``index_add_`` (index order)
    without one."""
    if plan is None:
        S.index_add_(0, rows, deltas)
    else:
        _scatter_apply(S, plan, deltas[plan.perm])


def _glove_math(W, WC, H, HC, rows, cols, logx, fx, lr):
    """One batched AdaGrad WLS step (the reference's ``_glove_math``) on
    the merged tables, in place; returns them and the batch's loss, a 0-dim
    tensor.

    W = [w | b] and WC = [wc | bc], (V, D + 1): word and context embeddings
    with their biases; H and HC their AdaGrad accumulators.
    loss = f(X) * (w_i.wc_j + b_i + bc_j - logX)^2. Every gather reads the
    pre-batch tables; each accumulator takes the whole batch's squared
    gradients before its table reads it back (``sqrt(h + 1e-8)``), so a row
    the batch holds twice sees both. ``lr`` a float."""
    d = W.shape[1] - 1
    wi, wj = W[rows], WC[cols]
    diff = (wi[:, :d] * wj[:, :d]).sum(-1) + wi[:, d] + wj[:, d] - logx
    fdiff = fx * diff  # (B,)
    g_i = torch.cat([fdiff[:, None] * wj[:, :d], fdiff[:, None]], dim=1)
    g_j = torch.cat([fdiff[:, None] * wi[:, :d], fdiff[:, None]], dim=1)
    on_card = W.is_cuda
    pr = _scatter_plan(rows, None, W.shape[0]) if on_card else None
    pc = _scatter_plan(cols, None, WC.shape[0]) if on_card else None
    _add_rows(H, rows, g_i**2, pr)
    _add_rows(HC, cols, g_j**2, pc)
    _add_rows(W, rows, -lr * g_i / torch.sqrt(H[rows] + 1e-8), pr)
    _add_rows(WC, cols, -lr * g_j / torch.sqrt(HC[cols] + 1e-8), pc)
    loss = 0.5 * torch.mean(fx * diff**2)
    return W, WC, H, HC, loss


class Glove:
    """≙ Glove.Builder fields: layer_size, xMax, alpha, lr, epochs. Trains
    on ``device`` (``cuda`` unless the caller names another; raises without
    a card)."""

    def __init__(
        self,
        layer_size: int = 50,
        window: int = 5,
        min_word_frequency: int = 1,
        lr: float = 0.05,
        x_max: float = 100.0,
        alpha: float = 0.75,
        epochs: int = 5,
        batch: int = 4096,
        seed: int = 123,
        tokenizer=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.lr = lr
        self.x_max = x_max
        self.alpha = alpha
        self.epochs = epochs
        self.batch = batch
        self.seed = seed
        self.tokenizer = tokenizer or DefaultTokenizer()
        self.cache = VocabCache(min_word_frequency)
        #: [w | b], [wc | bc], and their AdaGrad history [hw | hb], [hwc |
        #: hbc] (kept for continue-training; None: fresh, ones)
        self._tables: list[torch.Tensor | None] | None = None
        self.loss_history: list[float] = []

    # the reference's eight tables, as views of the merged ones
    @property
    def w(self) -> torch.Tensor | None:
        return None if self._tables is None else self._tables[0][:, :-1]

    @property
    def wc(self) -> torch.Tensor | None:
        return None if self._tables is None else self._tables[1][:, :-1]

    @property
    def b(self) -> torch.Tensor | None:
        return None if self._tables is None else self._tables[0][:, -1]

    @property
    def bc(self) -> torch.Tensor | None:
        return None if self._tables is None else self._tables[1][:, -1]

    @property
    def _acc(self):
        """(hw, hwc, hb, hbc), the AdaGrad history, or None."""
        if self._tables is None or self._tables[2] is None:
            return None
        h, hc = self._tables[2:]
        return h[:, :-1], hc[:, :-1], h[:, -1], hc[:, -1]

    def _prepare(self, sentences: SentenceIterator):
        """Vocab, co-occurrence counting and weight/accumulator init;
        returns the (rows, cols, logx, fx) host arrays."""
        toks = [self.tokenizer.tokens(s) for s in sentences]
        self.cache.fit(toks)
        encoded = [self.cache.encode(t) for t in toks]
        rows, cols, vals = count_cooccurrences(encoded, self.window)
        if len(rows) == 0:
            raise ValueError("empty co-occurrence matrix")
        logx, fx = self._init_weights(vals)
        return rows, cols, logx, fx

    def _init_weights(self, vals: np.ndarray, reset: bool = True):
        """Weight/bias/AdaGrad init and the GloVe weighting terms (logx,
        fx), shared by the sentence and precomputed-co-occurrence fit
        paths: ``w`` and ``wc`` are ``(uniform(k, (V, D)) - 0.5) / D`` over
        ``split(key(seed))``, the reference's bits, the biases zero, the
        accumulators ones. ``reset=False`` keeps already-trained weights
        and their AdaGrad history (the continue-training path) and only
        rebuilds the per-triple terms."""
        v, d, dev = len(self.cache), self.layer_size, self.device
        if reset or self._tables is None:
            k1, k2 = rng_lib.split(rng_lib.key_for(self.seed))
            # CUDA divides by a host number as a product with its
            # reciprocal: divide by a device scalar, as the reference
            dd = torch.full((), float(d), device=dev)
            zero = torch.zeros((v, 1), device=dev)
            self._tables = [
                torch.cat([(rng_lib.uniform(k, (v, d), device=dev) - 0.5)
                           / dd, zero], dim=1) for k in (k1, k2)] + [None] * 2
        if self._tables[2] is None:
            self._tables[2:] = [torch.ones((v, d + 1), device=dev)
                                for _ in range(2)]
        logx = np.log(vals).astype(np.float32)
        fx = np.minimum((vals / self.x_max) ** self.alpha, 1.0).astype(
            np.float32
        )
        return logx, fx

    def _run_epochs(self, data, bsz: int, mesh=None) -> None:
        """The shuffle/batch/loss-history loop over the co-occurrence
        triples, shared by ``fit``, ``fit_cooccurrences`` and
        ``fit_distributed`` (``mesh``: the batch split over its data
        ranks). The triples go to the device once; each epoch's
        permutation is drawn on the host from the seed, as the reference's,
        and the tail that does not fill a batch is dropped. The loss of
        each batch stays on the device until the epoch ends; the epoch's
        mean adds them in order in f64, as the reference's. The AdaGrad
        history stays for a continue-training call (fit_cooccurrences
        after fit steps with the accumulated h, not a fresh near-full-lr
        restart on already-trained rows)."""
        rows, cols, logx, fx = (
            upload(np.ascontiguousarray(a, dt), self.device)
            for a, dt in zip(data, (np.int64, np.int64, np.float32,
                                    np.float32)))
        gen = np.random.default_rng(self.seed)
        n = len(data[0])
        lr = _f32(self.lr)
        for _ in range(self.epochs):
            order = upload(gen.permutation(n), self.device)
            losses = []
            for s in range(0, n - bsz + 1, bsz):
                idx = order[s:s + bsz]
                batch = (rows[idx], cols[idx], logx[idx], fx[idx])
                if mesh is None:
                    *self._tables, loss = _glove_math(*self._tables, *batch,
                                                      lr)
                else:
                    *self._tables, loss = self._distributed_step(
                        mesh, self._tables, batch, lr)
                losses.append(loss)
            total = (torch.stack(losses).double().cpu().tolist()
                     if losses else [])
            epoch_loss = 0.0
            for x in total:
                epoch_loss += x
            self.loss_history.append(epoch_loss / max(len(total), 1))

    def _distributed_step(self, mesh, tables, batch, lr):
        """One step of ``fit_distributed``: data rank r takes rows ``r *
        per`` to ``(r + 1) * per`` of the batch (its process's share first
        across processes) and runs :func:`_glove_math` on its own copy of
        the tables; the ranks' tables and losses are averaged
        (``parallel/mesh.rank_mean``)."""
        n_local = mesh.axis_size(mesh_lib.DATA_AXIS)
        per = batch[0].shape[0] // mesh.global_data_size
        first = mesh.process_index * n_local * per

        def rank_step(r, copies):
            lo = first + r * per
            dev = copies[0].device
            part = [a[lo:lo + per].to(dev) for a in batch]
            *out, loss = _glove_math(*copies, *part, lr)
            return [*out, loss.reshape(1)]

        *out, loss = mesh_lib.rank_mean(mesh, tables, rank_step)
        return [t.to(self.device) for t in out] + [loss[0].to(self.device)]

    def fit(self, sentences: SentenceIterator) -> None:
        rows, cols, logx, fx = self._prepare(sentences)
        bsz = min(self.batch, len(rows))
        self._run_epochs((rows, cols, logx, fx), bsz)

    def fit_cooccurrences(self, triples) -> None:
        """Train directly on precomputed ``(word_i, word_j, X_ij)`` triples
        — the artifact CoOccurrences.fit produces and Glove.doIteration
        consumes in the reference (Glove.java:91,151; CoOccurrences.java:69).

        Caveats, as the reference's:

        - ``min_word_frequency`` here counts how often a word appears across
          the *triples* (each triple contributes one occurrence per member),
          not corpus token frequency;
        - if a vocab was already built (``fit()`` ran first), it is reused
          rather than rebuilt, trained weights AND AdaGrad history are kept
          (continue-training), and triples whose words are out-of-vocab are
          dropped. (``fit()`` itself has no such guard: VocabCache.fit
          accumulates, so calling ``fit()`` twice on one model corrupts the
          word-index mapping — build the vocab once, then continue with
          this method.)
        """
        triples = [
            (w1, w2, x) for w1, w2, x in
            ((w1, w2, float(x)) for w1, w2, x in triples) if x > 0
        ]
        if not triples:
            raise ValueError("empty co-occurrence input")
        had_vocab = len(self.cache) > 0
        if not had_vocab:
            self.cache.fit([w1, w2] for w1, w2, _ in triples)
        # drop triples whose words the min-frequency cutoff pruned: a -1
        # index would wrap to the last vocab row and corrupt another word
        kept = [
            (self.cache.index_of(w1), self.cache.index_of(w2), x)
            for w1, w2, x in triples
        ]
        kept = [(i, j, x) for i, j, x in kept if i >= 0 and j >= 0]
        if not kept:
            raise ValueError("all co-occurrence words pruned by "
                             "min_word_frequency")
        rows = np.asarray([i for i, _, _ in kept], np.int32)
        cols = np.asarray([j for _, j, _ in kept], np.int32)
        vals = np.asarray([x for _, _, x in kept], np.float32)
        logx, fx = self._init_weights(vals, reset=not had_vocab)
        bsz = min(self.batch, len(rows))
        self._run_epochs((rows, cols, logx, fx), bsz)

    def fit_distributed(self, sentences: SentenceIterator, mesh=None) -> None:
        """Data-parallel GloVe over ``mesh``'s data axis (every card by
        default; ``data_parallel_mesh(devices=[...])`` names them, and a
        device may repeat): each rank runs the AdaGrad WLS step on its
        shard of every co-occurrence batch from its own copy of the
        replicated tables, then the updated tables (the accumulators too)
        and the losses are averaged in rank order — the reference's
        ``pmean`` of the tables (≙ the master-side table merge of its
        GloveJobAggregator). The mean is of whole tables, not of the
        touched rows' deltas: it rounds as the reference's, and its cost
        (the ranks' copies and one pass over them, a few hundred MB a batch
        at text8's width) is small beside the step's host path.

        As the reference: the batch is ``min(batch, triples)`` less its
        remainder modulo the ranks (``ValueError`` when nothing is left),
        and the tail that does not fill a batch is dropped. Across
        processes (``hybrid_mesh``) every process counts the same corpus,
        takes its rows of each batch and joins the average through
        ``all_reduce_mean``."""
        mesh = mesh or mesh_lib.device_data_mesh(self.device)
        n_ranks = mesh.global_data_size
        rows, cols, logx, fx = self._prepare(sentences)
        n = len(rows)
        bsz = min(self.batch, n)
        bsz -= bsz % n_ranks
        if bsz == 0:
            raise ValueError(
                f"co-occurrence batch ({min(self.batch, n)}) smaller than "
                f"mesh ({n_ranks})")
        self._run_epochs((rows, cols, logx, fx), bsz, mesh=mesh)

    # combined representation (standard GloVe: w + wc)
    @property
    def syn0(self) -> torch.Tensor:
        return self.w + self.wc

    def get_word_vector(self, word: str) -> np.ndarray | None:
        i = self.cache.index_of(word)
        return None if i < 0 else _host(self.w[i] + self.wc[i])

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-9))


def glove_state_from_jax(w, wc, b, bc, hw, hwc, hb, hbc,
                         device=None) -> dict[str, torch.Tensor]:
    """The JAX package's eight GloVe tables (numpy arrays: the weights,
    the biases and their AdaGrad accumulators) as the port's f32 tensors on
    ``device`` (``cuda`` unless the caller names another; raises without a
    card), keyed as :data:`TABLES`. :func:`load_state` puts them into a
    ``Glove``, to train on from the same state."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(x, np.float32), device=dev)
            for k, x in zip(TABLES, (w, wc, b, bc, hw, hwc, hb, hbc))}


def load_state(model: Glove, state: dict[str, torch.Tensor]) -> None:
    """Sets a model's tables and AdaGrad history from a
    :func:`glove_state_from_jax` dict; a later ``fit_cooccurrences`` (a
    built vocabulary) continues from them."""
    model._tables = [torch.cat([state[m], state[v][:, None]], dim=1)
                     for m, v in (("w", "b"), ("wc", "bc"), ("hw", "hb"),
                                  ("hwc", "hbc"))]
