"""Word2Vec: skip-gram with hierarchical softmax and negative sampling —
the port of ``deeplearning4j_tpu/models/word2vec.py``.

Training pairs are enumerated on the host (``native_io.sg_pairs_chunk``),
batched, and every batch is one update of the tables in f32, computed from
the pre-batch table as in the reference:

- gather the input rows and the rows of each target's Huffman path (HS) or
  of the target and its negatives (NS);
- HS: kernel #5 (``ops/emb_dot.py``, hand-written CUDA on the card) gives
  f = sigmoid(clip(dot)) * mask and the flag |dot| < 6 in one pass; NS: the
  dots in plain PyTorch, saturated to 1/0 out of range as the reference does;
- scatter-add the row updates. Colliding rows accumulate rather than race,
  deterministically (:func:`_scatter_add_rows`), so two fits from the same
  seed on the card are bitwise equal.

The reference folds 128 HS batches into one device dispatch (``_hs_scan``)
to amortize a TPU's dispatch cost; here each batch runs eagerly as it is
formed. That is the same sequence of updates, each batch with the learning
rate of the flush that formed it (the lr-0 filler batches of a dispatch are
exact no-ops and are skipped). ``fit`` keeps syn0, syn1 and syn1neg in one
merged table for the whole fit and updates it in place (the reference
concatenates per dispatch), so ``syn0``/``syn1``/``syn1neg`` are views of it
afterwards.

The grad_in and g ⊗ h products are elementwise products summed in f32, so no
TF32 matrix product is reached whatever the caller's
``torch.backends.cuda.matmul.allow_tf32`` says. The WordVectors queries
(``similarity``, ``words_nearest``, ``accuracy``) run on a host copy of
syn0, as in the reference. ``fit_distributed`` (a mesh) is a later slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch import native_io
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.ops.emb_dot import (
    MAX_EXP,
    fused_embedding_dot_range,
)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a table (never a view of it)."""
    return t.detach().cpu().numpy().copy()


def _f32(x) -> float:
    """A learning rate rounded to f32, as the reference stores it."""
    return float(np.float32(x))


# -- batch updates ------------------------------------------------------------

#: on the card, runs of one row longer than this are summed in pieces of
#: this length, then the pieces in order (bounds the longest sequential sum)
_PIECE = 32


def _scatter_add_rows(S: torch.Tensor, rows: torch.Tensor,
                      deltas: torch.Tensor,
                      keep: torch.Tensor | None = None) -> None:
    """S[rows[i]] += deltas[i] in place for every i, colliding rows
    accumulating deterministically; ``keep`` (bool) marks the entries whose
    delta may be nonzero (the others are exact zeros and may be skipped).

    The CPU's ``index_add_`` adds in index order, as the reference's
    scatter-add does. On the card, ``index_add_`` accumulates with atomics
    (run-to-run differences in f32), and ``index_put_(accumulate=True)``,
    deterministic, walks each row's run of duplicates one element at a
    time: the root of the Huffman tree is on every path, so a batch's
    longest run is its 4,096 pairs. The card takes :func:`_sorted_scatter_add`
    instead."""
    if S.is_cuda:
        _sorted_scatter_add(S, rows, deltas, keep)
    else:
        S.index_add_(0, rows, deltas)


def _sorted_scatter_add(S, rows, deltas, keep=None) -> None:
    """:func:`_scatter_add_rows` for any device, without atomics on floats:
    sort the rows stably, sum each row's run in pieces of ``_PIECE`` in
    order and then the pieces in order (two ``segment_reduce`` passes, one
    thread per output element), and write each row once. At least one
    entry must be kept (the HS and NS steps keep every input)."""
    n, dev = rows.numel(), rows.device
    key = rows if keep is None else torch.where(keep, rows, S.shape[0])
    r, perm = torch.sort(key, stable=True)  # skipped entries last
    real = (r < S.shape[0]).long()
    pos = torch.arange(n, device=dev)
    start = torch.searchsorted(r, r)  # where each entry's run starts
    cut = (pos - start) % _PIECE == 0  # a piece starts
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    sums = torch.segment_reduce(
        deltas[perm], "sum", unsafe=True,
        lengths=zeros.index_add(0, torch.cumsum(cut, 0) - 1, real))
    run = torch.cumsum(pos == start, 0) - 1
    pieces = zeros.index_add(0, run, cut * real)
    sums = torch.segment_reduce(sums, "sum", lengths=pieces, unsafe=True)
    # the kept runs come first; every slot past them repeats one of them
    # (row and sum), so each write to a row carries the same value and no
    # row takes many writes
    used = pieces > 0
    slot = torch.where(used, pos, pos % used.sum())
    row = zeros.index_put((run,), r)[slot]
    S.index_put_((row,), S[row] + sums[slot])


def _hs_math_merged(S, v, inputs, codes, points, mask, lr):
    """One HS batch update of the merged table, in place; returns S.

    ``S[:v]`` holds the input rows (syn0), ``S[v + p]`` the syn1 row of
    inner node p (rows past syn1 are left alone). inputs: (B,) rows;
    codes/points/mask: (B, L) Huffman paths of the targets (codes and mask
    f32, points int64); lr a float. Saturated dots are skipped, not clipped
    (the reference's exp-table range check): clipping keeps updating
    saturated pairs with a constant-magnitude g, which feeds an oscillating
    syn0 <-> syn1 instability on small corpora trained for many epochs."""
    h = S[inputs]  # (B, D)
    rows = v + points  # (B, L)
    w1 = S[rows]  # (B, L, D)
    f, in_range = fused_embedding_dot_range(h, w1, mask)
    g = (1.0 - codes - f) * lr * mask * in_range  # (B, L)
    grad_in = (g[:, :, None] * w1).sum(1)
    # one scatter for the input rows and the path rows, as the reference's;
    # the padding of the paths (mask 0) adds exact zeros
    _scatter_add_rows(
        S, torch.cat([inputs, rows.reshape(-1)]),
        torch.cat([grad_in, (g[:, :, None] * h[:, None, :]).reshape(
            -1, S.shape[1])]),
        torch.cat([torch.ones_like(inputs, dtype=torch.bool),
                   mask.reshape(-1) > 0]))
    return S


def _ns_math_merged(S, v, inputs, targets, negatives, lr):
    """One negative-sampling batch update of the merged table, in place;
    returns S. ``S[v + i]`` is the syn1neg row of word i; targets (B,)
    positive words, negatives (B, K) sampled words, int64."""
    h = S[inputs]  # (B, D)
    words = torch.cat([targets[:, None], negatives], dim=1)  # (B, 1+K)
    labels = torch.zeros(words.shape, dtype=S.dtype, device=S.device)
    labels[:, 0] = 1.0
    rows = v + words
    w = S[rows]  # (B, 1+K, D)
    dot = (h[:, None, :] * w).sum(-1)
    # negative sampling SATURATES out-of-range dots to f = 1/0 (a full
    # corrective update), unlike HS, which skips them
    f = torch.where(dot > MAX_EXP, 1.0,
                    torch.where(dot < -MAX_EXP, 0.0, torch.sigmoid(dot)))
    g = (labels - f) * lr
    grad_in = (g[:, :, None] * w).sum(1)
    _scatter_add_rows(
        S, torch.cat([inputs, rows.reshape(-1)]),
        torch.cat([grad_in, (g[:, :, None] * h[:, None, :]).reshape(
            -1, S.shape[1])]))
    return S


def _hs_math(syn0, syn1, inputs, codes, points, mask, lr):
    """One hierarchical-softmax batch update: returns new (syn0, syn1)."""
    v = syn0.shape[0]
    S = _hs_math_merged(torch.cat([syn0, syn1]), v, inputs, codes, points,
                        mask, lr)
    return S[:v], S[v:]



def _hs_scan(syn0, syn1, ins, tgts, codes, points, mask, lrs):
    """k HS batch updates in order: ins/tgts (k, B), lrs (k,); the Huffman
    paths are gathered per batch. Batches at lr 0 change nothing (g is
    proportional to lr) and are skipped."""
    v = syn0.shape[0]
    S = torch.cat([syn0, syn1])
    for i, lr in enumerate(torch.as_tensor(lrs).tolist()):
        if lr != 0.0:
            t = tgts[i]
            _hs_math_merged(S, v, ins[i], codes[t], points[t], mask[t], lr)
    return S[:v], S[v:]


def _ns_step(syn0, syn1neg, inputs, targets, negatives, lr):
    """One negative-sampling batch update: returns new (syn0, syn1neg)."""
    v = syn0.shape[0]
    S = _ns_math_merged(torch.cat([syn0, syn1neg]), v, inputs, targets,
                        negatives, lr)
    return S[:v], S[v:]


# -- pair generation (host) ---------------------------------------------------

def skipgram_pairs(
    sentence_ids: list[int], window: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """(input, target) pairs with a random window reduction per centre
    (b = random % window)."""
    arr = np.asarray(sentence_ids, dtype=np.int32)
    n = len(arr)
    ins, tgts = [], []
    if n < 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    bs = rng.integers(0, window, size=n)
    for i in range(n):
        span = window - int(bs[i])
        lo, hi = max(0, i - span), min(n, i + span + 1)
        for j in range(lo, hi):
            if j != i:
                ins.append(arr[j])  # context word is the input
                tgts.append(arr[i])  # centre word supplies the HS path
    return np.asarray(ins, np.int32), np.asarray(tgts, np.int32)


class _PairBuffer:
    """Sentence -> pair plumbing of ``fit``: buffers encoded sentences and
    drains them through one ``sg_pairs_chunk`` pass per chunk, with chunk
    seeds ``seed, seed + 1, ...``, keeping the pairs until the trainer
    takes them."""

    def __init__(self, window: int, seed: int, chunk_words: int):
        self.window = window
        self.next_seed = seed
        self.chunk_words = chunk_words
        self.sents: list[np.ndarray] = []
        self.words = 0
        self._ins: list[np.ndarray] = []
        self._tgts: list[np.ndarray] = []
        self.count = 0  # pairs pending

    @staticmethod
    def words_per_chunk(batch_pairs: int, window: int) -> int:
        # E[span] ~ window/2 each side -> ~window pairs per word; a chunk
        # holds ~one batch of pairs so the lr schedule stays fresh
        return max(batch_pairs // max(window, 1), 64)

    def add(self, ids: list[int]) -> bool:
        """Buffer one encoded sentence; True when a chunk is pending."""
        if len(ids) >= 2:
            self.sents.append(np.asarray(ids, np.int32))
            self.words += len(ids)
        return self.words >= self.chunk_words

    def drain(self) -> None:
        """Enumerate the pairs of all buffered sentences in one pass."""
        if not self.sents:
            return
        ins, tgts = native_io.sg_pairs_chunk(
            self.sents, self.window, self.next_seed
        )
        self.next_seed += 1
        self.sents.clear()
        self.words = 0
        if len(ins):
            self._ins.append(ins)
            self._tgts.append(tgts)
            self.count += len(ins)

    def take_all(self) -> tuple[np.ndarray, np.ndarray]:
        ins = np.concatenate(self._ins) if self._ins else np.zeros(0, np.int32)
        tgts = (
            np.concatenate(self._tgts) if self._tgts else np.zeros(0, np.int32)
        )
        self._ins.clear()
        self._tgts.clear()
        self.count = 0
        return ins, tgts

    def put_back(self, ins: np.ndarray, tgts: np.ndarray) -> None:
        if len(ins):
            self._ins.append(ins)
            self._tgts.append(tgts)
            self.count += len(ins)


class Word2Vec:
    """Skip-gram embeddings on ``device`` (``cuda`` unless the caller names
    another; raises without a card)."""

    def __init__(
        self,
        layer_size: int = 50,
        window: int = 5,
        min_word_frequency: int = 1,
        use_hierarchical_softmax: bool = True,
        negative: int = 0,  # number of negative samples (0 = HS only)
        lr: float = 0.025,
        min_lr: float = 1e-4,
        epochs: int = 1,
        batch_pairs: int = 4096,
        sample: float = 0.0,  # frequent-word subsampling threshold
        seed: int = 123,
        tokenizer=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.use_hs = use_hierarchical_softmax
        self.negative = negative
        self.lr = lr
        self.min_lr = min_lr
        self.epochs = epochs
        self.batch_pairs = batch_pairs
        self.sample = sample
        self.seed = seed
        self.tokenizer = tokenizer or DefaultTokenizer()
        self.cache = VocabCache(min_word_frequency)
        self.syn0: torch.Tensor | None = None
        self.syn1: torch.Tensor | None = None
        self.syn1neg: torch.Tensor | None = None
        self._codes = self._points = self._mask = None
        self._table: np.ndarray | None = None

    # -- vocab -------------------------------------------------------------
    def tokenize(self, sentence: str) -> list[str]:
        return self.tokenizer.tokens(sentence)

    def build_vocab(self, sentences: SentenceIterator) -> None:
        self.cache.fit(self.tokenize(s) for s in sentences)
        self.cache.build_huffman()
        self._codes, self._points, self._mask = self.cache.huffman_arrays()
        if self.negative > 0:
            self._table = self.cache.unigram_table()

    def reset_weights(self) -> None:
        """syn0 uniform in [-0.5, 0.5) / D from the port's own generator
        (seeded with ``seed``; the reference draws from ``jax.random``),
        syn1 and syn1neg zero."""
        v, d = len(self.cache), self.layer_size
        gen = torch.Generator().manual_seed(self.seed)
        self.syn0 = ((torch.rand((v, d), generator=gen) - 0.5) / d).to(
            self.device)
        self.syn1 = torch.zeros((max(v - 1, 1), d), device=self.device)
        self.syn1neg = torch.zeros((v, d), device=self.device)

    def _huffman(self):
        """The (V, L) Huffman arrays on the device: codes and mask f32,
        points int64."""
        return (upload(self._codes.astype(np.float32), self.device),
                upload(self._points.astype(np.int64), self.device),
                upload(self._mask, self.device))

    # -- training ----------------------------------------------------------
    def _subsample(self, ids: list[int], rng: np.random.Generator) -> list[int]:
        if self.sample <= 0:
            return ids
        total = self.cache.total_word_count
        out = []
        for i in ids:
            freq = self.cache.vocab[self.cache.index_to_word[i]].count / total
            keep = (np.sqrt(freq / self.sample) + 1) * (self.sample / freq)
            if rng.random() < keep:
                out.append(i)
        return out

    def fit(self, sentences: SentenceIterator) -> None:
        """Skip-gram training with linear lr decay by words seen, one batch
        update per ``batch_pairs`` pairs, HS then (if ``negative``) NS."""
        if len(self.cache) == 0:
            self.build_vocab(sentences)
        if self.syn0 is None:
            self.reset_weights()

        rng = np.random.default_rng(self.seed)
        total_words = max(self.cache.total_word_count * self.epochs, 1)
        words_seen = 0
        v, n1 = self.syn0.shape[0], self.syn1.shape[0]
        # one merged table for the whole fit: syn0 | syn1 | syn1neg
        S = torch.cat([self.syn0, self.syn1, self.syn1neg])
        huff = self._huffman()
        table = (upload(self._table.astype(np.int64), self.device)
                 if self._table is not None else None)
        buf = _PairBuffer(
            self.window,
            self.seed,
            _PairBuffer.words_per_chunk(self.batch_pairs, self.window),
        )

        def flush(train_tail: bool = False):
            buf.drain()
            if buf.count == 0:
                return
            ins, tgts = buf.take_all()
            b = self.batch_pairs
            n = len(ins) // b
            lr_now = _f32(getattr(self, "_lr_now", self.lr))
            tail = len(ins) - n * b
            if train_tail and tail:
                # pad the final partial batch with (0, 0) pairs: only the
                # single final flush pads
                pad = b - tail
                ins = np.concatenate([ins, np.zeros(pad, np.int32)])
                tgts = np.concatenate([tgts, np.zeros(pad, np.int32)])
                n += 1
            elif tail:
                buf.put_back(ins[-tail:], tgts[-tail:])
            if n == 0:
                return
            ins_d = upload(ins[: n * b].astype(np.int64), self.device)
            tgts_d = upload(tgts[: n * b].astype(np.int64), self.device)
            for k in range(n):
                sl = slice(k * b, (k + 1) * b)
                self._train_batch(S, v, n1, ins_d[sl], tgts_d[sl], huff,
                                  table, lr_now, rng)

        # chunks hold ~one batch of pairs so the lr schedule stays fresh;
        # at an epoch boundary every full batch trains and a sub-batch tail
        # carries over to the next epoch (padding it every epoch measurably
        # degrades small-corpus embeddings)
        for _ in range(self.epochs):
            sentences.reset()
            for sent in sentences:
                ids = self._subsample(self.cache.encode(self.tokenize(sent)), rng)
                words_seen += len(ids)
                self._lr_now = max(
                    self.min_lr, self.lr * (1.0 - words_seen / total_words)
                )
                if buf.add(ids):
                    flush()
            flush()
        flush(train_tail=True)
        self.syn0, self.syn1, self.syn1neg = S[:v], S[v:v + n1], S[v + n1:]

    def _train_batch(self, S, v, n1, ins, tgts, huff, table, lr, rng):
        """One batch on the merged table: the HS update (syn1 at row v),
        then the NS update (syn1neg at row v + n1) on the new syn0, with
        negatives drawn from the host generator."""
        if self.use_hs:
            codes, points, mask = huff
            _hs_math_merged(S, v, ins, codes[tgts], points[tgts], mask[tgts],
                            lr)
        if self.negative > 0 and table is not None:
            neg_idx = rng.integers(0, len(table), size=(len(ins), self.negative))
            negatives = table[upload(neg_idx, self.device)]
            _ns_math_merged(S, v + n1, ins, tgts, negatives, lr)

    def fit_distributed(self, sentences: SentenceIterator, mesh=None) -> None:
        raise NotImplementedError(
            "Word2Vec.fit_distributed (data-parallel delta averaging over a "
            "mesh) is a later slice of the port, on torch.distributed "
            "(ROADMAP Queue 1); use fit on one device"
        )

    # -- WordVectors API ---------------------------------------------------
    def get_word_vector(self, word: str) -> np.ndarray | None:
        i = self.cache.index_of(word)
        return None if i < 0 else _host(self.syn0[i])

    def _normed(self) -> np.ndarray:
        m = _host(self.syn0)
        return m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-9)

    def similarity(self, w1: str, w2: str) -> float:
        """Cosine similarity."""
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        return float(
            np.dot(a, b) / ((np.linalg.norm(a) * np.linalg.norm(b)) + 1e-9)
        )

    def words_nearest(self, word_or_vec, top: int = 10, exclude: set[str] = frozenset()) -> list[str]:
        """The ``top`` words by cosine to a word or a vector."""
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = set(exclude) | {word_or_vec}
            if vec is None:
                return []
        else:
            vec = np.asarray(word_or_vec)
        normed = self._normed()
        q = vec / (np.linalg.norm(vec) + 1e-9)
        sims = normed @ q
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.cache.word_for(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top:
                break
        return out

    def _answer_analogy(self, normed, a, b, c, d):
        """Top-1 answer to a:b :: c:? against a pre-normalized matrix: True
        or False, or None when a word is out of vocabulary (word2vec.c's
        skip convention)."""
        va, vb, vc = (self.get_word_vector(w) for w in (a, b, c))
        if va is None or vb is None or vc is None or d not in self.cache:
            return None
        q = vb - va + vc
        sims = normed @ (q / (np.linalg.norm(q) + 1e-9))
        exclude = {a, b, c}
        for i in np.argsort(-sims):
            w = self.cache.word_for(int(i))
            if w not in exclude:
                return w == d
        return False

    def accuracy(self, questions: list[tuple[str, str, str, str]]) -> float:
        """Analogy accuracy a:b :: c:d."""
        return self.accuracy_report({"all": questions})["TOTAL"]["accuracy"]

    def accuracy_report(
        self, path_or_categories
    ) -> dict[str, dict[str, float]]:
        """Per-category analogy report from a questions-words file (or
        ``{category: [(a, b, c, d), ...]}``): ``{category: {"accuracy",
        "correct", "total", "skipped"}}`` plus a ``"TOTAL"`` row; ``total``
        counts questions whose four words are all in the vocabulary."""
        if isinstance(path_or_categories, (str, Path)):
            cats = parse_questions_words(path_or_categories)
        else:
            cats = dict(path_or_categories)
        normed = self._normed()  # once for every question
        report: dict[str, dict[str, float]] = {}
        g_corr = g_tot = g_skip = 0
        for cat, questions in cats.items():
            corr = tot = skip = 0
            for a, b, c, d in questions:
                ans = self._answer_analogy(normed, a, b, c, d)
                if ans is None:
                    skip += 1
                    continue
                tot += 1
                corr += bool(ans)
            report[cat] = {
                "accuracy": corr / tot if tot else 0.0,
                "correct": corr, "total": tot, "skipped": skip,
            }
            g_corr += corr
            g_tot += tot
            g_skip += skip
        report["TOTAL"] = {
            "accuracy": g_corr / g_tot if g_tot else 0.0,
            "correct": g_corr, "total": g_tot, "skipped": g_skip,
        }
        return report


def parse_questions_words(path: str | Path) -> dict[str, list[tuple]]:
    """Parse the Google ``questions-words.txt`` analogy format: ``:
    category`` headers followed by ``a b c d`` lines; lines that are not
    exactly four tokens are skipped, as word2vec.c's compute-accuracy
    does."""
    cats: dict[str, list[tuple]] = {}
    current = "uncategorized"
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(":"):
                current = line[1:].strip() or current
                cats.setdefault(current, [])
                continue
            parts = line.split()
            if len(parts) == 4:
                cats.setdefault(current, []).append(tuple(parts))
    return cats


def word2vec_state_from_jax(syn0, syn1, syn1neg, syn0_labels=None,
                            device=None) -> dict[str, torch.Tensor]:
    """The JAX package's tables (numpy arrays) as the port's f32 tensors on
    ``device`` (``cuda`` unless the caller names another; raises without a
    card): ``{"syn0", "syn1", "syn1neg"}`` and ``"syn0_labels"`` when
    given. Assign them to a ``Word2Vec``/``ParagraphVectors`` to train on
    from the same tables."""
    dev = resolve_device(device)
    named = {"syn0": syn0, "syn1": syn1, "syn1neg": syn1neg}
    if syn0_labels is not None:
        named["syn0_labels"] = syn0_labels
    return {k: torch.tensor(np.asarray(x, np.float32), device=dev)
            for k, x in named.items()}
