"""ParagraphVectors (doc2vec), PV-DBOW over labeled documents — the port of
``deeplearning4j_tpu/models/paragraph_vectors.py``.

Label (paragraph) vectors are trained against the words of their documents
through the same HS and negative-sampling batch updates as Word2Vec: the
label rows are appended to the word rows as one input table, so a label
update is a word update with input row ``V + label_id``, and the HS update
runs kernel #5. ``train_words=False`` freezes the word vectors (pure DBOW).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import upload
from deeplearning4j_tpu_torch.models.word2vec import (
    Word2Vec,
    _f32,
    _host,
    _hs_math_merged,
    _init_table,
    _ns_math_merged,
    skipgram_pairs,  # noqa: F401  (re-exported; public through this module)
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
)


class ParagraphVectors(Word2Vec):
    def __init__(self, train_words: bool = True, **kw):
        super().__init__(**kw)
        self.train_words = train_words
        self.labels: dict[str, int] = {}
        self.syn0_labels: torch.Tensor | None = None

    def _reset_label_weights(self) -> None:
        """Label vectors (uniform(key(seed + 1), (n_labels, D)) - 0.5) / D,
        the reference's table bit for bit."""
        self.syn0_labels = _init_table(
            self.seed + 1, (len(self.labels), self.layer_size), self.device)

    def fit_labeled(self, labeled_sentences) -> None:
        """labeled_sentences: iterable of (label, sentence) pairs (e.g. a
        ``LabelAwareSentenceIterator``)."""
        pairs = list(labeled_sentences)
        sents = CollectionSentenceIterator([s for _, s in pairs])
        if len(self.cache) == 0:
            self.build_vocab(sents)
        if self.syn0 is None:
            self.reset_weights()
        for label, _ in pairs:
            if label not in self.labels:
                self.labels[label] = len(self.labels)
        self._reset_label_weights()

        if self.train_words:
            self.fit(sents)

        # the label pass: (label row, word) pairs, the label predicting each
        # word of its document, enumerated once on the host
        v = self.syn0.shape[0]
        ins_list, tgt_list = [], []
        for label, sent in pairs:
            ids = self.cache.encode(self.tokenize(sent))
            if not ids:
                continue
            ins_list.append(
                np.full(len(ids), v + self.labels[label], np.int64)
            )
            tgt_list.append(np.asarray(ids, np.int64))
        if not ins_list:
            return
        all_ins = np.concatenate(ins_list)
        all_tgts = np.concatenate(tgt_list)

        # input rows = words + labels + ONE zero scratch row: the padding
        # pairs of the last batch point their input at the scratch row, so
        # their syn1/syn1neg deltas are exactly g * h = 0 (h is gathered
        # before the batch's scatter) and the only garbage lands on the
        # scratch row, which is dropped after training. The merged table is
        # inputs | syn1 | syn1neg.
        d = self.syn0.shape[1]
        nl = len(self.labels)
        scratch = v + nl
        n_in, n1 = scratch + 1, self.syn1.shape[0]
        S = torch.cat([self.syn0, self.syn0_labels,
                       torch.zeros((1, d), device=self.device),
                       self.syn1, self.syn1neg])
        b = self.batch_pairs
        rng = np.random.default_rng(self.seed + 2)
        lr = _f32(self.lr)

        # the label pass trains at a fixed lr, so its epochs are the same
        # pair stream repeated; every batch is full but the last, padded
        # with scratch pairs
        n0 = len(all_ins)
        total = n0 * self.epochs
        n_batches = -(-total // b)
        idx = np.arange(total) % n0
        ins = np.full(n_batches * b, scratch, np.int64)
        tgts = np.zeros(n_batches * b, np.int64)
        ins[:total], tgts[:total] = all_ins[idx], all_tgts[idx]
        ins_d, tgts_d = upload(ins, self.device), upload(tgts, self.device)
        batches = [slice(k * b, (k + 1) * b) for k in range(n_batches)]

        if self.use_hs:
            codes, points, mask = self._huffman()
            for sl in batches:
                t = tgts_d[sl]
                _hs_math_merged(S, n_in, ins_d[sl], codes[t], points[t],
                                mask[t], lr)
        if self.negative > 0:
            # the label row is pulled toward its words' syn1neg rows and
            # away from unigram-table draws
            if self._table is None:
                self._table = self.cache.unigram_table()
            table = self._table
            # the HS pass may have left garbage on the scratch row; NS pads
            # must gather h = 0 again for exact no-op deltas
            S[scratch] = 0.0
            for sl in batches:
                negs = table[rng.integers(0, len(table), size=(b, self.negative))]
                _ns_math_merged(S, n_in + n1, ins_d[sl], tgts_d[sl],
                                upload(negs.astype(np.int64), self.device), lr)

        self.syn0 = S[:v]
        self.syn0_labels = S[v:scratch]
        self.syn1 = S[n_in:n_in + n1]
        self.syn1neg = S[n_in + n1:]

    def get_label_vector(self, label: str) -> np.ndarray | None:
        i = self.labels.get(label)
        return None if i is None else _host(self.syn0_labels[i])

    def infer_nearest_label(self, sentence: str) -> str | None:
        """Classify by cosine between the document's mean word vector and
        the label vectors."""
        ids = self.cache.encode(self.tokenize(sentence))
        if not ids or not self.labels:
            return None
        doc = _host(self.syn0)[ids].mean(0)
        mat = _host(self.syn0_labels)
        sims = mat @ doc / (
            np.linalg.norm(mat, axis=1) * np.linalg.norm(doc) + 1e-9
        )
        inv = {v: k for k, v in self.labels.items()}
        return inv[int(np.argmax(sims))]
