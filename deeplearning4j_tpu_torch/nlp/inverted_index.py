"""In-memory inverted index with npz persistence
(the port's copy of ``deeplearning4j_tpu/nlp/inverted_index.py``).

≙ reference text/invertedindex/InvertedIndex.java:233 (interface) and
text/invertedindex/LuceneInvertedIndex.java:910 — the Lucene-backed
doc/word index that backs Word2Vec minibatching and sampling.  The
reference surface this covers:

- ``addWordsToDoc`` / ``document`` / ``documents(word)`` / ``numDocuments``
  / ``allDocs`` → :meth:`add_document`, :meth:`document`,
  :meth:`documents`, :meth:`num_documents`, :meth:`all_docs`.
- ``addLabelForDoc`` / ``documentWithLabel`` / ``documentWithLabels`` →
  per-doc label sets (:meth:`add_label_for_doc`,
  :meth:`document_with_labels`).
- ``sample()`` + ``miniBatches()`` (LuceneInvertedIndex samples docs with
  probability ``sample`` when building training mini-batches) →
  :meth:`mini_batches`.
- ``batchIter(batchSize)`` → :meth:`batches`.
- the Lucene directory persistence → :meth:`save` / :meth:`load` on an
  npz archive (token and posting arrays; no Lucene, no JVM).
"""

from __future__ import annotations

import numpy as np


class InvertedIndex:
    def __init__(self, sample: float = 0.0):
        # sample: probability of including each doc in a mini-batch pass
        # (0 disables sampling) ≙ LuceneInvertedIndex's `sample` field.
        self._docs: list[list[str]] = []
        self._labels: dict[int, list[str]] = {}
        self._postings: dict[str, list[int]] = {}
        self.sample = float(sample)

    # -- building ---------------------------------------------------------
    def add_document(self, tokens: list[str], labels: list[str] | None = None) -> int:
        doc_id = len(self._docs)
        self._docs.append(list(tokens))
        for t in set(tokens):
            self._postings.setdefault(t, []).append(doc_id)
        if labels:
            self._labels[doc_id] = list(labels)
        return doc_id

    def add_word_to_doc(self, doc_id: int, word: str) -> None:
        while len(self._docs) <= doc_id:
            self._docs.append([])
        self._docs[doc_id].append(word)
        posting = self._postings.setdefault(word, [])
        # postings stay sorted and unique even under interleaved adds
        # across docs
        if doc_id not in posting:
            import bisect

            bisect.insort(posting, doc_id)

    def add_label_for_doc(self, doc_id: int, label: str) -> None:
        if not label or "\x00" in label:
            # empty labels vanish and NUL collides with the persistence
            # separator — reject instead of silently corrupting round-trips
            raise ValueError(f"invalid label {label!r}")
        self._labels.setdefault(doc_id, [])
        if label not in self._labels[doc_id]:
            self._labels[doc_id].append(label)

    # -- lookup -----------------------------------------------------------
    def document(self, doc_id: int) -> list[str]:
        return self._docs[doc_id]

    def document_with_labels(self, doc_id: int) -> tuple[list[str], list[str]]:
        return self._docs[doc_id], self._labels.get(doc_id, [])

    def documents(self, word: str) -> list[int]:
        return self._postings.get(word, [])

    def num_documents(self) -> int:
        return len(self._docs)

    def doc_frequency(self, word: str) -> int:
        return len(self._postings.get(word, ()))

    def all_docs(self) -> list[list[str]]:
        return self._docs

    # -- batching / sampling ----------------------------------------------
    def sample_docs(self, n: int, seed: int = 0) -> list[list[str]]:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(self._docs), size=min(n, len(self._docs)), replace=False)
        return [self._docs[i] for i in idx]

    def batches(self, batch_size: int):
        for i in range(0, len(self._docs), batch_size):
            yield self._docs[i : i + batch_size]

    def mini_batches(self, batch_size: int, seed: int = 0):
        """Yield doc batches, keeping each doc with probability ``sample``
        (all docs when sample<=0) — ≙ LuceneInvertedIndex.miniBatches()."""
        rng = np.random.default_rng(seed)
        batch: list[list[str]] = []
        for doc in self._docs:
            if 0.0 < self.sample < 1.0 and rng.random() >= self.sample:
                continue
            batch.append(doc)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist to an npz archive (≙ the Lucene directory the reference
        index writes through IndexWriter, LuceneInvertedIndex.java:910)."""
        if not path.endswith(".npz"):
            path += ".npz"  # savez appends it anyway; keep load symmetric
        tokens: list[str] = []
        doc_offsets = np.zeros(len(self._docs) + 1, dtype=np.int64)
        for i, doc in enumerate(self._docs):
            tokens.extend(doc)
            doc_offsets[i + 1] = len(tokens)
        label_ids = sorted(self._labels)
        # unicode dtype (not object) so load never needs allow_pickle —
        # a pickled npz from an untrusted path would be code execution
        np.savez_compressed(
            path,
            tokens=np.asarray(tokens, dtype=np.str_),
            doc_offsets=doc_offsets,
            label_doc_ids=np.asarray(label_ids, dtype=np.int64),
            label_values=np.asarray(
                ["\x00".join(self._labels[i]) for i in label_ids],
                dtype=np.str_,
            ),
            sample=np.float64(self.sample),
        )

    @classmethod
    def load(cls, path: str) -> "InvertedIndex":
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            tokens = z["tokens"].tolist()
            offsets = z["doc_offsets"]
            idx = cls(sample=float(z["sample"]))
            for i in range(len(offsets) - 1):
                idx.add_document(tokens[offsets[i] : offsets[i + 1]])
            for doc_id, joined in zip(z["label_doc_ids"], z["label_values"]):
                for label in str(joined).split("\x00"):
                    if label:
                        idx.add_label_for_doc(int(doc_id), label)
        return idx
