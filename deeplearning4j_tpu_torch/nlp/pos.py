"""Part-of-speech tagging (the port of ``deeplearning4j_tpu/nlp/pos.py``).

≙ reference text/annotator/PoStagger.java:263 (UIMA annotator wrapping an
external OpenNLP maxent model) and the PoS-augmented moving-window
featurization it feeds.  The reference ships no trainable tagger — it
loads a binary model; here the tagger is first-class and trainable.

An HMM tagger: emission/transition counts accumulated host-side from tagged
sentences, decoding through the port's Viterbi (``utils/viterbi.py``, a
loop over the positions on tensors on the tagger's device).  Unknown words
back off to a suffix lexicon.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

# Minimal suffix/regex backoff, used for words unseen in training (and by
# the untrained tagger): coarse universal-style tags.
_SUFFIX_RULES: list[tuple[str, str]] = [
    ("ing", "VERB"),
    ("ed", "VERB"),
    ("ly", "ADV"),
    ("ous", "ADJ"),
    ("ful", "ADJ"),
    ("able", "ADJ"),
    ("ible", "ADJ"),
    ("tion", "NOUN"),
    ("ment", "NOUN"),
    ("ness", "NOUN"),
    ("ity", "NOUN"),
    ("s", "NOUN"),
]
_CLOSED_CLASS = {
    "the": "DET", "a": "DET", "an": "DET", "this": "DET", "that": "DET",
    "in": "ADP", "on": "ADP", "at": "ADP", "of": "ADP", "for": "ADP",
    "to": "PRT", "and": "CONJ", "or": "CONJ", "but": "CONJ",
    "he": "PRON", "she": "PRON", "it": "PRON", "they": "PRON", "we": "PRON",
    "i": "PRON", "you": "PRON",
    "is": "VERB", "are": "VERB", "was": "VERB", "were": "VERB", "be": "VERB",
    "not": "ADV", "very": "ADV",
    ".": ".", ",": ".", "!": ".", "?": ".", ";": ".", ":": ".",
}


def rule_tag(word: str) -> str:
    """Lexicon + suffix backoff for a single token."""
    w = word.lower()
    if w in _CLOSED_CLASS:
        return _CLOSED_CLASS[w]
    if w and (w[0].isdigit() or w.replace(".", "", 1).isdigit()):
        return "NUM"
    for suffix, tag in _SUFFIX_RULES:
        if len(w) > len(suffix) + 1 and w.endswith(suffix):
            return tag
    return "NOUN"


class PosTagger:
    """HMM tagger with add-one smoothing and rule backoff for OOV words;
    decodes on ``device`` (``cuda`` unless the caller names another;
    raises without a card)."""

    def __init__(self, smoothing: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.smoothing = smoothing
        self.tags: list[str] = []
        self._tag_index: dict[str, int] = {}
        self._word_tag: dict[str, Counter] = defaultdict(Counter)
        self._viterbi: Viterbi | None = None
        self._emission_cache: dict[str, np.ndarray] = {}

    @property
    def trained(self) -> bool:
        return self._viterbi is not None

    def fit(self, tagged_sentences: list[list[tuple[str, str]]]) -> None:
        """tagged_sentences: [[(word, tag), ...], ...]"""
        tagset = sorted({t for sent in tagged_sentences for _, t in sent})
        self.tags = tagset
        self._tag_index = {t: i for i, t in enumerate(tagset)}
        s = len(tagset)
        trans = np.full((s, s), self.smoothing)
        start = np.full(s, self.smoothing)
        for sent in tagged_sentences:
            prev = None
            for word, tag in sent:
                i = self._tag_index[tag]
                self._word_tag[word.lower()][tag] += 1
                if prev is None:
                    start[i] += 1
                else:
                    trans[prev, i] += 1
                prev = i
        trans /= trans.sum(axis=1, keepdims=True)
        start /= start.sum()
        self._viterbi = Viterbi(trans, start, device=self.device)
        self._emission_cache.clear()

    def _emission_row(self, word: str) -> np.ndarray:
        w = word.lower()
        cached = self._emission_cache.get(w)
        if cached is not None:
            return cached
        s = len(self.tags)
        counts = self._word_tag.get(w)
        if counts:
            row = np.full(s, self.smoothing * 0.01)
            for tag, c in counts.items():
                row[self._tag_index[tag]] += c
        else:  # OOV: point mass (plus floor) on the rule-backoff tag
            row = np.full(s, 0.1)
            t = rule_tag(word)
            if t in self._tag_index:
                row[self._tag_index[t]] += 1.0
        row = row / row.sum()
        self._emission_cache[w] = row
        return row

    def tag(self, words: list[str]) -> list[tuple[str, str]]:
        """Most likely tag sequence for a tokenized sentence."""
        if not words:
            return []
        if not self.trained:
            return [(w, rule_tag(w)) for w in words]
        emissions = np.stack([self._emission_row(w) for w in words])
        path, _ = self._viterbi.decode(emissions)
        return [(w, self.tags[int(i)]) for w, i in zip(words, path)]

    def tag_sentence(self, sentence: str, tokenizer=None) -> list[tuple[str, str]]:
        if tokenizer is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer

            tokenizer = DefaultTokenizer()
        return self.tag(tokenizer.tokens(sentence))


# PTB -> coarse universal tag mapping for training from the bundled
# treebank (nlp/parser.py), which carries PTB preterminals
_PTB_TO_UNIVERSAL = {
    "DT": "DET", "NN": "NOUN", "NNS": "NOUN", "NNP": "NOUN",
    "VBD": "VERB", "VBZ": "VERB", "VB": "VERB", "VBG": "VERB",
    "IN": "ADP", "JJ": "ADJ", "PRP": "PRON", "RB": "ADV", "CC": "CONJ",
    "TO": "PRT", "CD": "NUM",
}


def tagged_sentences_from_treebank() -> list[list[tuple[str, str]]]:
    """(word, universal-tag) sequences extracted from the bundled
    mini-treebank — the training corpus the default tagger ships with
    (the reference ships a pretrained OpenNLP binary instead)."""
    from deeplearning4j_tpu_torch.nlp.parser import bundled_treebank

    out = []
    for tree in bundled_treebank():
        sent = []
        for leaf in tree.leaves():
            if leaf.word is None:
                continue
            tag = _PTB_TO_UNIVERSAL.get(leaf.label, "NOUN")
            sent.append((leaf.word, tag))
        if sent:
            out.append(sent)
    return out


def default_tagger(device=None) -> PosTagger:
    """A PosTagger pre-trained on the bundled treebank (built fresh each
    call; training is a few ms), decoding on ``device``. OOV words still
    flow through the suffix/lexicon backoff inside the HMM emissions."""
    tagger = PosTagger(device=device)
    tagger.fit(tagged_sentences_from_treebank())
    return tagger
