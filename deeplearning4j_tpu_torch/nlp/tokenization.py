"""Tokenizers and preprocessing (the port's copy of
``deeplearning4j_tpu/nlp/tokenization.py``): ``DefaultTokenizer`` (word
characters and apostrophes, lowercased), ``NGramTokenizer``,
``TokenizerFactory``, ``input_homogenization`` (accents and punctuation
stripped) and the regex sentence segmenter ``split_sentences``.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Callable, Iterable, Protocol

TokenPreProcess = Callable[[str], str]


def lowercase(token: str) -> str:
    return token.lower()


def strip_punctuation(token: str) -> str:
    return token.strip(string.punctuation)


def ending_preprocessor(token: str) -> str:
    """Crude stemming of plural/verb endings."""
    for end in ("ies", "s", "ed", "ing", "ly"):
        if token.endswith(end) and len(token) > len(end) + 2:
            return token[: -len(end)]
    return token


def input_homogenization(text: str, preserve_case: bool = False) -> str:
    """Strip accents and punctuation, lowercase."""
    text = unicodedata.normalize("NFD", text)
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    text = "".join(c if c not in string.punctuation else " " for c in text)
    return text if preserve_case else text.lower()


class Tokenizer(Protocol):
    def tokens(self, text: str) -> list[str]: ...


class DefaultTokenizer:
    """Whitespace/word-boundary tokenizer with optional preprocessors."""

    _WORD = re.compile(r"[\w']+")

    def __init__(self, preprocessors: Iterable[TokenPreProcess] = (lowercase,)):
        self.preprocessors = list(preprocessors)

    def tokens(self, text: str) -> list[str]:
        out = []
        for token in self._WORD.findall(text):
            for pp in self.preprocessors:
                token = pp(token)
            if token:
                out.append(token)
        return out


class NGramTokenizer:
    """Emits the n-grams (n_min..n_max) over the base tokens."""

    def __init__(self, base: Tokenizer, n_min: int = 1, n_max: int = 2):
        self.base = base
        self.n_min = n_min
        self.n_max = n_max

    def tokens(self, text: str) -> list[str]:
        toks = self.base.tokens(text)
        out = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i : i + n]))
        return out


class TokenizerFactory:
    """Builds tokenizers with shared preprocessors."""

    def __init__(self, preprocessors: Iterable[TokenPreProcess] = (lowercase,)):
        self.preprocessors = list(preprocessors)

    def create(self) -> DefaultTokenizer:
        return DefaultTokenizer(self.preprocessors)


_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> list[str]:
    """Regex sentence segmenter."""
    return [s.strip() for s in _SENT_SPLIT.split(text) if s.strip()]
