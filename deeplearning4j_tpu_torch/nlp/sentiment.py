"""Lexicon-based sentiment scoring
(the port's copy of ``deeplearning4j_tpu/nlp/sentiment.py``).

≙ reference text/corpora/sentiwordnet/SWN3.java:225 — a SentiWordNet
lookup scoring tokens as weak/strong positive/negative.  The reference
ships the SentiWordNet data file as a resource; here a compact built-in
polarity lexicon plays that role, with the same bucketed verdicts, and a
full SentiWordNet file can be loaded when present.
"""

from __future__ import annotations

from pathlib import Path

_POS = {
    "good": 0.6, "great": 0.8, "excellent": 0.9, "fine": 0.4, "nice": 0.5,
    "love": 0.8, "happy": 0.7, "wonderful": 0.9, "best": 0.9, "amazing": 0.8,
    "awesome": 0.8, "fantastic": 0.8, "enjoy": 0.6, "beautiful": 0.7,
    "perfect": 0.9, "brilliant": 0.8, "superb": 0.8, "positive": 0.5,
}
_NEG = {
    "bad": -0.6, "awful": -0.8, "terrible": -0.9, "poor": -0.5, "sad": -0.5,
    "hate": -0.8, "horrible": -0.9, "worst": -0.9, "boring": -0.5,
    "disappointing": -0.7, "ugly": -0.6, "wrong": -0.4, "negative": -0.5,
    "broken": -0.5, "fail": -0.6, "failure": -0.7, "annoying": -0.6,
}
_NEGATIONS = {"not", "no", "never", "n't", "hardly"}


class SentiWordNet:
    """score(text) -> float in [-1, 1]; verdict(text) -> bucketed label
    (≙ SWN3's strong/weak positive/negative/neutral buckets)."""

    def __init__(self, lexicon: dict[str, float] | None = None):
        self.lexicon = dict(lexicon) if lexicon else {**_POS, **_NEG}

    @classmethod
    def from_sentiwordnet_file(cls, path: str | Path) -> "SentiWordNet":
        """Load the real SentiWordNet 3.0 TSV when available."""
        lex: dict[str, list[float]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split("\t")
                if len(parts) < 5:
                    continue
                try:
                    pos_s, neg_s = float(parts[2]), float(parts[3])
                except ValueError:
                    continue
                for term in parts[4].split():
                    word = term.rsplit("#", 1)[0]
                    lex.setdefault(word, []).append(pos_s - neg_s)
        return cls({w: sum(v) / len(v) for w, v in lex.items()})

    def score_tokens(self, tokens: list[str]) -> float:
        total, n = 0.0, 0
        negate = False
        for t in tokens:
            tl = t.lower()
            if tl in _NEGATIONS:
                negate = True
                continue
            s = self.lexicon.get(tl)
            if s is not None:
                total += -s if negate else s
                n += 1
            negate = False
        return total / n if n else 0.0

    def score(self, text: str) -> float:
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer

        return self.score_tokens(DefaultTokenizer().tokens(text))

    def verdict(self, text: str) -> str:
        s = self.score(text)
        if s >= 0.6:
            return "strong_positive"
        if s >= 0.2:
            return "positive"
        if s > -0.2:
            return "neutral"
        if s > -0.6:
            return "negative"
        return "strong_negative"
