"""Stopword list (the port's copy of ``deeplearning4j_tpu/nlp/stopwords.py``)."""

STOP_WORDS = frozenset(
    """a an and are as at be but by for from had has have he her his i if in
    into is it its me my no not of on or s so t that the their them then
    there these they this to was we were what when which who will with would
    you your""".split()
)


def is_stop_word(token: str) -> bool:
    return token.lower() in STOP_WORDS


def remove_stop_words(tokens: list[str]) -> list[str]:
    return [t for t in tokens if t.lower() not in STOP_WORDS]
