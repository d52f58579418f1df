"""The port's text pipeline held against the JAX package's: tokenizers,
iterators, the vocabulary with its Huffman arrays and unigram table, the
skip-gram pair enumerator (element for element, against the native pass
and its numpy fallback) and the word-vector files (byte for byte)."""

import numpy as np
import pytest

from deeplearning4j_tpu import native_io as ref_io
from deeplearning4j_tpu.nlp import serializer as ref_ser
from deeplearning4j_tpu.nlp import sentence_iterator as ref_it
from deeplearning4j_tpu.nlp import stopwords as ref_stop
from deeplearning4j_tpu.nlp import tokenization as ref_tok
from deeplearning4j_tpu.nlp.vocab import VocabCache as RefVocab
from deeplearning4j_tpu_torch import native_io
from deeplearning4j_tpu_torch.nlp import serializer, sentence_iterator, stopwords
from deeplearning4j_tpu_torch.nlp import tokenization as tok
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache

TEXTS = [
    "Hello, World! it's fine.",
    "Café, DÉJÀ-vu! The cat   sat on the mat.",
    "One. Two! Three? four",
    "naïve Ünïcode tokens — dashes 42 and don't",
    "",
]


def _zipf_sentences(n_sent, n_tok, n_types, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_types + 1)
    ranks = rng.choice(n_types, size=(n_sent, n_tok), p=p / p.sum())
    return [" ".join(f"w{r}" for r in row) for row in ranks]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_match_reference(text):
    assert tok.DefaultTokenizer().tokens(text) == ref_tok.DefaultTokenizer().tokens(text)
    pre = (tok.lowercase, tok.strip_punctuation, tok.ending_preprocessor)
    ref_pre = (ref_tok.lowercase, ref_tok.strip_punctuation,
               ref_tok.ending_preprocessor)
    assert (tok.TokenizerFactory(pre).create().tokens(text)
            == ref_tok.TokenizerFactory(ref_pre).create().tokens(text))
    assert (tok.NGramTokenizer(tok.DefaultTokenizer(), 1, 3).tokens(text)
            == ref_tok.NGramTokenizer(ref_tok.DefaultTokenizer(), 1, 3).tokens(text))
    assert tok.input_homogenization(text) == ref_tok.input_homogenization(text)
    assert (tok.input_homogenization(text, preserve_case=True)
            == ref_tok.input_homogenization(text, preserve_case=True))
    assert tok.split_sentences(text) == ref_tok.split_sentences(text)
    toks = text.split()
    assert stopwords.remove_stop_words(toks) == ref_stop.remove_stop_words(toks)
    assert ([stopwords.is_stop_word(t) for t in toks]
            == [ref_stop.is_stop_word(t) for t in toks])


def test_sentence_iterators_match_reference(tmp_path):
    (tmp_path / "text.txt").write_text("line one\n\n  line two \nthree\n")
    root = tmp_path / "corpus"
    (root / "pos" / "sub").mkdir(parents=True)
    (root / "neg").mkdir()
    (root / "pos" / "a.txt").write_text("Good stuff. Nice thing!")
    (root / "pos" / "sub" / "c.txt").write_text("Deep file? Yes.")
    (root / "neg" / "b.txt").write_text("Bad stuff.")
    up = str.upper
    cases = [
        (sentence_iterator.CollectionSentenceIterator(TEXTS, up),
         ref_it.CollectionSentenceIterator(TEXTS, up)),
        (sentence_iterator.LineSentenceIterator(tmp_path / "text.txt"),
         ref_it.LineSentenceIterator(tmp_path / "text.txt")),
        (sentence_iterator.FileSentenceIterator(root, up),
         ref_it.FileSentenceIterator(root, up)),
        (sentence_iterator.LabelAwareSentenceIterator(root),
         ref_it.LabelAwareSentenceIterator(root)),
        (sentence_iterator.DocumentIterator(root),
         ref_it.DocumentIterator(root)),
    ]
    for port, ref in cases:
        got = list(port)
        assert got == list(ref) and got
        port.reset()
        assert list(port) == got  # iterable again after reset


@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_huffman_and_unigram_table_match_reference(min_freq):
    sents = _zipf_sentences(60, 40, 150, seed=min_freq)
    t = tok.DefaultTokenizer()
    toks = [t.tokens(s) for s in sents]
    port = VocabCache(min_freq).fit(toks)
    ref = RefVocab(min_freq).fit(toks)
    port.build_huffman()
    ref.build_huffman()
    assert port.words() == ref.words() and len(port) > 20
    assert [port.word_frequency(w) for w in port.words()] == [
        ref.word_frequency(w) for w in ref.words()]
    assert (port.total_word_count, port.num_docs, port.max_code_length) == (
        ref.total_word_count, ref.num_docs, ref.max_code_length)
    for a, b in zip(port.huffman_arrays(), ref.huffman_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for size in (1000, 1 << 17):
        np.testing.assert_array_equal(port.unigram_table(size),
                                      ref.unigram_table(size))
    assert port.encode(toks[0] + ["unseen"]) == ref.encode(toks[0] + ["unseen"])


def test_vocab_fit_texts_matches_reference():
    texts = TEXTS + _zipf_sentences(20, 30, 50, seed=9) + ["The THE the Ab"]
    for lower in (True, False):
        for mc in (1, 2):
            port = VocabCache(mc).fit_texts(texts, lowercase=lower)
            ref = RefVocab(mc).fit_texts(texts, lowercase=lower)
            assert port.words() == ref.words()
            assert [port.word_frequency(w) for w in port.words()] == [
                ref.word_frequency(w) for w in ref.words()]
            assert port.total_word_count == ref.total_word_count
            assert port.num_docs == ref.num_docs
    words, counts, total = native_io.count_vocab(texts, 1)
    ref_words, ref_counts, ref_total = ref_io.count_vocab(texts, 1)
    assert words == ref_words and total == ref_total
    np.testing.assert_array_equal(counts, ref_counts)


@pytest.fixture(params=["native", "numpy"])
def ref_pairs(request, monkeypatch):
    """The reference enumerator: its C++ pass, or its numpy fallback."""
    if request.param == "native":
        if not ref_io.available():
            pytest.skip("no g++ toolchain for the reference's native pass")
    else:
        monkeypatch.setattr(ref_io, "_lib", None)
        monkeypatch.setattr(ref_io, "_tried", True)
    return ref_io.sg_pairs_chunk


@pytest.mark.parametrize("window", [0, 1, 4, 5])
@pytest.mark.parametrize("seed", [0, 99, 2**63 + 5])
def test_sg_pairs_chunk_equals_reference(ref_pairs, window, seed):
    """Element for element, over odd sentence lengths (0, 1 and 2 words
    included: every word takes a draw) and window 0."""
    rng = np.random.default_rng(5)
    sents = [rng.integers(0, 100, size=n).astype(np.int32)
             for n in [1, 2, 7, 30, 0, 3]]
    a_in, a_tg = native_io.sg_pairs_chunk(sents, window, seed)
    b_in, b_tg = ref_pairs(sents, window, seed)
    assert a_in.dtype == a_tg.dtype == np.int32
    np.testing.assert_array_equal(a_in, b_in)
    np.testing.assert_array_equal(a_tg, b_tg)
    assert (len(a_in) > 0) == (window > 0)


def test_splitmix64_stream_matches_sequential_draws():
    """The vectorized stream is the sequential generator of
    native/splitmix64.h, draw for draw (a wrap of the state included)."""
    for seed in (0, 7, 2**64 - 3):
        state, want = seed, []
        for _ in range(5):
            state = (state + 0x9E3779B97F4A7C15) % 2**64
            z = state
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
            want.append(z ^ (z >> 31))
        assert native_io.splitmix64(seed, 5).tolist() == want


def test_serializer_files_byte_equal_to_reference(tmp_path):
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "café", "it's"]
    vecs = rng.standard_normal((4, 7)).astype(np.float32)
    coords = rng.standard_normal((4, 2)).astype(np.float32)
    for write, ref_write, name in (
        (serializer.write_text, ref_ser.write_text, "v.txt"),
        (serializer.write_binary, ref_ser.write_binary, "v.bin"),
        (serializer.write_tsne_csv, ref_ser.write_tsne_csv, "t.csv"),
    ):
        data = coords if name == "t.csv" else vecs
        write(tmp_path / f"port_{name}", words, data)
        ref_write(tmp_path / f"ref_{name}", words, data)
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"ref_{name}").read_bytes())
    w, v = serializer.read_binary(tmp_path / "ref_v.bin")
    assert w == words and np.array_equal(v, vecs)
    w, v = serializer.read_text(tmp_path / "ref_v.txt")
    rw, rv = ref_ser.read_text(tmp_path / "ref_v.txt")
    assert w == rw == words and np.array_equal(v, rv)
