"""The port's text tools: trees, the PCFG-CKY parser, the Porter stemmer,
Viterbi and the HMM POS tagger, the sentiment lexicon, the vectorizers and
the inverted index. The reference's assertions (tests/test_parser.py,
tests/test_stemmer.py, the tree and Viterbi cases of
tests/test_rntn_utils.py, the text cases of tests/test_nlp.py and
tests/test_aux_utils.py, the POS cases of tests/test_gapfill.py) re-run on
the port, and the port held against the JAX package where both compute:
the parses, the tags, the Viterbi paths and scores (a planted tie goes to
the lowest state, as ``jnp.argmax``), the vectors.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nlp.inverted_index import InvertedIndex
from deeplearning4j_tpu_torch.nlp.parser import (
    CkyParser,
    Pcfg,
    bundled_treebank,
    default_parser,
)
from deeplearning4j_tpu_torch.nlp.pos import PosTagger, default_tagger, rule_tag
from deeplearning4j_tpu_torch.nlp.sentiment import SentiWordNet
from deeplearning4j_tpu_torch.nlp.stemmer import PorterStemmer, porter_stem
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer, lowercase
from deeplearning4j_tpu_torch.nlp.tree import (
    TreeVectorizer,
    binarize,
    collapse_unaries,
    parse_ptb,
    right_branching_tree,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    TfidfVectorizer,
    string_with_labels,
    window_to_vector,
    windows,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi, viterbi_decode

torch.set_num_threads(1)

#: Viterbi scores, port vs reference (f32 sums of logs in the same order)
SCORE_ATOL = 1e-5


@pytest.fixture
def ref():
    jax = pytest.importorskip("jax")
    from types import SimpleNamespace

    from deeplearning4j_tpu.nlp import parser, pos, tree
    from deeplearning4j_tpu.utils import viterbi

    return SimpleNamespace(jnp=jax.numpy, parser=parser, pos=pos, tree=tree,
                           viterbi=viterbi)


def _max_left_leaves(tree):
    """Largest left-child constituent (in leaves) anywhere in the tree."""
    best = 0
    for node in tree.subtrees():
        if len(node.children) == 2:
            best = max(best, len(node.children[0].leaves()))
    return best


# -- trees (tests/test_rntn_utils.py) -------------------------------------------

def test_ptb_parse_roundtrip():
    s = "(3 (2 good) (1 (0 not) (2 bad)))"
    t = parse_ptb(s)
    assert t.label == "3"
    assert t.words() == ["good", "not", "bad"]
    assert str(t) == "(3 (2 good) (1 (0 not) (2 bad)))"


def test_binarize_and_collapse():
    t = parse_ptb("(S (A a) (B b) (C c) (D d))")
    b = binarize(t)
    for node in b.subtrees():
        assert len(node.children) <= 2
    assert b.words() == ["a", "b", "c", "d"]
    u = parse_ptb("(S (X (Y (A a))) (B b))")
    c = collapse_unaries(u)
    assert c.words() == ["a", "b"]
    assert c.depth() <= u.depth()


def test_right_branching_and_vectorizer():
    t = right_branching_tree(["a", "b", "c"])
    assert t.words() == ["a", "b", "c"]
    for node in t.subtrees():
        assert len(node.children) in (0, 2)
    assert len(TreeVectorizer().trees("One two three. Four five.")) == 2


def test_tree_transforms_match_reference(ref):
    for s in ("(S (A a) (B b) (C c) (D d))", "(S (X (Y (A a))) (B b))",
              "(3 (2 good) (1 (0 not) (2 bad)))"):
        assert str(binarize(parse_ptb(s))) == str(
            ref.tree.binarize(ref.tree.parse_ptb(s)))
        assert str(collapse_unaries(parse_ptb(s))) == str(
            ref.tree.collapse_unaries(ref.tree.parse_ptb(s)))
    assert str(right_branching_tree(list("abcd"), label="1")) == str(
        ref.tree.right_branching_tree(list("abcd"), label="1"))


# -- the parser (tests/test_parser.py) ------------------------------------------

def test_bundled_treebank_parses():
    trees = bundled_treebank()
    assert len(trees) >= 200
    assert all(t.label == "S" for t in trees)


NONTOY = [
    "the engineer fixed the machine",
    "a lion chased the zebra near the river",
    "my sister wrote a poem about the sea",
    "the scientists said that the experiment failed",
    "the waiter who served the meal was friendly",
    "two tourists visited the museum and the castle",
    "the old sailor told the children a strange story",
    "she will not open the heavy door",
    "the kitten was sleeping under the warm blanket",
    "the soldiers marched slowly",
    "the painting that the artist sold was beautiful",
    "there is a spider on the wall",
    "he wanted to buy a new car",
    "the nurse helped the patient and the doctor",
    "the mountain is tall and quiet",
    "the students are writing essays",
    "the bread was baked by the baker",
    "the manager thought that the plan was good",
    "our neighbor walked from the station to the office",
    "the chef cooked a delicious dinner",
    "they should visit the ancient temple",
    "the singer sang happily",
    "a dolphin jumped over the wave",
    "the professor gave the lecture to the class",
    "the firefighters saved the family",
    "his brother became a pilot",
    "the librarian found the missing book",
    "the train left before the storm",
    "the gardener watered the flowers in the morning",
    "wolves hunt deer",
]


def test_cky_low_fallback_on_nontoy_sentences():
    p = default_parser()
    fallbacks = sum(1 for s in NONTOY if p.parse(s.split()) is None)
    assert fallbacks / len(NONTOY) < 0.20, f"{fallbacks}/{len(NONTOY)}"
    t = p.parse("the waiter who served the meal was friendly".split())
    assert t is not None
    labels = {n.label for n in t.subtrees()}
    assert "SBAR" in labels or any(lb.startswith("@") for lb in labels)


def test_parses_match_reference(ref):
    """Every sentence parses to the reference's tree, fallbacks alike."""
    p, r = default_parser(), ref.parser.default_parser()
    for s in NONTOY + ["the cat on the mat saw a dog", "the wug saw a florp"]:
        a, b = p.parse(s.split()), r.parse(s.split())
        assert (a is None) == (b is None), s
        assert a is None or str(a) == str(b), s


def test_cky_recovers_subject_pp_attachment():
    p = default_parser()
    toks = "the cat on the mat saw a dog".split()
    tree = p.parse(toks)
    assert tree is not None and tree.words() == toks
    assert len(tree.children[0].leaves()) == 5
    assert _max_left_leaves(binarize(right_branching_tree(toks))) == 1
    assert _max_left_leaves(tree) >= 5


def test_cky_handles_unknown_words():
    tree = default_parser().parse("the wug saw a florp".split())
    assert tree is not None
    assert tree.words() == ["the", "wug", "saw", "a", "florp"]


def test_fragments_empty_input_and_vectorizer_robustness():
    p = default_parser()
    single = p.parse(["the"])
    assert single is not None and single.words() == ["the"]
    assert p.parse([]) is None
    trees = TreeVectorizer().trees("the. the cat saw a dog.")
    assert len(trees) == 2
    assert all(len(t.words()) >= 1 for t in trees)


def test_vectorizer_trees_are_structurally_nontrivial():
    trees = TreeVectorizer().trees(
        "the cat on the mat saw a dog. the man in the park read a book.")
    assert len(trees) == 2
    assert all(_max_left_leaves(t) >= 5 for t in trees)
    fallback = TreeVectorizer(use_pcfg=False).trees("the cat saw a dog.")
    assert _max_left_leaves(fallback[0]) == 1


def test_rntn_trains_on_pcfg_parsed_raw_text():
    from deeplearning4j_tpu_torch.models.rntn import RNTN

    trees = TreeVectorizer().trees(
        "the cat on the mat saw a dog. the woman with the ball watched the "
        "child.")
    assert all(_max_left_leaves(t) >= 5 for t in trees)
    model = RNTN(num_classes=2, dim=6, seed=0, device="cpu")
    losses = model.fit_trees(trees, epochs=2)
    assert np.isfinite(losses).all()


def test_pcfg_from_trees_and_parser():
    g = Pcfg.from_trees([parse_ptb("(S (NP (DT the) (NN cat)) (VP (VBD sat)))")])
    tree = CkyParser(g).parse(["the", "cat", "sat"])
    assert tree is not None and tree.words() == ["the", "cat", "sat"]


def test_default_pos_tagger_trained_on_treebank():
    tagger = default_tagger(device="cpu")
    assert tagger.trained
    tags = dict(tagger.tag("the cat saw a dog".split()))
    assert tags["the"] == "DET" and tags["a"] == "DET"
    assert tags["cat"] == "NOUN" and tags["dog"] == "NOUN"
    assert tags["saw"] == "VERB"
    oov = dict(tagger.tag("the wug jumped".split()))
    assert oov["jumped"] == "VERB"


# -- the stemmer (tests/test_stemmer.py) ----------------------------------------

VECTORS = {
    "caresses": "caress", "ponies": "poni", "ties": "ti",
    "caress": "caress", "cats": "cat", "feed": "feed", "agreed": "agre",
    "plastered": "plaster", "motoring": "motor", "sing": "sing",
    "happy": "happi", "sky": "sky", "generalizations": "gener",
    "oscillators": "oscil", "university": "univers",
    "universities": "univers", "running": "run", "runner": "runner",
    "easily": "easili", "national": "nation", "nationality": "nation",
    "determination": "determin", "conditional": "condit",
    "effective": "effect", "hopping": "hop", "tanned": "tan",
    "falling": "fall", "hissing": "hiss", "filing": "file",
    "adjustable": "adjust", "replacement": "replac", "adoption": "adopt",
    "argue": "argu", "argued": "argu", "arguing": "argu",
}


def test_porter_canonical_vectors():
    for word, want in VECTORS.items():
        assert porter_stem(word) == want, (word, porter_stem(word), want)


def test_porter_matches_reference(ref):
    """The reference's stems on a word list (the reference's nltk oracle is
    not installed here; the reference was fuzzed against it)."""
    from deeplearning4j_tpu.nlp.stemmer import porter_stem as ref_stem

    words = (
        "the quick brown foxes were jumping over lazily sleeping dogs "
        "relational conditional rational operations digitizer radically "
        "hopefulness electrical revival allowance inference airliner "
        "gyroscopic irritant dependent homologous communism activated "
        "probate cease controlling rolled troubles troubling sensible "
        "sensibility capabilities derivational derived derive derives as is"
    ).split()
    for w in words:
        assert porter_stem(w) == ref_stem(w), w


def test_stemmer_composes_as_tokenizer_preprocessor():
    tok = DefaultTokenizer(preprocessors=(lowercase, PorterStemmer()))
    assert tok.tokens("The Runners were RUNNING easily!") == [
        "the", "runner", "were", "run", "easili"]


# -- Viterbi and POS (tests/test_rntn_utils.py, tests/test_gapfill.py) --------------

def test_viterbi_decodes_obvious_path():
    trans = np.array([[0.8, 0.2], [0.2, 0.8]])

    def emissions_for(obs):
        return np.array([[0.9, 0.1] if o == 0 else [0.1, 0.9] for o in obs])

    v = Viterbi(trans, device="cpu")
    path, score = v.decode(emissions_for([0, 0, 1, 1, 0]))
    assert path.tolist() == [0, 0, 1, 1, 0]
    assert score < 0


@pytest.mark.parametrize("t_len", [1, 2, 7, 30])
def test_viterbi_matches_reference(ref, t_len):
    g = np.random.default_rng(t_len)
    s = 5
    trans = g.random((s, s)) + 0.05
    trans /= trans.sum(1, keepdims=True)
    start = g.random(s) + 0.1
    start /= start.sum()
    em = g.random((t_len, s))
    path, score = Viterbi(trans, start, device="cpu").decode(em)
    rpath, rscore = ref.viterbi.Viterbi(trans, start).decode(em)
    np.testing.assert_array_equal(path, rpath)
    assert score == pytest.approx(rscore, abs=SCORE_ATOL)


def test_viterbi_planted_tie_goes_to_the_lowest_state(ref):
    """Uniform transitions and emissions: every state ties at every step,
    and both the back-pointers and the last state take state 0, as
    ``jnp.argmax`` does."""
    s, t = 4, 6
    lt = torch.full((s, s), float(np.log(0.25)))
    le = torch.full((t, s), float(np.log(0.5)))
    ls = torch.full((s,), float(np.log(0.25)))
    path, score = viterbi_decode(le, lt, ls)
    rpath, rscore = ref.viterbi.viterbi_decode(
        ref.jnp.asarray(le.numpy()), ref.jnp.asarray(lt.numpy()),
        ref.jnp.asarray(ls.numpy()))
    assert path.tolist() == [0] * t == np.asarray(rpath).tolist()
    assert float(score) == pytest.approx(float(rscore), abs=SCORE_ATOL)


def test_pos_rule_backoff():
    assert rule_tag("the") == "DET"
    assert rule_tag("running") == "VERB"
    assert rule_tag("quickly") == "ADV"
    assert rule_tag("42") == "NUM"


def test_pos_untrained_uses_rules():
    tags = dict(PosTagger(device="cpu").tag(["the", "dog", "runs",
                                             "quickly"]))
    assert tags["the"] == "DET"
    assert tags["quickly"] == "ADV"


def test_pos_hmm_disambiguates_by_context():
    corpus = []
    for _ in range(20):
        corpus.append([("i", "PRON"), ("can", "MD"), ("swim", "VERB")])
        corpus.append([("the", "DET"), ("can", "NOUN"), ("fell", "VERB")])
        corpus.append([("you", "PRON"), ("can", "MD"), ("run", "VERB")])
        corpus.append([("a", "DET"), ("can", "NOUN"), ("sat", "VERB")])
    tagger = PosTagger(device="cpu")
    tagger.fit(corpus)
    assert tagger.tag(["i", "can", "swim"])[1][1] == "MD"
    assert tagger.tag(["the", "can", "fell"])[1][1] == "NOUN"
    assert len(tagger.tag(["the", "zzzgadget", "fell"])) == 3


def test_default_tagger_matches_reference(ref):
    port, r = default_tagger(device="cpu"), ref.pos.default_tagger()
    for s in NONTOY[:12] + ["the wug jumped quickly over 42 florps"]:
        assert port.tag(s.split()) == r.tag(s.split()), s
    assert port.tag_sentence("The cat sat.") == r.tag_sentence("The cat sat.")
    assert port.tag([]) == []


# -- sentiment (tests/test_aux_utils.py) ----------------------------------------

def test_sentiment_scoring():
    s = SentiWordNet()
    assert s.score("a great wonderful movie") > 0.5
    assert s.score("an awful terrible film") < -0.5
    assert s.verdict("this was great and amazing") in ("positive",
                                                       "strong_positive")
    assert s.verdict("the plot was awful") in ("negative", "strong_negative")
    assert s.verdict("the chair is wooden") == "neutral"
    assert s.score("not good") < 0


def test_sentiwordnet_file_loader(tmp_path):
    f = tmp_path / "swn.txt"
    f.write_text(
        "# comment\n"
        "a\t1\t0.75\t0\tgood#1 fine#2\tgloss\n"
        "a\t2\t0\t0.875\tbad#1\tgloss\n"
    )
    s = SentiWordNet.from_sentiwordnet_file(f)
    assert s.lexicon["good"] == pytest.approx(0.75)
    assert s.lexicon["bad"] == pytest.approx(-0.875)
    assert s.score("good") > 0 > s.score("bad")


# -- vectorizers and the inverted index (tests/test_nlp.py) -----------------------

def test_bow_and_tfidf():
    texts = ["the cat sat", "the dog sat", "the cat ran"]
    bow = BagOfWordsVectorizer().fit(texts)
    m = bow.transform(texts)
    assert m.shape == (3, len(bow.cache))
    assert m[0, bow.cache.index_of("cat")] == 1
    tfidf = TfidfVectorizer().fit(texts)
    t = tfidf.transform(texts)
    assert t[0, tfidf.cache.index_of("the")] < t[0, tfidf.cache.index_of(
        "cat")]
    w = windows(["a", "b", "c"], window_size=3)
    assert len(w) == 3 and w[0] == ["<NONE>", "a", "b"]


def test_window_to_vector():
    cache = VocabCache().fit([["a", "b"]])
    emb = np.arange(4, dtype=np.float32).reshape(2, 2)
    v = window_to_vector(["<NONE>", "a", "b"], emb, cache, 2)
    np.testing.assert_array_equal(
        v, np.concatenate([[0, 0], emb[cache.index_of("a")],
                           emb[cache.index_of("b")]]))


def test_context_label_retriever():
    clean, spans = string_with_labels(
        "the <ORG> acme corp </ORG> hired <PER> jane </PER> today")
    assert clean == "the acme corp hired jane today"
    assert spans == {(1, 3): "ORG", (4, 5): "PER"}
    with pytest.raises(ValueError, match="no begin label"):
        string_with_labels("oops </ORG> here")
    with pytest.raises(ValueError, match="unclosed"):
        string_with_labels("<ORG> acme corp")
    with pytest.raises(ValueError, match="mismatch"):
        string_with_labels("<ORG> acme </PER>")


def test_inverted_index():
    idx = InvertedIndex()
    idx.add_document(["a", "b"])
    idx.add_document(["b", "c"])
    assert idx.documents("b") == [0, 1]
    assert idx.doc_frequency("a") == 1
    assert idx.document(1) == ["b", "c"]


def test_inverted_index_persistence_labels_minibatches(tmp_path):
    idx = InvertedIndex(sample=0.0)
    idx.add_document(["a", "b"], labels=["pos"])
    idx.add_document(["b", "c"])
    idx.add_label_for_doc(1, "neg")
    idx.add_word_to_doc(1, "d")
    assert idx.document_with_labels(0) == (["a", "b"], ["pos"])
    assert idx.documents("d") == [1]
    path = str(tmp_path / "index.npz")
    idx.save(path)
    loaded = InvertedIndex.load(path)
    assert loaded.num_documents() == 2
    assert loaded.all_docs() == idx.all_docs()
    assert loaded.document_with_labels(1) == (["b", "c", "d"], ["neg"])
    assert loaded.documents("b") == [0, 1]
    batches = list(loaded.mini_batches(1))
    assert [b[0] for b in batches] == loaded.all_docs()
    loaded.sample = 1e-9
    assert list(loaded.mini_batches(2, seed=1)) == []


def test_inverted_index_file_reads_in_the_reference(ref, tmp_path):
    """The npz the port writes loads in the reference, and back."""
    from deeplearning4j_tpu.nlp.inverted_index import InvertedIndex as Ref

    idx = InvertedIndex()
    idx.add_document(["x", "y"], labels=["l"])
    idx.save(str(tmp_path / "a.npz"))
    back = Ref.load(str(tmp_path / "a.npz"))
    assert back.document_with_labels(0) == (["x", "y"], ["l"])
    back.save(str(tmp_path / "b.npz"))
    assert InvertedIndex.load(str(tmp_path / "b.npz")).all_docs() == [
        ["x", "y"]]


@pytest.mark.cuda
def test_viterbi_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = np.random.default_rng(0)
    trans = g.random((6, 6)) + 0.1
    trans /= trans.sum(1, keepdims=True)
    em = g.random((40, 6))
    a = Viterbi(trans, device="cpu").decode(em)
    b = Viterbi(trans, device="cuda").decode(em)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == pytest.approx(b[1], abs=SCORE_ATOL)
