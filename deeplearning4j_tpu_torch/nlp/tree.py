"""Constituency trees: structure, PTB parsing, binarization
(the port's copy of ``deeplearning4j_tpu/nlp/tree.py``).

≙ reference models/featuredetectors/autoencoder/recursive/Tree.java:468 +
text/corpora/treeparser (TreeParser, BinarizeTreeTransformer.java:133,
CollapseUnaries).  The reference parses raw text through UIMA/OpenNLP
models; without external models this module reads PTB-style bracketed
trees directly and provides a right-branching fallback parser so every
downstream consumer (RNTN, recursive AE) works offline.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Tree:
    label: str = ""
    children: list["Tree"] = field(default_factory=list)
    word: str | None = None
    # filled by models
    vector: object = None
    prediction: object = None
    gold_label: int | None = None

    def is_leaf(self) -> bool:
        return not self.children

    def is_preterminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def leaves(self) -> list["Tree"]:
        if self.is_leaf():
            return [self]
        return [leaf for c in self.children for leaf in c.leaves()]

    def words(self) -> list[str]:
        return [leaf.word for leaf in self.leaves() if leaf.word is not None]

    def subtrees(self) -> list["Tree"]:
        out = [self]
        for c in self.children:
            out.extend(c.subtrees())
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def __str__(self) -> str:
        if self.is_leaf():
            if self.word is not None and self.label:
                return f"({self.label} {self.word})"
            return self.word or self.label
        inner = " ".join(str(c) for c in self.children)
        return f"({self.label} {inner})"


def parse_ptb(s: str) -> Tree:
    """Parse a PTB bracketed string, e.g. ``(3 (2 a) (1 (0 b) (2 c)))``."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        assert tokens[pos] == "(", f"expected ( at {pos}"
        pos += 1
        node = Tree(label=tokens[pos])
        pos += 1
        if tokens[pos] == "(":
            while tokens[pos] == "(":
                node.children.append(parse())
        else:
            node.word = tokens[pos]
            pos += 1
        assert tokens[pos] == ")", f"expected ) at {pos}"
        pos += 1
        return node

    tree = parse()
    return tree


def right_branching_tree(tokens: list[str], label: str = "0") -> Tree:
    """Fallback 'parser': right-branching binary tree over tokens
    (fills the TreeParser role when no grammar model is available)."""
    leaves = [Tree(label=label, word=t) for t in tokens]
    if not leaves:
        return Tree(label=label)
    node = leaves[-1]
    for leaf in reversed(leaves[:-1]):
        node = Tree(label=label, children=[leaf, node])
    return node


def binarize(tree: Tree) -> Tree:
    """Left-factored binarization (≙ BinarizeTreeTransformer.java:133)."""
    if tree.is_leaf():
        return tree
    children = [binarize(c) for c in tree.children]
    while len(children) > 2:
        merged = Tree(label=f"@{tree.label}", children=children[:2])
        children = [merged] + children[2:]
    return Tree(label=tree.label, children=children, word=tree.word)


def collapse_unaries(tree: Tree) -> Tree:
    """≙ CollapseUnaries: squeeze single-child chains (keep preterminals)."""
    if tree.is_leaf() or tree.is_preterminal():
        return tree
    if len(tree.children) == 1:
        return collapse_unaries(tree.children[0])
    return Tree(
        label=tree.label,
        children=[collapse_unaries(c) for c in tree.children],
        word=tree.word,
    )


class TreeVectorizer:
    """Sentences -> binarized trees (≙ TreeVectorizer over TreeParser).

    Raw text goes through the PCFG-CKY parser
    (:mod:`deeplearning4j_tpu_torch.nlp.parser`, ≙ TreeParser's OpenNLP
    constituency model); sentences outside the grammar fall back to the
    right-branching tree so every sentence still yields a binary tree.
    Pass ``parser=None, use_pcfg=False`` to force the fallback.
    """

    def __init__(self, tokenizer=None, parser=None, use_pcfg: bool = True):
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer

        self.tokenizer = tokenizer or DefaultTokenizer()
        if parser is None and use_pcfg:
            from deeplearning4j_tpu_torch.nlp.parser import default_parser

            parser = default_parser()
        self.parser = parser

    def trees(self, text: str) -> list[Tree]:
        from deeplearning4j_tpu_torch.nlp.tokenization import split_sentences

        out = []
        for sent in split_sentences(text):
            toks = self.tokenizer.tokens(sent)
            if not toks:
                continue
            tree = self.parser.parse(toks) if self.parser else None
            if tree is None:
                tree = binarize(right_branching_tree(toks))
            out.append(tree)
        return out
