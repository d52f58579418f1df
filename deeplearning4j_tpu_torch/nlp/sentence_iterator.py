"""Sentence and document iterators (the port's copy of
``deeplearning4j_tpu/nlp/sentence_iterator.py``). Every iterator can be
iterated again after ``reset``, which the vocabulary build and the
trainers rely on.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Iterator, Protocol

from deeplearning4j_tpu_torch.nlp.tokenization import split_sentences


class SentenceIterator(Protocol):
    def __iter__(self) -> Iterator[str]: ...
    def reset(self) -> None: ...


class CollectionSentenceIterator:
    def __init__(self, sentences: Iterable[str], preprocessor: Callable[[str], str] | None = None):
        self.sentences = list(sentences)
        self.preprocessor = preprocessor

    def __iter__(self) -> Iterator[str]:
        for s in self.sentences:
            yield self.preprocessor(s) if self.preprocessor else s

    def reset(self) -> None:
        pass


class LineSentenceIterator:
    """One sentence per non-empty line of a file."""

    def __init__(self, path: str | Path, preprocessor: Callable[[str], str] | None = None):
        self.path = Path(path)
        self.preprocessor = preprocessor

    def __iter__(self) -> Iterator[str]:
        with open(self.path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self.preprocessor(line) if self.preprocessor else line

    def reset(self) -> None:
        pass


class FileSentenceIterator:
    """Every file under a directory, sentence-split."""

    def __init__(self, root: str | Path, preprocessor: Callable[[str], str] | None = None):
        self.root = Path(root)
        self.preprocessor = preprocessor

    def __iter__(self) -> Iterator[str]:
        for f in sorted(self.root.rglob("*")):
            if f.is_file():
                text = f.read_text(encoding="utf-8", errors="replace")
                for s in split_sentences(text):
                    yield self.preprocessor(s) if self.preprocessor else s

    def reset(self) -> None:
        pass


class LabelAwareSentenceIterator:
    """(label, sentence) pairs from a directory per label
    (root/label1/..., root/label2/...)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.current_label: str | None = None

    def __iter__(self) -> Iterator[tuple[str, str]]:
        for label_dir in sorted(p for p in self.root.iterdir() if p.is_dir()):
            for f in sorted(label_dir.rglob("*")):
                if f.is_file():
                    for s in split_sentences(f.read_text(encoding="utf-8", errors="replace")):
                        self.current_label = label_dir.name
                        yield label_dir.name, s

    def reset(self) -> None:
        self.current_label = None


class DocumentIterator:
    """Whole files as documents."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def __iter__(self) -> Iterator[str]:
        for f in sorted(self.root.rglob("*")):
            if f.is_file():
                yield f.read_text(encoding="utf-8", errors="replace")

    def reset(self) -> None:
        pass
