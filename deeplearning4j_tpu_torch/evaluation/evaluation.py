"""Classification evaluation (the port's copy of the JAX package's
``evaluation/evaluation.py``).

≙ reference eval/Evaluation.java:13-530 + eval/ConfusionMatrix.java:
multiclass confusion matrix, accuracy, per-class and micro-averaged
precision/recall/F1, and the text ``stats()`` report.
"""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    """Counts[actual][predicted] (≙ eval/ConfusionMatrix.java)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.counts = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.counts[actual, predicted] += count

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray) -> None:
        np.add.at(self.counts, (actual, predicted), 1)

    def actual_total(self, cls: int) -> int:
        return int(self.counts[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.counts[:, cls].sum())

    def count(self, actual: int, predicted: int) -> int:
        return int(self.counts[actual, predicted])

    def total(self) -> int:
        return int(self.counts.sum())


class Evaluation:
    """Accumulating evaluator (≙ Evaluation.eval:30, f1:203, stats:81)."""

    def __init__(self, num_classes: int | None = None):
        self.num_classes = num_classes
        self.confusion: ConfusionMatrix | None = (
            ConfusionMatrix(num_classes) if num_classes else None
        )

    def eval(self, labels, predictions) -> None:
        """labels: one-hot (N,C) or int (N,); predictions: probabilities
        (N,C) or int class ids (N,)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        actual = labels.argmax(-1) if labels.ndim == 2 else labels.astype(np.int64)
        guess = (
            predictions.argmax(-1) if predictions.ndim == 2 else predictions.astype(np.int64)
        )
        if self.confusion is None:
            k = int(max(actual.max(), guess.max())) + 1
            self.num_classes = k
            self.confusion = ConfusionMatrix(k)
        self.confusion.add_batch(actual, guess)

    # -- metrics -----------------------------------------------------------
    def _tp(self, c: int) -> int:
        return self.confusion.count(c, c)

    def accuracy(self) -> float:
        m = self.confusion
        return float(np.trace(m.counts)) / max(m.total(), 1)

    def precision(self, cls: int | None = None) -> float:
        if cls is not None:
            denominator = self.confusion.predicted_total(cls)
            return self._tp(cls) / denominator if denominator else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)]
        return float(np.mean(vals))

    def recall(self, cls: int | None = None) -> float:
        if cls is not None:
            denominator = self.confusion.actual_total(cls)
            return self._tp(cls) / denominator if denominator else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)]
        return float(np.mean(vals))

    def f1(self, cls: int | None = None) -> float:
        """≙ Evaluation.f1:203 — harmonic mean of precision/recall."""
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self._tp(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self._tp(cls)

    def stats(self) -> str:
        """Text report (≙ Evaluation.stats:81).

        Like the reference, enumerates every non-zero confusion cell
        ("Actual Class i was predicted with Predicted j with count n
        times"), then adds the per-class table the raw counts imply
        (precision/recall/F1 with tp/fp/fn and support per class — the
        math ``precision(cls)``/``recall(cls)``/``f1(cls)`` already
        expose) before the aggregate scores."""
        m = self.confusion
        lines = [""]
        # vectorized over the counts matrix (a Python m.count() loop is
        # O(C^2) calls, ~1s at C=2000) and capped: stats() is built as
        # assert messages, so a dense large-C matrix must not explode
        # into millions of report lines — keep the top cells by count
        cells = np.argwhere(m.counts)
        max_cells = 1000
        if len(cells) > max_cells:
            vals = m.counts[cells[:, 0], cells[:, 1]]
            cells = cells[np.argsort(-vals)[:max_cells]]
            cells = cells[np.lexsort((cells[:, 1], cells[:, 0]))]
            lines.append(
                f"(showing the {max_cells} largest of "
                f"{int(np.count_nonzero(m.counts))} non-zero cells)"
            )
        for a, p in cells:
            lines.append(
                f"Actual Class {a} was predicted with Predicted "
                f"{p} with count {m.counts[a, p]} times"
            )
        lines.append("")
        lines.append("=========================Per-class========================")
        lines.append(
            " class    tp    fp    fn  support  precision  recall      f1"
        )
        tp = np.diag(m.counts)
        support = m.counts.sum(axis=1)
        fp = m.counts.sum(axis=0) - tp
        fn = support - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
            rec = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
            f1 = np.where(
                prec + rec > 0,
                2 * prec * rec / np.maximum(prec + rec, 1e-30),
                0.0,
            )
        # same cap rationale as the cell enumeration: at huge C, keep
        # the table to the highest-support classes
        class_ids = range(self.num_classes)
        if self.num_classes > max_cells:
            keep = np.argsort(-support)[:max_cells]
            class_ids = np.sort(keep)
            lines.append(
                f"(showing the {max_cells} highest-support of "
                f"{self.num_classes} classes)"
            )
        for c in class_ids:
            lines.append(
                f" {c:>5} {tp[c]:>5} {fp[c]:>5} {fn[c]:>5} "
                f"{support[c]:>8} "
                f"{prec[c]:>10.4f} {rec[c]:>7.4f} {f1[c]:>7.4f}"
            )
        lines.append("==========================Scores==========================")
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("===========================================================")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(m.counts))
        return "\n".join(lines)
