"""Evaluation: confusion matrix + classification metrics."""

from deeplearning4j_tpu_torch.evaluation.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
