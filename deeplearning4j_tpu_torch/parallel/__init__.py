"""Parallel-training support of the port; this slice has the npz
checkpoints (``checkpoint``)."""
