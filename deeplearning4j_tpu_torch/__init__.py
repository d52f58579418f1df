"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

A package of its own beside the JAX package, which stays the reference: it
imports ``torch`` and never ``jax`` nor anything of ``deeplearning4j_tpu``.
It trains the transformer LM on one device (``models/transformer.py``:
``transformer_train_step``, ``python -m deeplearning4j_tpu_torch train``)
and serves it through the continuous-batching engine (``serving/``), with
attention on hand-written CUDA kernels (``ops/``, sources in ``csrc/``):
the flash forward and backward for training and prefill, flash decode for
serving. Later slices: int8 and paged decode, training on a mesh
(``torch.distributed``), MoE, checkpointing, the rest of the serving
features and the DL4J-era framework.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU device they raise. CPU tensors take each
kernel's plain PyTorch version, CUDA tensors the kernel.
"""
