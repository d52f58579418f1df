"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

A package of its own beside the JAX package, which stays the reference: it
imports ``torch`` and never ``jax`` nor anything of ``deeplearning4j_tpu``.
This slice serves the transformer LM (``models/transformer.py``) through
the continuous-batching engine (``serving/``), with prefill and decode
attention on hand-written CUDA kernels (``ops/``, sources in ``csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU device they raise. CPU tensors take each
kernel's plain PyTorch version, CUDA tensors the kernel.
"""
