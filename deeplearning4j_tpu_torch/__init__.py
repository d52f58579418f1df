"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for one NVIDIA H100.

A package of its own beside the JAX package, which stays the reference: it
imports ``torch`` and never ``jax`` nor anything of ``deeplearning4j_tpu``.
It trains the transformer LM on one device, on a ``(data, model)`` mesh
(tensor, expert and sequence parallelism, FSDP) and over a data axis
across processes on ``torch.distributed`` (``models/transformer.py``,
``parallel/``, ``python -m deeplearning4j_tpu_torch train``), checkpoints
it (npz, or sharded on ``torch.distributed.checkpoint``), decodes it
(greedy, sampled, beam, speculative; bf16 and int8; from one device or
straight from the training mesh's layout) and serves it through the
continuous-batching engine and its fleet (``serving/``: paged and int8
KV, prefix cache, MoE, tensor parallelism, tenancy, LoRA, the KV wire,
the router), with attention on hand-written CUDA kernels (``ops/``,
sources in ``csrc/``): the flash forward and backward for training and
prefill, flash decode (slab and paged, bf16 and int8) for serving. It
also trains Word2Vec and ParagraphVectors (the fused embedding-dot
kernel), and the DL4J-era framework: the layers (``nn/``), the solvers
(``optimize/``), ``MultiLayerNetwork`` with LeNet, AlexNet and the DBN,
ResNet-20 with BatchNorm and the char-LSTM (``models/``), the datasets and
evaluation, and the DL4J nets' parallel modes (``parallel/``:
``DataParallelTrainer`` with batch statistics over the data axis, also
across processes, local SGD, the GPipe pipeline, the Megatron block, the
sequence-sharded LSTM; ``python -m deeplearning4j_tpu_torch train --model
lenet|alexnet``). Later slices: GloVe and the rest of the NLP models, the
tools and ``analysis/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU device they raise. CPU tensors take each
kernel's plain PyTorch version, CUDA tensors the kernel.
"""
