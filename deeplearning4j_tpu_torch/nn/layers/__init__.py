"""Layer registry of the port (the JAX package's ``nn/layers``): layers are
modules of pure functions over dicts of tensors, looked up by the
``layer_type`` string of ``LayerConfig``."""

from deeplearning4j_tpu_torch.nn.layers import api as api  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.api import get, names, register  # noqa: F401

# the layer modules register themselves on import
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    autoencoder,
    convolution,
    dense,
    lstm,
    output,
    rbm,
    recursive_autoencoder,
)
