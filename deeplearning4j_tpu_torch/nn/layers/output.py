"""Output / classifier layer (the JAX package's ``nn/layers/output.py``): a
dense layer scored by one of the losses; the softmax/MCXENT and
sigmoid/XENT pairs run in the fused-logits form, and the loss reduces in
the policy's accumulation dtype."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import Params
from deeplearning4j_tpu_torch.nn.layers.dense import DenseLayer

_FUSED = {
    ("softmax", "MCXENT"),
    ("softmax", "NEGATIVELOGLIKELIHOOD"),
    ("sigmoid", "XENT"),
    ("sigmoid", "RECONSTRUCTION_CROSSENTROPY"),
}


@api.register("output")
class OutputLayer(DenseLayer):
    def output(self, params: Params, conf: LayerConfig,
               x: torch.Tensor) -> torch.Tensor:
        """Probabilities/activations for input x."""
        return activations.get(conf.activation)(self.pre_output(params, conf, x))

    def supervised_score(self, params: Params, conf: LayerConfig,
                         x: torch.Tensor, labels: torch.Tensor, key=None,
                         training: bool = False) -> torch.Tensor:
        """Mean loss + L2."""
        x = api.apply_dropout(x, conf, key, training)
        logits = self.pre_output(params, conf, x)
        # products may run in bf16; softmax, log and the loss's sums run in
        # the accumulation dtype
        logits = logits.to(dtypes.get_policy().accum_dtype)
        if (conf.activation, conf.loss.upper()) in _FUSED:
            loss = losses.logits_loss(conf.loss, labels, logits)
        else:
            loss = losses.get(conf.loss)(
                labels, activations.get(conf.activation)(logits))
        return loss + api.l2_penalty(params, conf)

    def supervised_gradient(self, params: Params, conf: LayerConfig,
                            x: torch.Tensor, labels: torch.Tensor, key=None):
        return api.value_and_grad(
            lambda p: self.supervised_score(p, conf, x, labels, key,
                                            training=True))(params)

    def predict(self, params: Params, conf: LayerConfig,
                x: torch.Tensor) -> torch.Tensor:
        """Argmax class prediction."""
        return torch.argmax(self.output(params, conf, x), dim=-1)
