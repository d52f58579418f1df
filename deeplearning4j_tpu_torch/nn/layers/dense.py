"""Dense (fully-connected) layer (the JAX package's ``nn/layers/dense.py``):
``pre_output = x·W + b`` in the policy's compute dtype, then the
activation, with optional dropout or DropConnect."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import activations, weights
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import BIAS_KEY, WEIGHT_KEY, Params


@api.register("dense")
class DenseLayer:
    def init(self, key, conf: LayerConfig, device=None) -> Params:
        device = resolve_device(device)
        kw, _ = rng.split(key)
        return {
            WEIGHT_KEY: weights.init_weights(
                kw, (conf.n_in, conf.n_out), conf.weight_init, conf.dist,
                device=device),
            BIAS_KEY: torch.zeros((conf.n_out,),
                                  dtype=dtypes.get_policy().param_dtype,
                                  device=device),
        }

    def pre_output(self, params: Params, conf: LayerConfig,
                   x: torch.Tensor) -> torch.Tensor:
        policy = dtypes.get_policy()
        w = policy.cast_to_compute(params[WEIGHT_KEY])
        with dtypes.precision(policy):
            return (policy.cast_to_compute(x) @ w
                    + params[BIAS_KEY].to(policy.compute_dtype))

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        if (conf.use_drop_connect and training and conf.dropout > 0
                and key is not None):
            # DropConnect: mask the weights rather than the activations
            w = params[WEIGHT_KEY]
            mask = api.dropout_mask(key, w.shape, conf.dropout, w.dtype,
                                    w.device)
            params = {**params, WEIGHT_KEY: w * mask}
        else:
            x = api.apply_dropout(x, conf, key, training)
        return activations.get(conf.activation)(
            self.pre_output(params, conf, x))

    def transpose(self, params: Params) -> Params:
        """The layer flipped for decode paths."""
        w = params[WEIGHT_KEY]
        return {WEIGHT_KEY: w.T,
                BIAS_KEY: torch.zeros((w.shape[0],), dtype=params[BIAS_KEY].dtype,
                                      device=w.device)}
