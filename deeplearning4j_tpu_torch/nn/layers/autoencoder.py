"""Denoising autoencoder with tied weights (the JAX package's
``nn/layers/autoencoder.py``): ``encode``, ``decode`` through the
transposed weights, binomial input corruption at ``corruption_level`` (the
reference's draw from the same key) and a reconstruction objective whose
gradient is autodiff."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import activations, losses, weights
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import (
    BIAS_KEY,
    VISIBLE_BIAS_KEY,
    WEIGHT_KEY,
    Params,
)


@api.register("autoencoder")
class AutoEncoder:
    def init(self, key, conf: LayerConfig, device=None) -> Params:
        device = resolve_device(device)
        kw, _ = rng.split(key)
        dtype = dtypes.get_policy().param_dtype
        return {
            WEIGHT_KEY: weights.init_weights(
                kw, (conf.n_in, conf.n_out), conf.weight_init, conf.dist,
                device=device),
            BIAS_KEY: torch.zeros((conf.n_out,), dtype=dtype, device=device),
            VISIBLE_BIAS_KEY: torch.zeros((conf.n_in,), dtype=dtype,
                                          device=device),
        }

    def encode(self, params: Params, conf: LayerConfig,
               x: torch.Tensor) -> torch.Tensor:
        return activations.get(conf.activation)(
            self.pre_output(params, conf, x))

    def decode(self, params: Params, conf: LayerConfig,
               h: torch.Tensor) -> torch.Tensor:
        with dtypes.precision():
            pre = h @ params[WEIGHT_KEY].T + params[VISIBLE_BIAS_KEY]
        return activations.get(conf.activation)(pre)

    def corrupt(self, key, conf: LayerConfig, x: torch.Tensor) -> torch.Tensor:
        """Binomial masking noise at corruption_level (denoising AE)."""
        if conf.corruption_level <= 0.0:
            return x
        keep = rng.bernoulli(key, 1.0 - conf.corruption_level, x.shape,
                             device=x.device, batch=True)
        return x * keep.to(x.dtype)

    def reconstruct(self, params: Params, conf: LayerConfig,
                    x: torch.Tensor) -> torch.Tensor:
        return self.decode(params, conf, self.encode(params, conf, x))

    def score(self, params: Params, conf: LayerConfig, x: torch.Tensor, key):
        recon = self.reconstruct(params, conf, self.corrupt(key, conf, x))
        if conf.activation in ("sigmoid", "softmax"):
            loss = losses.get("RECONSTRUCTION_CROSSENTROPY")(x, recon)
        else:
            loss = losses.get("MSE")(x, recon)
        return loss + api.l2_penalty(params, conf)

    def gradient(self, params: Params, conf: LayerConfig, x: torch.Tensor, key):
        return api.default_gradient(self, params, conf, x, key)

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        x = api.apply_dropout(x, conf, key, training)
        return self.encode(params, conf, x)

    def pre_output(self, params: Params, conf: LayerConfig,
                   x: torch.Tensor) -> torch.Tensor:
        with dtypes.precision():
            return x @ params[WEIGHT_KEY] + params[BIAS_KEY]
