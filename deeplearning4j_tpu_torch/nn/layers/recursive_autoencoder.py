"""Recursive autoencoder over sequence prefixes (the JAX package's
``nn/layers/recursive_autoencoder.py``): folds a sequence left to right,
``h_t = f(W [x_t; h_{t-1}] + b)``, scoring the reconstruction of both
inputs at every fold; the reference's ``lax.scan`` is a Python loop."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import activations, weights
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import Params


@api.register("recursive_autoencoder")
class RecursiveAutoEncoder:
    """conf.n_in = feature dim per step (hidden dim == n_in)."""

    def init(self, key, conf: LayerConfig, device=None) -> Params:
        device = resolve_device(device)
        d = conf.n_in
        k1, k2 = rng.split(key)
        dtype = dtypes.get_policy().param_dtype
        return {
            "W": weights.init_weights(k1, (2 * d, d), conf.weight_init,
                                      conf.dist, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device),
            "Wd": weights.init_weights(k2, (d, 2 * d), conf.weight_init,
                                       conf.dist, device=device),
            "bd": torch.zeros((2 * d,), dtype=dtype, device=device),
        }

    def _fold(self, params: Params, conf: LayerConfig, x: torch.Tensor):
        """x: (B, T, d) -> (hidden states (B, T, d), recon loss scalar)."""
        act = activations.get(conf.activation)
        h = x[:, 0, :]
        hs, errs = [h], []
        with dtypes.precision():
            for t in range(1, x.shape[1]):
                cat = torch.cat([x[:, t, :], h], dim=-1)
                h = act(cat @ params["W"] + params["b"])
                recon = act(h @ params["Wd"] + params["bd"])
                errs.append(torch.mean(torch.sum((recon - cat) ** 2, dim=-1)))
                hs.append(h)
        # no fold (T 1): the mean of no errors, NaN, as the reference's
        err = torch.mean(torch.stack(errs)) if errs else x.new_tensor(float("nan"))
        return torch.stack(hs, dim=1), err

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        """Final fold state (B, d) for (B, T, d) input; a 2-D input (B, d)
        passes through (a single step folds nothing)."""
        if x.ndim == 2:
            return x
        hs, _ = self._fold(params, conf, x)
        return hs[:, -1, :]

    def score(self, params: Params, conf: LayerConfig, x: torch.Tensor, key):
        if x.ndim == 2:
            x = x[:, None, :]
        _, err = self._fold(params, conf, x)
        return err + api.l2_penalty(params, conf)

    def gradient(self, params: Params, conf: LayerConfig, x: torch.Tensor, key):
        return api.default_gradient(self, params, conf, x, key)

    def pre_output(self, params: Params, conf: LayerConfig,
                   x: torch.Tensor) -> torch.Tensor:
        return self.activate(params, conf, x)
