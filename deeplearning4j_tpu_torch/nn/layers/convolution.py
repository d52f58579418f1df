"""Convolution + downsample (max-pool) layer (the JAX package's
``nn/layers/convolution.py``): conv2d (VALID, stride 1) + bias +
activation + max-pool with window = stride.

Layout: PyTorch's. Activations are NCHW and the weights OIHW, where the
reference runs NHWC activations over HWIO kernels; ``init`` draws the
reference's HWIO weights from the key and transposes them, so the same key
gives the same kernel. The products are ``F.conv2d`` and ``F.max_pool2d``
(the reference computes them in XLA, outside any Pallas kernel), inside
``dtypes.precision()``: cuDNN would otherwise run an f32 conv in TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import activations, weights
from deeplearning4j_tpu_torch.nn.conf import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import CONV_BIAS, CONV_WEIGHTS, Params


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


@api.register("conv_downsample")
class ConvolutionDownSampleLayer:
    """Takes NCHW input ``(batch, channels, height, width)``.

    config fields used: ``filter_size`` (kh, kw), ``num_feature_maps``
    (output channels), ``stride`` (pool window = pool stride), ``n_in``
    (input channels).
    """

    def init(self, key, conf: LayerConfig, device=None) -> Params:
        device = resolve_device(device)
        kh, kw = conf.filter_size
        c_in = max(conf.n_in, 1)
        c_out = conf.num_feature_maps
        kw_key, _ = rng.split(key)
        fan_in = kh * kw * c_in
        fan_out = kh * kw * c_out
        w = weights.init_weights(kw_key, (fan_in, fan_out), conf.weight_init,
                                 device=device)
        w = w[:, :c_out].reshape(kh, kw, c_in, c_out)
        return {
            CONV_WEIGHTS: hwio_to_oihw(w),
            CONV_BIAS: torch.zeros((c_out,),
                                   dtype=dtypes.get_policy().param_dtype,
                                   device=device),
        }

    def conv(self, params: Params, conf: LayerConfig,
             x: torch.Tensor) -> torch.Tensor:
        policy = dtypes.get_policy()
        w = policy.cast_to_compute(params[CONV_WEIGHTS])
        with dtypes.precision(policy):
            out = F.conv2d(policy.cast_to_compute(x), w)
        return out + params[CONV_BIAS].to(out.dtype)[:, None, None]

    def pool(self, conf: LayerConfig, x: torch.Tensor) -> torch.Tensor:
        ph, pw = conf.stride
        return F.max_pool2d(x, (ph, pw), (ph, pw))

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        # the reference masks its NHWC block: the mask drawn over H, W, C
        x = api.apply_dropout(x.permute(0, 2, 3, 1), conf, key,
                              training).permute(0, 3, 1, 2)
        h = activations.get(conf.activation)(self.conv(params, conf, x))
        return self.pool(conf, h)

    def pre_output(self, params: Params, conf: LayerConfig,
                   x: torch.Tensor) -> torch.Tensor:
        return self.conv(params, conf, x)

    def output_shape(self, conf: LayerConfig, input_shape) -> tuple[int, ...]:
        """NCHW output shape for an NCHW input shape."""
        n, _, h, w = input_shape
        kh, kw = conf.filter_size
        ph, pw = conf.stride
        return (n, conf.num_feature_maps, (h - kh + 1) // ph, (w - kw + 1) // pw)
