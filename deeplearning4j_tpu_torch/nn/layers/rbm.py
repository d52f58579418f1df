"""Restricted Boltzmann machine with CD-k pretraining (the JAX package's
``nn/layers/rbm.py``): visible {binary, gaussian, softmax, linear} ×
hidden {binary, gaussian, softmax, rectified} units, the propUp/propDown
conditionals, NReLU sampling for rectified hidden units, and the CD-k
Gibbs chain.

The reference's ``lax.scan`` over the chain is a Python loop over the keys
``split(k_chain, k)`` here; every draw takes the reference's key, so a
sample equals the reference's wherever the mean it is drawn against does
(an ulp of difference in a sigmoid flips a draw only within an ulp of
it). CD statistics are not the gradient of a scalar, so ``gradient`` is
explicit: a descent direction for ``param -= lr * grad``, the weight
statistic averaged over the batch.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import dtypes, rng
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import losses, weights
from deeplearning4j_tpu_torch.nn.conf import HiddenUnit, LayerConfig, VisibleUnit
from deeplearning4j_tpu_torch.nn.layers import api
from deeplearning4j_tpu_torch.nn.layers.api import (
    BIAS_KEY,
    VISIBLE_BIAS_KEY,
    WEIGHT_KEY,
    Params,
)


@api.register("rbm")
class RBM:
    # -- params ------------------------------------------------------------
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

    # -- conditionals ------------------------------------------------------
    def prop_up(self, params: Params, conf: LayerConfig,
                v: torch.Tensor) -> torch.Tensor:
        """Hidden means given visible."""
        pre = self.pre_output(params, conf, v)
        h = conf.hidden_unit
        if h == HiddenUnit.RECTIFIED:
            return torch.relu(pre)
        if h == HiddenUnit.BINARY:
            return torch.sigmoid(pre)
        if h == HiddenUnit.GAUSSIAN:
            return pre
        if h == HiddenUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown hidden unit {h!r}")

    def prop_down(self, params: Params, conf: LayerConfig,
                  h: torch.Tensor) -> torch.Tensor:
        """Visible means given hidden."""
        with dtypes.precision():
            pre = h @ params[WEIGHT_KEY].T + params[VISIBLE_BIAS_KEY]
        v = conf.visible_unit
        if v == VisibleUnit.BINARY:
            return torch.sigmoid(pre)
        if v in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return pre
        if v == VisibleUnit.SOFTMAX:
            return torch.softmax(pre, dim=-1)
        raise ValueError(f"Unknown visible unit {v!r}")

    def sample_h_given_v(self, key, params: Params, conf: LayerConfig,
                         v: torch.Tensor):
        """(means, samples)."""
        mean = self.prop_up(params, conf, v)
        h = conf.hidden_unit
        if h == HiddenUnit.RECTIFIED:
            # NReLU (Nair & Hinton): max(0, mu + N(0,1)*sqrt(sigmoid(mu)))
            noise = rng.normal(key, mean.shape, device=mean.device,
                               dtype=mean.dtype, batch=True)
            sample = torch.relu(mean + noise * torch.sqrt(torch.sigmoid(mean)))
        elif h == HiddenUnit.BINARY:
            sample = rng.bernoulli(key, mean, batch=True).to(mean.dtype)
        elif h == HiddenUnit.GAUSSIAN:
            sigma = torch.std(mean, dim=-1, keepdim=True, unbiased=False) + 1e-6
            sample = mean + sigma * rng.normal(key, mean.shape,
                                               device=mean.device,
                                               dtype=mean.dtype, batch=True)
        elif h == HiddenUnit.SOFTMAX:
            sample = mean
        else:
            raise ValueError(f"Unknown hidden unit {h!r}")
        return mean, sample

    def sample_v_given_h(self, key, params: Params, conf: LayerConfig,
                         h: torch.Tensor):
        """(means, samples)."""
        mean = self.prop_down(params, conf, h)
        v = conf.visible_unit
        if v == VisibleUnit.BINARY:
            sample = rng.bernoulli(key, mean, batch=True).to(mean.dtype)
        elif v in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            sample = mean + rng.normal(key, mean.shape, device=mean.device,
                                       dtype=mean.dtype, batch=True)
        elif v == VisibleUnit.SOFTMAX:
            sample = mean
        else:
            raise ValueError(f"Unknown visible unit {v!r}")
        return mean, sample

    # -- CD-k --------------------------------------------------------------
    def gibbs_hvh(self, key, params: Params, conf: LayerConfig,
                  h: torch.Tensor):
        """One h -> v -> h step: (v_mean, v_sample, h_mean, h_sample)."""
        kv, kh = rng.split(key)
        v_mean, v_sample = self.sample_v_given_h(kv, params, conf, h)
        h_mean, h_sample = self.sample_h_given_v(kh, params, conf, v_sample)
        return v_mean, v_sample, h_mean, h_sample

    def gibbs_chain(self, key, params: Params, conf: LayerConfig,
                    x: torch.Tensor):
        """The positive phase and the k-step chain of :meth:`gradient`:
        ``(pos_h_mean, nv_mean, nv_sample, nh_mean)``."""
        k_pos, k_chain = rng.split(key)
        pos_h_mean, h_sample = self.sample_h_given_v(k_pos, params, conf, x)
        for step_key in rng.split(k_chain, conf.k):
            v_mean, v_sample, h_mean, h_sample = self.gibbs_hvh(
                step_key, params, conf, h_sample)
        return pos_h_mean, v_mean, v_sample, h_mean

    def gradient(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key):
        """(score, grads) from k steps of contrastive divergence: positive
        statistics from the data, negative ones from the end of the chain;
        the sparsity-aware hidden-bias statistic when configured."""
        with torch.no_grad(), dtypes.precision():
            pos_h_mean, nv_mean, nv_sample, nh_mean = self.gibbs_chain(
                key, params, conf, x)
            n = x.shape[0]
            w_stat = (x.T @ pos_h_mean - nv_sample.T @ nh_mean) / n
            if conf.sparsity != 0.0:
                hb_stat = torch.mean(conf.sparsity - pos_h_mean, dim=0)
            else:
                hb_stat = torch.mean(pos_h_mean - nh_mean, dim=0)
            vb_stat = torch.mean(x - nv_sample, dim=0)
            gw = -w_stat
            if conf.use_regularization:
                gw = gw + conf.l2 * params[WEIGHT_KEY]
            grads = {WEIGHT_KEY: gw, BIAS_KEY: -hb_stat,
                     VISIBLE_BIAS_KEY: -vb_stat}
            score = self.score_from_reconstruction(params, conf, x, nv_mean)
        return score, grads

    # -- scoring / activations --------------------------------------------
    def free_energy(self, params: Params, conf: LayerConfig,
                    v: torch.Tensor) -> torch.Tensor:
        """Free energy summed over the batch."""
        wx_b = self.pre_output(params, conf, v)
        v_bias_term = torch.sum(v * params[VISIBLE_BIAS_KEY])
        h_term = torch.sum(torch.logaddexp(wx_b, torch.zeros_like(wx_b)))
        return -h_term - v_bias_term

    def reconstruct(self, params: Params, conf: LayerConfig,
                    v: torch.Tensor) -> torch.Tensor:
        """propDown(propUp(v))."""
        return self.prop_down(params, conf, self.prop_up(params, conf, v))

    def score_from_reconstruction(self, params, conf, x, recon):
        if conf.visible_unit in (VisibleUnit.GAUSSIAN, VisibleUnit.LINEAR):
            return losses.get("MSE")(x, recon)
        return losses.get("RECONSTRUCTION_CROSSENTROPY")(x, recon)

    def score(self, params: Params, conf: LayerConfig, x: torch.Tensor, key):
        """Reconstruction score (+ L2)."""
        return self.score_from_reconstruction(
            params, conf, x, self.reconstruct(params, conf, x)
        ) + api.l2_penalty(params, conf)

    def activate(self, params: Params, conf: LayerConfig, x: torch.Tensor,
                 key=None, training: bool = False) -> torch.Tensor:
        """Hidden means: the forward pass when stacked in a DBN."""
        x = api.apply_dropout(x, conf, key, training)
        return self.prop_up(params, conf, x)

    def pre_output(self, params: Params, conf: LayerConfig,
                   x: torch.Tensor) -> torch.Tensor:
        with dtypes.precision():
            return x @ params[WEIGHT_KEY] + params[BIAS_KEY]
