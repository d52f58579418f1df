"""MultiLayerNetwork, the orchestrator (the JAX package's
``models/multilayer.py``): layer construction, greedy layer-wise
pretraining, feed-forward, finetuning (the output layer alone, or the whole
stack by backprop or Hessian-free), predict/output, the packed parameter
vector, replica merge, reconstruction and serde.

The network is a host-side orchestrator over pure functions: the params
are a list of per-layer dicts of tensors on the network's device (``cuda``
unless the caller names another), every compute path runs eagerly, and
gradients are autodiff (``nn.layers.api.value_and_grad``; Hessian-free
takes ``torch.func`` jvp/vjp through the forward/loss split). Inference
(``output``, ``reconstruct``, ``score``) and every solve run inside
``dtypes.precision()``, TF32 as the policy says.

Layout: conv blocks are NCHW with OIHW kernels where the reference runs
NHWC over HWIO. A flat 784-wide row enters a conv layer as the reference
reads it, ``(B, 28, 28, 1)`` in H, W, C order, made NCHW; a conv block
leaves for a dense layer flattened in the reference's H, W, C order, so a
dense layer's weights mean the same in both packages.
:func:`params_from_jax` and :func:`params_to_jax` carry the params across
(HWIO <-> OIHW), and the packed vector, ``to_bytes`` and the checkpoints
hold the reference's layout, so they interchange with the JAX package.
"""

from __future__ import annotations

import io
import logging
import math
from typing import Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch import rng as rng_mod
from deeplearning4j_tpu_torch.datasets.base import DataSet
from deeplearning4j_tpu_torch.device import resolve_device, upload
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfig, OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.layers.api import CONV_WEIGHTS, value_and_grad
from deeplearning4j_tpu_torch.nn.layers.convolution import hwio_to_oihw, oihw_to_hwio
from deeplearning4j_tpu_torch.obs.trace import Tracer
from deeplearning4j_tpu_torch.optimize import Solver, updaters
from deeplearning4j_tpu_torch.optimize.api import IterationListener, ModelFunctions
from deeplearning4j_tpu_torch.utils import tree_math as tm

log = logging.getLogger(__name__)

#: tracer track for the training orchestrator's phase spans
TRAIN_TRACK = "train"

Params = list[dict[str, torch.Tensor]]

PRETRAINABLE = {"rbm", "autoencoder"}


def _adapt_input(x: torch.Tensor, layer_type: str, channels: int) -> torch.Tensor:
    """Reshape between flat 2-D batches and NCHW conv blocks, in the
    reference's element order (a flat row is H, W, C; a block flattens as
    H, W, C)."""
    if layer_type == "conv_downsample" and x.ndim == 2:
        c = max(channels, 1)
        side = int(math.isqrt(x.shape[1] // c))
        return x.reshape(x.shape[0], side, side, c).permute(0, 3, 1, 2)
    if layer_type in ("dense", "output", "rbm", "autoencoder") and x.ndim > 2:
        if x.ndim == 4:  # NCHW conv block -> the reference's NHWC order
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)
    return x


def _map_conv(params, conf: MultiLayerConfig, fn):
    return [{k: fn(v) if c.layer_type == "conv_downsample" and k == CONV_WEIGHTS
             else v for k, v in layer.items()}
            for c, layer in zip(conf.confs, params)]


def params_from_jax(params, conf: MultiLayerConfig, device=None) -> Params:
    """The JAX package's ``MultiLayerNetwork`` params (a list of dicts of
    arrays, e.g. numpy) as the port's: copies on ``device`` (the card unless
    the caller names another), conv kernels HWIO -> OIHW."""
    dev = resolve_device(device)
    tensors = [{k: torch.tensor(np.asarray(v), device=dev)
                for k, v in layer.items()} for layer in params]
    return _map_conv(tensors, conf, hwio_to_oihw)


def reference_layout(params: Params, conf: MultiLayerConfig) -> Params:
    """The port's params in the reference's layout (conv kernels HWIO), as
    tensors where they are."""
    return _map_conv(params, conf, oihw_to_hwio)


def params_to_jax(params: Params, conf: MultiLayerConfig) -> list[dict]:
    """The inverse of :func:`params_from_jax`: host numpy arrays in the
    reference's layout."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in reference_layout(params, conf)]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfig, params: Params | None = None,
                 seed: int = 123, tracer: Tracer | None = None, device=None):
        self.device = resolve_device(device)
        self.conf = conf
        self.modules = [L.get(c.layer_type) for c in conf.confs]
        self.keys = rng_mod.KeyStream(seed)
        self.params: Params | None = params
        self.listeners: list[IterationListener] = []
        # disabled-by-default tracer: fit/pretrain/finetune record phase
        # spans on the "train" track when one is wired in
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)

    # -- construction ------------------------------------------------------
    def init(self, key=None) -> Params:
        """Every layer's params from ``key`` (the next of the network's
        key stream by default), the reference's draws."""
        key = key if key is not None else self.keys.next()
        subkeys = rng_mod.split(key, len(self.modules))
        self.params = [mod.init(k, c, device=self.device)
                       for mod, c, k in zip(self.modules, self.conf.confs, subkeys)]
        return self.params

    def _require_params(self) -> Params:
        if self.params is None:
            self.init()
        return self.params

    def _tensor(self, x) -> torch.Tensor:
        """A host batch on the network's device (pinned and without
        blocking on the card), or a tensor moved there."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return upload(np.ascontiguousarray(x, np.float32), self.device)

    # -- forward -----------------------------------------------------------
    def feed_forward_fn(self, params: Params, x: torch.Tensor,
                        upto: int | None = None, key=None,
                        training: bool = False) -> list[torch.Tensor]:
        """Pure feed-forward returning all activations."""
        acts = [x]
        n = len(self.modules) if upto is None else upto
        subkeys = rng_mod.split(key, n) if key is not None else [None] * n
        for i in range(n):
            c = self.conf.confs[i]
            h = acts[-1]
            if i in self.conf.preprocessors:
                h = pp.get(self.conf.preprocessors[i])(
                    h, subkeys[i] if training else None)
            h = _adapt_input(
                h, c.layer_type,
                c.n_in if c.layer_type == "conv_downsample" else 0)
            acts.append(self.modules[i].activate(params[i], c, h,
                                                 key=subkeys[i],
                                                 training=training))
        return acts

    def activation_upto(self, params: Params, x: torch.Tensor,
                        layer_idx: int) -> torch.Tensor:
        """Input to layer ``layer_idx``."""
        acts = self.feed_forward_fn(params, x, upto=layer_idx)
        c = self.conf.confs[layer_idx]
        return _adapt_input(acts[-1], c.layer_type, 0)

    def output(self, x, params: Params | None = None) -> torch.Tensor:
        """Class probabilities."""
        params = params if params is not None else self._require_params()
        with torch.no_grad(), dtypes.precision():
            return self.feed_forward_fn(params, self._tensor(x))[-1]

    def predict(self, x, params: Params | None = None) -> np.ndarray:
        return torch.argmax(self.output(x, params), dim=-1).cpu().numpy()

    def reconstruct(self, x, layer_idx: int | None = None) -> torch.Tensor:
        """Decode back from the given layer."""
        params = self._require_params()
        n = layer_idx if layer_idx is not None else len(self.modules) - 1
        with torch.no_grad(), dtypes.precision():
            h = self.feed_forward_fn(params, self._tensor(x), upto=n)[-1]
            for i in reversed(range(n)):
                mod, c = self.modules[i], self.conf.confs[i]
                if hasattr(mod, "prop_down"):
                    h = mod.prop_down(params[i], c, h)
                elif hasattr(mod, "decode"):
                    h = mod.decode(params[i], c, h)
                else:
                    h = torch.sigmoid(h @ params[i][L.api.WEIGHT_KEY].T)
        return h

    # -- scoring -----------------------------------------------------------
    def supervised_score_fn(self, params: Params, x, labels, key=None,
                            training: bool = False) -> torch.Tensor:
        """Full-network loss: forward to the last layer's supervised score."""
        acts = self.feed_forward_fn(params, x, upto=len(self.modules) - 1,
                                    key=key, training=training)
        c = self.conf.confs[-1]
        h = _adapt_input(acts[-1], c.layer_type, 0)
        return self.modules[-1].supervised_score(params[-1], c, h, labels,
                                                 key=key, training=training)

    def score(self, dataset: DataSet) -> float:
        params = self._require_params()
        with torch.no_grad(), dtypes.precision():
            return float(self.supervised_score_fn(
                params, self._tensor(dataset.features),
                self._tensor(dataset.labels)))

    # -- training ----------------------------------------------------------
    def pretrain(self, iterator) -> None:
        """Greedy layer-wise pretraining: for each pretrainable layer, stream
        the batches through the stack below it and fit the layer on each."""
        params = self._require_params()
        for i, (mod, c) in enumerate(zip(self.modules, self.conf.confs)):
            if c.layer_type not in PRETRAINABLE:
                continue
            log.info("pretraining layer %d (%s)", i, c.layer_type)
            iterator.reset()
            with self.tracer.region(TRAIN_TRACK, "pretrain_layer", layer=i,
                                    type=c.layer_type):
                for n_batch, batch in enumerate(iterator):
                    with self.tracer.region(TRAIN_TRACK, "pretrain_batch",
                                            layer=i, batch=n_batch):
                        with torch.no_grad():
                            layer_input = self.activation_upto(
                                params, self._tensor(batch.features), i)
                        if c.layer_type == "rbm":
                            # CD-k statistics are not the gradient of a
                            # scalar: an adagrad-adjusted iterated update
                            params[i] = self._pretrain_cdk(mod, c, params[i],
                                                           layer_input)
                        else:
                            params[i] = self._pretrain_solver(mod, c, params[i],
                                                              layer_input)

    def _pretrain_solver(self, mod, c, layer_params, x):
        """The layer's configured solver on its unsupervised score."""
        model = ModelFunctions(
            score_and_grad=lambda p, k: mod.gradient(p, c, x, k),
            score=lambda p, k: mod.score(p, c, x, k))
        solver = Solver(c, model, listeners=self.listeners)
        return solver.optimize(layer_params, self.keys.next())[0]

    def _pretrain_cdk(self, mod, c, layer_params, x):
        """``c.num_iterations`` CD-k updates on one batch, one key each from
        ``split(next key, num_iterations)``; no host sync."""
        p, ust = layer_params, updaters.init(layer_params)
        for k in rng_mod.split(self.keys.next(), c.num_iterations):
            _, grads = mod.gradient(p, c, x, k)
            step, ust = updaters.adjust(c, ust, grads, p)
            p = tm.sub(p, step)
        return p

    def finetune(self, iterator) -> None:
        """Fit the output layer on top of frozen features or, when
        ``backward`` or HESSIAN_FREE is configured, the whole stack by
        backprop."""
        params = self._require_params()
        out_conf = self.conf.confs[-1]
        full_backprop = (
            self.conf.backward
            or out_conf.optimization_algo == OptimizationAlgorithm.HESSIAN_FREE)
        iterator.reset()
        for n_batch, batch in enumerate(iterator):
            with self.tracer.region(TRAIN_TRACK, "finetune_batch",
                                    batch=n_batch,
                                    full_backprop=full_backprop):
                x = self._tensor(batch.features)
                y = self._tensor(batch.labels)
                if full_backprop:
                    solver = Solver(out_conf, self._full_model_fns(x, y),
                                    listeners=self.listeners)
                    new_params, _ = solver.optimize(params, self.keys.next())
                    params[:] = new_params
                else:
                    with torch.no_grad():
                        h = self.activation_upto(params, x,
                                                 len(self.modules) - 1)
                    mod = self.modules[-1]
                    model = ModelFunctions(
                        score_and_grad=lambda p, k, h=h, y=y: value_and_grad(
                            lambda q: mod.supervised_score(
                                q, out_conf, h, y, k, training=True))(p),
                        score=lambda p, k, h=h, y=y: mod.supervised_score(
                            p, out_conf, h, y, k),
                    )
                    solver = Solver(out_conf, model, listeners=self.listeners)
                    params[-1], _ = solver.optimize(params[-1],
                                                    self.keys.next())

    def _full_model_fns(self, x, y) -> ModelFunctions:
        """Whole-network ModelFunctions, with the forward/loss split
        Hessian-free takes."""
        c = self.conf.confs[-1]

        def score(p, key=None):
            return self.supervised_score_fn(p, x, y)

        def forward(p):
            acts = self.feed_forward_fn(p, x, upto=len(self.modules) - 1)
            h = _adapt_input(acts[-1], c.layer_type, 0)
            return self.modules[-1].pre_output(p[-1], c, h)

        def loss_on_outputs(logits):
            try:
                return loss_mod.logits_loss(c.loss, y, logits)
            except ValueError:
                return loss_mod.get(c.loss)(y, activations.get(c.activation)(logits))

        return ModelFunctions.from_score(score, forward=forward,
                                         loss_on_outputs=loss_on_outputs)

    def fit(self, iterator) -> None:
        """Pretrain (if configured), then finetune."""
        with self.tracer.region(TRAIN_TRACK, "fit"):
            if self.conf.pretrain:
                with self.tracer.region(TRAIN_TRACK, "pretrain"):
                    self.pretrain(iterator)
            iterator.reset()
            with self.tracer.region(TRAIN_TRACK, "finetune"):
                self.finetune(iterator)

    def fit_dataset(self, dataset: DataSet, batch_size: int | None = None) -> None:
        from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

        self.fit(ListDataSetIterator(dataset, batch_size or dataset.num_examples()))

    # -- parameter plumbing ------------------------------------------------
    def params_vector(self) -> np.ndarray:
        """All params packed into one vector in the reference's order and
        layout."""
        flat, _ = tm.ravel(reference_layout(self._require_params(), self.conf))
        return flat.detach().cpu().numpy()

    def set_params_vector(self, vec: np.ndarray) -> None:
        _, unravel = tm.ravel(reference_layout(self._require_params(), self.conf))
        tree = unravel(torch.tensor(np.asarray(vec)))
        self.params = _map_conv(tree, self.conf, hwio_to_oihw)

    def merge(self, others: Sequence["MultiLayerNetwork"]) -> None:
        """Parameter averaging across replicas."""
        all_params = [self._require_params()] + [o._require_params() for o in others]
        n = len(all_params)
        self.params = tm.tree_map(lambda *xs: sum(xs) / n, *all_params)

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(self.conf, device=self.device)
        if self.params is not None:
            net.params = tm.tree_map(torch.clone, self.params)
        return net

    def set_listeners(self, listeners: Sequence[IterationListener]) -> None:
        self.listeners = list(listeners)

    # -- serde: the packed vector (reference layout) and the config JSON ---
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, params=self.params_vector(), conf=self.conf.to_json())
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "MultiLayerNetwork":
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            conf = MultiLayerConfig.from_json(str(z["conf"]))
            net = cls(conf, device=device)
            net.init()
            net.set_params_vector(z["params"])
        return net

    # -- npz checkpoints (``parallel/checkpoint.py``), the reference's keys --
    def checkpoint_tree(self, params: Params | None = None) -> dict:
        """The params as the reference's checkpoint sees them: ``{"0":
        {...}, "1": {...}}`` in its layout, so the npz keys are its
        ``0//W``, ``1//convweights``, ..."""
        params = params if params is not None else self._require_params()
        return {str(i): layer for i, layer in
                enumerate(reference_layout(params, self.conf))}

    def from_checkpoint_tree(self, tree: dict) -> Params:
        """The inverse of :meth:`checkpoint_tree`."""
        return _map_conv([tree[str(i)] for i in range(len(tree))], self.conf,
                         hwio_to_oihw)
