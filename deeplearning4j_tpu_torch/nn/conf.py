"""Network configuration: the port's copy of the JAX package's
``nn/conf.py``, so both packages read and write the same JSON.

Dataclass re-design of the reference's config pair:

- ``LayerConfig`` ≙ ``NeuralNetConfiguration`` (per-layer hyperparameters,
  reference: nn/conf/NeuralNetConfiguration.java:36-101) — but instead of a
  reflective ``LayerFactory`` class pointer it carries a ``layer_type``
  string resolved against the layer registry.
- ``MultiLayerConfig`` ≙ ``MultiLayerConfiguration``
  (reference: nn/conf/MultiLayerConfiguration.java:13).

JSON round-trip replaces the reference's Jackson serializer zoo
(nn/conf/serializers/, deserializers/): every field here is a plain JSON
value (activations/losses/weight-init/optimizers are referenced by string
name), so ``to_json``/``from_json`` are direct.  The JSON form is also the
wire format shipped to remote workers, exactly as the reference ships
``conf.toJson()`` to Spark executors (SparkDl4jMultiLayer.java:142).

The ``list_builder``/per-layer-override ergonomics mirror
``NeuralNetConfiguration.ListBuilder``/``ConfOverride``
(NeuralNetConfiguration.java:767-828).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


class OptimizationAlgorithm:
    """String constants ≙ reference nn/api/OptimizationAlgorithm.java."""

    GRADIENT_DESCENT = "gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    HESSIAN_FREE = "hessian_free"
    LBFGS = "lbfgs"
    ITERATION_GRADIENT_DESCENT = "iteration_gradient_descent"

    ALL = (
        GRADIENT_DESCENT,
        CONJUGATE_GRADIENT,
        HESSIAN_FREE,
        LBFGS,
        ITERATION_GRADIENT_DESCENT,
    )


class VisibleUnit:
    """RBM visible unit types (reference: models/featuredetectors/rbm/RBM.java:67)."""

    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    LINEAR = "linear"


class HiddenUnit:
    """RBM hidden unit types (reference: RBM.java:71)."""

    BINARY = "binary"
    GAUSSIAN = "gaussian"
    SOFTMAX = "softmax"
    RECTIFIED = "rectified"


@dataclass
class LayerConfig:
    """Per-layer hyperparameters (≙ NeuralNetConfiguration).

    Field names keep the reference's meaning; defaults match
    NeuralNetConfiguration.java:38-101 where sensible.
    """

    layer_type: str = "dense"
    n_in: int = 0
    n_out: int = 0
    activation: str = "sigmoid"
    loss: str = "RECONSTRUCTION_CROSSENTROPY"
    weight_init: str = "vi"
    dist: tuple[str, float, float] | None = None  # for weight_init="distribution"

    # optimizer
    lr: float = 1e-1
    use_adagrad: bool = True
    momentum: float = 0.5
    momentum_after: dict[int, float] = field(default_factory=dict)
    l2: float = 0.0
    use_regularization: bool = False
    optimization_algo: str = OptimizationAlgorithm.CONJUGATE_GRADIENT
    num_iterations: int = 1000
    num_line_search_iterations: int = 5
    reset_adagrad_iterations: int = -1
    constrain_gradient_to_unit_norm: bool = False
    step_function: str = "default"  # default | gradient | negative_gradient | negative_default
    minimize: bool = False

    # regularization / pretraining
    sparsity: float = 0.0
    apply_sparsity: bool = False
    dropout: float = 0.0
    use_drop_connect: bool = False  # mask weights instead of activations
    corruption_level: float = 0.3

    # RBM
    visible_unit: str = VisibleUnit.BINARY
    hidden_unit: str = HiddenUnit.BINARY
    k: int = 1

    # convolution
    filter_size: tuple[int, ...] = (2, 2)
    num_feature_maps: int = 2
    stride: tuple[int, ...] = (2, 2)

    # misc
    seed: int = 123
    batch_size: int = 10
    concat_biases: bool = False
    render_weights_every: int = -1

    def replace(self, **kw) -> "LayerConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        # JSON maps have string keys; momentum_after is int-keyed.
        d["momentum_after"] = {str(k): v for k, v in self.momentum_after.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LayerConfig":
        d = dict(d)
        if "momentum_after" in d and d["momentum_after"] is not None:
            d["momentum_after"] = {int(k): float(v) for k, v in d["momentum_after"].items()}
        if d.get("dist") is not None:
            kind, a, b = d["dist"]
            d["dist"] = (kind, float(a), float(b))
        for key in ("filter_size", "stride"):
            if key in d and d[key] is not None:
                d[key] = tuple(int(x) for x in d[key])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "LayerConfig":
        return cls.from_dict(json.loads(s))


@dataclass
class MultiLayerConfig:
    """Network-level configuration (≙ MultiLayerConfiguration.java:13).

    ``confs`` holds one LayerConfig per hidden layer plus the output layer
    (last entry).  ``hidden_layer_sizes`` mirrors the reference's
    convenience field; ``pretrain``/``backward`` select greedy layer-wise
    pretraining vs full backprop finetuning, exactly the switch the
    reference keys fit() on (MultiLayerNetwork.java:999-1017).
    """

    confs: list[LayerConfig] = field(default_factory=list)
    hidden_layer_sizes: tuple[int, ...] = ()
    pretrain: bool = True
    backward: bool = False
    use_dropconnect: bool = False
    damping_factor: float = 10.0  # Hessian-free initial damping
    use_gauss_newton_vector_product_back_prop: bool = False
    use_drop_connect: bool = False
    # per-layer-index input processors (≙ OutputPreProcessor wiring);
    # names resolved against nn.preprocessors
    preprocessors: dict[int, str] = field(default_factory=dict)

    def conf(self, i: int) -> LayerConfig:
        return self.confs[i]

    @property
    def n_layers(self) -> int:
        return len(self.confs)

    def to_dict(self) -> dict[str, Any]:
        return {
            "confs": [c.to_dict() for c in self.confs],
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "pretrain": self.pretrain,
            "backward": self.backward,
            "use_dropconnect": self.use_dropconnect,
            "damping_factor": self.damping_factor,
            "use_gauss_newton_vector_product_back_prop": self.use_gauss_newton_vector_product_back_prop,
            "use_drop_connect": self.use_drop_connect,
            "preprocessors": {str(k): v for k, v in self.preprocessors.items()},
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MultiLayerConfig":
        d = dict(d)
        d["confs"] = [LayerConfig.from_dict(c) for c in d.get("confs", [])]
        d["hidden_layer_sizes"] = tuple(d.get("hidden_layer_sizes", ()))
        if "preprocessors" in d and d["preprocessors"] is not None:
            d["preprocessors"] = {int(k): v for k, v in d["preprocessors"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfig":
        return cls.from_dict(json.loads(s))


def list_builder(
    base: LayerConfig,
    sizes: Sequence[int],
    n_in: int,
    n_out: int,
    overrides: dict[int, Callable[[LayerConfig], LayerConfig]] | None = None,
    output_activation: str = "softmax",
    output_loss: str = "MCXENT",
    hidden_layer_type: str | None = None,
    pretrain: bool = True,
    backward: bool = False,
) -> MultiLayerConfig:
    """Build a stacked config from one base conf + per-layer overrides.

    ≙ ``NeuralNetConfiguration.ListBuilder`` with ``ConfOverride`` hooks
    (reference: NeuralNetConfiguration.java:767-828): ``sizes`` are the
    hidden layer widths, the final entry is an output/classifier layer.
    ``overrides[i]`` is a function LayerConfig -> LayerConfig applied to
    layer i after wiring n_in/n_out.
    """
    overrides = overrides or {}
    confs: list[LayerConfig] = []
    widths = [n_in, *sizes]
    for i in range(len(sizes)):
        c = base.replace(
            n_in=widths[i],
            n_out=widths[i + 1],
            layer_type=hidden_layer_type or base.layer_type,
        )
        if i in overrides:
            c = overrides[i](c)
        confs.append(c)
    out = base.replace(
        layer_type="output",
        n_in=widths[-1],
        n_out=n_out,
        activation=output_activation,
        loss=output_loss,
    )
    i_out = len(sizes)
    if i_out in overrides:
        out = overrides[i_out](out)
    confs.append(out)
    return MultiLayerConfig(
        confs=confs,
        hidden_layer_sizes=tuple(sizes),
        pretrain=pretrain,
        backward=backward,
    )
