"""LeNet-5-style conv net on MNIST, the flagship model (the JAX package's
``models/lenet.py``): two conv + max-pool blocks (tanh), two dense layers
and a softmax/MCXENT output, built from the reference's config with its
seeded init."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import conf as C


def lenet_config(num_classes: int = 10) -> C.MultiLayerConfig:
    confs = [
        C.LayerConfig(
            layer_type="conv_downsample", n_in=1, num_feature_maps=6,
            filter_size=(5, 5), stride=(2, 2), activation="tanh",
        ),
        C.LayerConfig(
            layer_type="conv_downsample", n_in=6, num_feature_maps=16,
            filter_size=(5, 5), stride=(2, 2), activation="tanh",
        ),
        C.LayerConfig(layer_type="dense", n_in=16 * 4 * 4, n_out=120, activation="tanh"),
        C.LayerConfig(layer_type="dense", n_in=120, n_out=84, activation="tanh"),
        C.LayerConfig(
            layer_type="output", n_in=84, n_out=num_classes,
            activation="softmax", loss="MCXENT",
        ),
    ]
    return C.MultiLayerConfig(confs=confs, pretrain=False, backward=True)


def build_lenet(seed: int = 0, device=None) -> tuple[MultiLayerNetwork, list]:
    """The network and its params from ``seed`` (the reference's weights
    for the same seed), on ``device`` (the card unless the caller names
    another)."""
    net = MultiLayerNetwork(lenet_config(), seed=seed, device=device)
    params = net.init()
    return net, params


def lenet_apply(net: MultiLayerNetwork):
    """Pure forward: (params, x[B,784] or NCHW [B,1,28,28]) -> probabilities."""

    def apply(params, x):
        return net.feed_forward_fn(params, x)[-1]

    return apply


def lenet_loss(net: MultiLayerNetwork):
    """Pure loss: (params, x, y_onehot, key) -> scalar, for the trainers."""

    def loss(params, x, y, key=None):
        return net.supervised_score_fn(params, x, y)

    return loss
