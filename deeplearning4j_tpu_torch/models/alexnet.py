"""AlexNet-style conv net for CIFAR-10 (the JAX package's
``models/alexnet.py``): a CIFAR-scale adaptation (32x32x3 inputs) of the
AlexNet shape, three conv + max-pool blocks widening the channels, then a
dense head, all through the conv_downsample layer.

A flat input row is the reference's NHWC image, ``(32, 32, 3)`` in H, W, C
order; ``MultiLayerNetwork`` reads it so (three channels) and flattens the
last 256 x 2 x 2 conv block for the dense head in the same H, W, C order,
so the reference's dense weights mean the same here.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.base import DataSet, to_one_hot
from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import conf as C


def alexnet_cifar_config(num_classes: int = 10) -> C.MultiLayerConfig:
    confs = [
        C.LayerConfig(
            layer_type="conv_downsample", n_in=3, num_feature_maps=64,
            filter_size=(3, 3), stride=(2, 2), activation="relu",
        ),  # 32 -> conv 30 -> pool 15
        C.LayerConfig(
            layer_type="conv_downsample", n_in=64, num_feature_maps=128,
            filter_size=(3, 3), stride=(2, 2), activation="relu",
        ),  # 15 -> 13 -> 6
        C.LayerConfig(
            layer_type="conv_downsample", n_in=128, num_feature_maps=256,
            filter_size=(3, 3), stride=(2, 2), activation="relu",
        ),  # 6 -> 4 -> 2
        C.LayerConfig(layer_type="dense", n_in=256 * 2 * 2, n_out=512,
                      activation="relu"),
        C.LayerConfig(layer_type="dense", n_in=512, n_out=256,
                      activation="relu"),
        C.LayerConfig(
            layer_type="output", n_in=256, n_out=num_classes,
            activation="softmax", loss="MCXENT",
        ),
    ]
    return C.MultiLayerConfig(confs=confs, pretrain=False, backward=True)


def build_alexnet(seed: int = 0, device=None):
    """The network and its params from ``seed`` (the reference's weights
    for the same seed), on ``device`` (the card unless the caller names
    another)."""
    net = MultiLayerNetwork(alexnet_cifar_config(), seed=seed, device=device)
    return net, net.init()


def synthetic_cifar(n: int = 1024, seed: int = 0) -> DataSet:
    """CIFAR-shaped synthetic data (NHWC 32x32x3 rows, one-hot labels):
    the reference's oriented gratings per class under noise, the same
    arrays for the same ``n`` and ``seed``."""
    rs = np.random.default_rng(seed)
    labels = rs.integers(0, 10, n)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31
    imgs = np.zeros((n, 32, 32, 3), np.float32)
    for c in range(10):
        m = labels == c
        angle = c * np.pi / 10
        base = 0.5 + 0.5 * np.sin(
            2 * np.pi * (np.cos(angle) * xx + np.sin(angle) * yy) * 3)
        imgs[m] = np.stack([base * (0.3 + 0.07 * ((c + k) % 3))
                            for k in range(3)], -1)
    imgs += rs.normal(0, 0.1, imgs.shape).astype(np.float32)
    return DataSet(np.clip(imgs, 0, 1).reshape(n, -1), to_one_hot(labels, 10))
