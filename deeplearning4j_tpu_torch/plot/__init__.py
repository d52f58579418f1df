"""Visualization of the port (``deeplearning4j_tpu/plot``): t-SNE (exact,
on the device) and Barnes-Hut t-SNE (host), weight/activation plotting and
the render endpoint (matplotlib imported only when a plot is drawn)."""

from deeplearning4j_tpu_torch.plot.tsne import Tsne  # noqa: F401
