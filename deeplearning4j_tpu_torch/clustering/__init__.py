"""Clustering and spatial indexes of the port (``deeplearning4j_tpu/
clustering``): KMeans (Lloyd iterations on the device), KDTree, QuadTree
(Barnes-Hut support) and VPTree (host copies).

≙ reference clustering/: KMeansClustering.java:112, KDTree.java:351,
QuadTree.java:475, VPTree.java:290.
"""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeans  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
