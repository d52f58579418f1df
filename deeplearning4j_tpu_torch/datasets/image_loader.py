"""Image file -> array loading with optional resize.

≙ reference util/ImageLoader.java:21 (asRowVector:37, asMatrix:61,
asImageMiniBatches:50, toImage:84) — host-side IO feeding the data
pipeline; arrays are handed on as float32 batches.

The port's copy of ``deeplearning4j_tpu/datasets/image_loader.py`` (host IO: no torch).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class ImageLoader:
    """Loads images as grayscale matrices / flattened row vectors.

    ``width``/``height``: target size (resized on load when set, matching
    the reference's scaling constructor ImageLoader.java:31).
    """

    def __init__(self, width: int | None = None, height: int | None = None):
        self.width = width
        self.height = height

    def _load(self, path: str | Path) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("L")
        if self.width and self.height:
            img = img.resize((self.width, self.height))
        return np.asarray(img, dtype=np.float32)

    def as_matrix(self, path: str | Path) -> np.ndarray:
        """(H, W) grayscale float32 (≙ asMatrix:61)."""
        return self._load(path)

    def as_row_vector(self, path: str | Path) -> np.ndarray:
        """(1, H*W) flattened (≙ asRowVector:37)."""
        return self._load(path).reshape(1, -1)

    def as_mini_batches(
        self, path: str | Path, num_batches: int, rows_per_slice: int
    ) -> list[np.ndarray]:
        """Row-sliced minibatches of one image (≙ asImageMiniBatches:50)."""
        m = self.as_matrix(path)
        return [
            m[i * rows_per_slice : (i + 1) * rows_per_slice]
            for i in range(num_batches)
        ]

    @staticmethod
    def to_image(matrix: np.ndarray, path: str | Path) -> None:
        """Write a 2D array back out as an 8-bit grayscale image
        (≙ toImage:84)."""
        from PIL import Image

        m = np.asarray(matrix, dtype=np.float32)
        lo, hi = float(m.min()), float(m.max())
        scaled = (m - lo) / (hi - lo or 1.0) * 255.0
        Image.fromarray(scaled.astype(np.uint8), mode="L").save(path)
