"""Host-side image preprocessing (port of ``ImageProcessor``,
spegnet_tpu/data/pipeline.py:43).

RGB u8 -> [0, 1] -> antialiased bilinear resize to the target size ->
ImageNet normalization, with the same resize matrices as the JAX package.
Pillow is imported only where a file is decoded.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from spegnet_tpu_torch.ops.resize import resize_matrix_np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


class ImageProcessor:
    def __init__(self, target_size: int = 512,
                 normalize_mean: Sequence[float] = IMAGENET_MEAN,
                 normalize_std: Sequence[float] = IMAGENET_STD):
        self.target_size = int(target_size)
        self.mean = np.asarray(normalize_mean, np.float32)
        self.std = np.asarray(normalize_std, np.float32)
        self._mat_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def _matrix(self, in_size: int) -> np.ndarray:
        key = (in_size, self.target_size)
        if key not in self._mat_cache:
            self._mat_cache[key] = resize_matrix_np(
                in_size, self.target_size, antialias=in_size > self.target_size)
        return self._mat_cache[key]

    def process_array(self, rgb: np.ndarray) -> np.ndarray:
        """u8 [H, W, 3] -> normalized f32 [S, S, 3]."""
        arr = np.asarray(rgb, np.float32) / 255.0
        arr = np.tensordot(self._matrix(arr.shape[0]), arr, axes=(1, 0))
        arr = np.swapaxes(np.tensordot(self._matrix(arr.shape[1]), arr, axes=(1, 1)), 0, 1)
        return (arr - self.mean) / self.std

    def process_image(self, path: str) -> np.ndarray:
        return self.process_array(_read_rgb(path))

    def load_original(self, path: str) -> np.ndarray:
        """Original RGB u8 (for the overlay visualizations)."""
        return _read_rgb(path)
