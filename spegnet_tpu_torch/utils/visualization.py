"""Result visualization writers (port of spegnet_tpu/utils/visualization.py).

binary = confidence x 255 grayscale PNG; heatmap = min-max normalized
COLORMAP_JET; overlay = addWeighted(image, 1 - alpha, jet, alpha).  OpenCV
is imported only when a file is written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _cv2():
    import cv2

    return cv2


def save_binary_visualization(prediction: np.ndarray, save_path) -> None:
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    pred = np.squeeze(prediction)
    _cv2().imwrite(str(save_path), (pred * 255).astype(np.uint8))


def save_heatmap_visualization(prediction: np.ndarray, save_path,
                               normalize: bool = True) -> None:
    cv2 = _cv2()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    pred = np.squeeze(prediction)
    if normalize:
        pred = (pred - pred.min()) / (pred.max() - pred.min() + 1e-8)
    heatmap = cv2.applyColorMap((pred * 255).astype(np.uint8), cv2.COLORMAP_JET)
    cv2.imwrite(str(save_path), heatmap)


def save_overlay_visualization(image: np.ndarray, prediction: np.ndarray, save_path,
                               alpha: float = 0.5, colormap=None) -> None:
    cv2 = _cv2()
    if colormap is None:
        colormap = cv2.COLORMAP_JET
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    pred = np.squeeze(prediction)
    image_bgr = (cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
                 if image.ndim == 3 and image.shape[-1] == 3 else image)
    if image_bgr.shape[:2] != pred.shape:
        pred = cv2.resize(pred, (image_bgr.shape[1], image_bgr.shape[0]))
    if pred.max() > 1.0 or pred.min() < 0.0:
        pred = (pred - pred.min()) / (pred.max() - pred.min() + 1e-8)
    heatmap = cv2.applyColorMap((pred * 255).astype(np.uint8), colormap)
    overlay = cv2.addWeighted(image_bgr, 1 - alpha, heatmap, alpha, 0)
    cv2.imwrite(str(save_path), overlay)
