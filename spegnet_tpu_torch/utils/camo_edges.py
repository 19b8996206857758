"""Offline ground-truth edge maps for CAMO-style datasets (port of
spegnet_tpu/utils/camo_edges.py).

COD10K ships edge maps; CAMO's are made offline from its masks: the
morphological gradient (dilation minus erosion with a 3x3 kernel,
``edge_width`` iterations) closed with a 3x3 ``MORPH_CLOSE``, then a
continuity check of the edge map's outer contours.  The JAX package runs
all of it in OpenCV on the host.  Here:

* the morphology runs in torch on ``device`` (the card unless the caller
  asks for the CPU), with OpenCV's border rules: a dilation ignores what lies
  outside the image (it pads with the minimum), an erosion too (it pads with
  the maximum), so ``edge_width`` iterations of the 3x3 kernel are one
  (2 edge_width + 1)^2 max pool, and the subtraction saturates at 0;
* the check runs on the host in NumPy, on a contour tracer of the port's
  own (:func:`external_contours`, :func:`arc_length`): what
  ``cv2.findContours(edges, RETR_EXTERNAL, CHAIN_APPROX_NONE)`` and
  ``cv2.arcLength(c, True)`` give, since the card's machine has no OpenCV;
* PNGs are read and written by data/png.py (a mask in colour is read as
  Pillow's luma, where OpenCV's reader takes libpng's).

``python -m spegnet_tpu_torch edges <GT_dir> <Edges_dir>`` runs
:meth:`CAMOEdgeProcessor.process_dataset` (tools/generate_edges.py's
interface).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from spegnet_tpu_torch.data.png import read_png, write_png
from spegnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# OpenCV's chain codes (imgproc/src/contours.cpp): 0 east, then counter-
# clockwise in image coordinates (y down): (dx, dy) of each.
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
# The marks the border follower leaves: NBD 2 (OpenCV's icvFetchContour) on a
# border pixel, 2 | -128 (as a signed char) where its east side is background.
_MARK, _RIGHT = 2, 2 - 128


def _follow(img: memoryview, stride: int, x0: int, y0: int) -> np.ndarray:
    """Suzuki-Abe border following of the outer border that starts at the
    padded image's (x0, y0), as OpenCV's ``icvFetchContour`` with
    CHAIN_APPROX_NONE: every border pixel in order (a one-pixel-wide
    line's pixels twice), the pixels marked as it marks them.  Points in
    the unpadded image's (x, y)."""
    deltas = [dy * stride + dx for dx, dy in zip(_DX, _DY)] * 2
    i0 = y0 * stride + x0
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:                       # a single pixel
        img[i0] = _RIGHT
        return np.array([[x0 - 1, y0 - 1]], np.int32)
    pts = []
    i3, x, y = i0, x0, y0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            img[i3] = _RIGHT
        elif img[i3] == 1:
            img[i3] = _MARK
        pts.append((x - 1, y - 1))
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.array(pts, np.int32)


def external_contours(binary: np.ndarray) -> List[np.ndarray]:
    """The outer borders of the outermost components of a 2-D map (nonzero
    is foreground, 8-connected), each as [n, 2] int32 (x, y) points: what
    ``cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)``
    returns, in its order (the last one found first).

    The raster scan of OpenCV's ``cvFindNextContour`` on the map padded with
    a zero border: a pixel of 1 whose west neighbour is 0 starts an outer
    border unless the last marked pixel of its row (``lnbd``) is a border
    pixel of a component it lies in (mark > 0); holes are passed over."""
    h, w = binary.shape
    stride = w + 2
    buf = np.zeros((h + 2) * stride, np.int8)
    grid = buf.reshape(h + 2, stride)
    grid[1:-1, 1:-1] = binary != 0
    img = memoryview(buf)
    found = []
    for y in np.flatnonzero(grid.any(axis=1)):
        row = grid[y]
        x, prev, lnbd = 1, 0, 0
        while x < w + 1:
            step = np.flatnonzero(row[x:w + 1] != prev)
            if not step.size:
                break
            x += int(step[0])
            p = int(row[x])
            if prev == 0 and p == 1:
                if img[y * stride + lnbd] <= 0:
                    found.append(_follow(img, stride, x, int(y)))
                    lnbd, prev, x = x, int(row[x]), x + 1
                    continue
            elif p == 0 and prev >= 1 and prev & -2:
                lnbd = x - 1
            prev = p
            if p & -2:
                lnbd = x
            x += 1
    return found[::-1]


def arc_length(points: np.ndarray) -> float:
    """The closed polyline's length, as ``cv2.arcLength(points, True)``
    reckons it: each step's length a float sqrt of float squares, summed
    in double from the closing step on."""
    if len(points) <= 1:
        return 0.0
    p = points.astype(np.float32)
    d = p - np.roll(p, 1, axis=0)
    steps = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return float(np.cumsum(steps.astype(np.float64))[-1])


def _max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """Max over the (2r + 1)^2 square about each pixel, inside the image."""
    return F.max_pool2d(x, 2 * r + 1, 1, r)


class CAMOEdgeProcessor:
    """JAX's ``CAMOEdgeProcessor`` (reference: utils/camo_edge_processor.py
    :109-245) with the morphology on ``device`` (None: the card; raises
    without one) and the validation on the host (module docstring)."""

    def __init__(self, edge_width: int = 1, validation_threshold: float = 0.5,
                 device: Optional[str] = None):
        self.edge_width = max(1, int(edge_width))
        self.validation_threshold = validation_threshold
        self.kernel = np.ones((3, 3), np.uint8)
        self.device = resolve_device(device)

    def edge_map(self, mask: np.ndarray) -> np.ndarray:
        """u8 [H, W] mask (any other dtype is thresholded at 127 to 0 / 255)
        -> the u8 closed morphological gradient."""
        if mask.dtype != np.uint8:
            mask = (mask > 127).astype(np.uint8) * 255
        x = torch.from_numpy(np.ascontiguousarray(mask)).to(self.device, torch.float32)[None, None]
        r = self.edge_width
        edges = (_max_pool(x, r) + _max_pool(-x, r)).clamp_(min=0)   # dilate - erode
        edges = -_max_pool(-_max_pool(edges, 1), 1)                  # MORPH_CLOSE
        return edges[0, 0].to(torch.uint8).cpu().numpy()

    def is_continuous(self, edges: np.ndarray) -> bool:
        """The continuity check: the outer contours' points over their
        closed lengths at least ``validation_threshold`` (no contour: not
        valid)."""
        contours = external_contours(edges)
        if not contours:
            return False
        actual = sum(len(c) for c in contours)
        expected = sum(arc_length(c) for c in contours)
        return actual / (expected + 1e-6) >= self.validation_threshold

    def extract_edges(self, mask: np.ndarray, validate: bool = True) -> Tuple[np.ndarray, bool]:
        edges = self.edge_map(mask)
        return edges, self.is_continuous(edges) if validate else True

    def process_dataset(self, input_path: Union[str, Path],
                        output_path: Optional[Union[str, Path]] = None,
                        file_pattern: str = "*.png") -> dict:
        """The edge map of every mask matching ``file_pattern`` in
        ``input_path``, written under the same name in ``output_path`` where
        it is valid -> {"total", "processed", "valid", "failed"}."""
        input_path = Path(input_path)
        if not input_path.exists():
            raise FileNotFoundError(f"Input directory not found: {input_path}")
        if output_path:
            output_path = Path(output_path)
            output_path.mkdir(parents=True, exist_ok=True)
        stats = {"total": 0, "processed": 0, "valid": 0, "failed": 0}
        mask_files = sorted(input_path.glob(file_pattern))
        stats["total"] = len(mask_files)
        for mask_file in mask_files:
            try:
                edges, is_valid = self.extract_edges(read_png(mask_file, "L"), validate=True)
                if output_path and is_valid:
                    write_png(output_path / mask_file.name, edges)
                stats["processed"] += 1
                stats["valid"] += int(is_valid)
            except Exception as e:  # one mask's failure does not stop the run
                stats["failed"] += 1
                logger.error(f"Error processing {mask_file.name}: {e}")
        logger.info(f"Edge generation: {stats['processed']}/{stats['total']} processed, "
                    f"{stats['valid']} valid, {stats['failed']} failed")
        return stats
