"""The port's CAMO edge processor (spegnet_tpu_torch/utils/camo_edges.py)
against the JAX package's (spegnet_tpu/utils/camo_edges.py, OpenCV):

* the edge maps bit-equal to JAX's ``extract_edges`` at ``edge_width`` 1-3 on
  seeded random masks, blobs with holes and nested components, shapes
  touching the border, one-pixel lines, a single pixel, an empty mask and a
  float mask (thresholded), and ``is_valid`` equal;
* the contour tracer against ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_NONE)``: the same contours, point for point and in order, on
  those edge maps and on random binary maps; ``arc_length`` equal to
  ``cv2.arcLength(c, True)``;
* ``process_dataset`` and ``python -m spegnet_tpu_torch edges`` against
  JAX's ``process_dataset`` on a directory of PNG masks: the same stats and
  the same edge maps written (decoded, since the two PNG encoders differ);
* the module imports neither OpenCV nor JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from spegnet_tpu.utils.camo_edges import CAMOEdgeProcessor as JaxEdges
from spegnet_tpu_torch.utils.camo_edges import CAMOEdgeProcessor, arc_length, external_contours

REPO = Path(__file__).resolve().parents[1]


def _blobs(rng, n: int, size: int = 96) -> np.ndarray:
    img = np.zeros((size, size), np.uint8)
    for _ in range(n):
        cy, cx = (int(v) for v in rng.integers(-8, size + 8, 2))
        r = int(rng.integers(2, size // 3))
        cv2.circle(img, (cx, cy), r, int(rng.integers(1, 256)), -1)
        if rng.random() < 0.5:     # a hole, sometimes with a component inside
            cv2.circle(img, (cx, cy), r // 2, 0, -1)
            if rng.random() < 0.5:
                cv2.circle(img, (cx, cy), r // 5, 255, -1)
    return img


def _cases():
    rng = np.random.default_rng(11)
    line = np.zeros((32, 40), np.uint8)
    line[10, 3:30] = 255
    line[5:25, 20] = 255
    diag = np.eye(24, dtype=np.uint8) * 255
    pixel = np.zeros((16, 16), np.uint8)
    pixel[7, 9] = 255
    border = np.zeros((40, 40), np.uint8)
    border[:12, :] = 200
    border[20:, 30:] = 255
    ring = np.zeros((48, 48), np.uint8)
    cv2.circle(ring, (24, 24), 18, 255, -1)
    cv2.circle(ring, (24, 24), 10, 0, -1)
    cv2.circle(ring, (24, 24), 4, 255, -1)
    cases = {"line": line, "diagonal": diag, "pixel": pixel, "border": border,
             "nested": ring, "empty": np.zeros((20, 30), np.uint8),
             "full": np.full((20, 30), 255, np.uint8),
             "float": rng.random((33, 47)).astype(np.float32) * 255}
    for i in range(6):
        cases[f"blobs{i}"] = _blobs(rng, i + 1)
    for i in range(4):
        cases[f"noise{i}"] = ((rng.random((40, 52)) < 0.3 + 0.1 * i) * 255).astype(np.uint8)
    return cases


CASES = _cases()


@pytest.mark.parametrize("edge_width", [1, 2, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_edges_equal_jax(name, edge_width):
    mask = CASES[name]
    want, want_valid = JaxEdges(edge_width).extract_edges(mask)
    got, got_valid = CAMOEdgeProcessor(edge_width, device="cpu").extract_edges(mask)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got_valid == want_valid
    contours, _ = cv2.findContours(want, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    mine = external_contours(got)
    assert len(mine) == len(contours)
    for a, b in zip(mine, contours):
        assert np.array_equal(a, b.reshape(-1, 2))
        assert arc_length(a) == cv2.arcLength(b, True)


def test_contours_equal_opencv_on_random_maps():
    """Random binary maps of every density (the hard cases for border
    following: single pixels, diagonal touches, holes, one-pixel lines)."""
    rng = np.random.default_rng(13)
    for t in range(200):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        img = ((rng.random((h, w)) < rng.random()) * rng.integers(1, 256)).astype(np.uint8)
        contours, _ = cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        mine = external_contours(img)
        assert len(mine) == len(contours), t
        for a, b in zip(mine, contours):
            assert np.array_equal(a, b.reshape(-1, 2)), t
            assert arc_length(a) == cv2.arcLength(b, True), t


def _dataset(root: Path) -> Path:
    d = root / "GT"
    d.mkdir()
    rng = np.random.default_rng(17)
    for i in range(6):
        cv2.imwrite(str(d / f"m{i}.png"), _blobs(rng, i % 3 + 1, 64))
    cv2.imwrite(str(d / "noise.png"), ((rng.random((40, 40)) < 0.5) * 255).astype(np.uint8))
    cv2.imwrite(str(d / "empty.png"), np.zeros((24, 24), np.uint8))
    (d / "broken.png").write_bytes(b"not a png")
    return d


def _written(d: Path):
    return {p.name: cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) for p in sorted(d.glob("*.png"))}


@pytest.mark.parametrize("edge_width", [1, 2])
def test_process_dataset_and_cli_equal_jax(tmp_path, edge_width):
    gt = _dataset(tmp_path)
    want = JaxEdges(edge_width).process_dataset(gt, tmp_path / "jax")
    got = CAMOEdgeProcessor(edge_width, device="cpu").process_dataset(gt, tmp_path / "port")
    assert got == want and want["failed"] == 1 and 0 < want["valid"] < want["total"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH",
                                                                                 "")]))
    proc = subprocess.run([sys.executable, "-m", "spegnet_tpu_torch", "edges", str(gt),
                           str(tmp_path / "cli"), "--edge-width", str(edge_width),
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert ast.literal_eval(proc.stdout.strip().splitlines()[-1]) == want
    jax_maps = _written(tmp_path / "jax")
    assert len(jax_maps) == want["valid"]
    for out in ("port", "cli"):
        maps = _written(tmp_path / out)
        assert maps.keys() == jax_maps.keys()
        assert all(np.array_equal(maps[k], jax_maps[k]) for k in maps)


def test_module_imports_no_opencv_or_jax(tmp_path):
    """The card's machine has neither: the processor runs a dataset without
    importing them."""
    gt = tmp_path / "GT"
    gt.mkdir()
    cv2.imwrite(str(gt / "m.png"), _blobs(np.random.default_rng(19), 2, 64))
    code = ("import sys; from spegnet_tpu_torch.utils.camo_edges import CAMOEdgeProcessor; "
            f"s = CAMOEdgeProcessor(device='cpu').process_dataset({str(gt)!r}, "
            f"{str(tmp_path / 'out')!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'jax', 'jaxlib', 'flax', 'spegnet_tpu')]; "
            "assert not bad, bad; assert s['processed'] == 1, s")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH",
                                                                                 "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
