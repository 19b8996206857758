"""The port's predict entry point against the JAX Predictor, and its
independence from JAX.

A reference-schema .pth (written by the JAX package's save_torch_checkpoint
from perturbed ``test``-variant weights, f32, 64^2) and two small PNGs go
through ``python -m spegnet_tpu_torch predict`` in a subprocess; the output
tree (6 PNGs per image, prediction_summary.json) must match main.py's, and
the saved masks must match the JAX Predictor's to 1 grey level (the PNGs
store floor(255 * p); f32 differences of ~1e-6 can cross a level)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spegnet_tpu.config import load_config, overlay_checkpoint_config
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils.run_manager import DirectoryManager
from spegnet_tpu.utils.torch_import import save_torch_checkpoint

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "default.yaml"
MODEL_CONFIG = {"encoder": {"variant": "test"}, "compute_dtype": "float32",
                "image_processing": {"target_size": 64}}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(0)
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), variables)
    ckpt = root / "model.pth"
    save_torch_checkpoint(str(ckpt), variables, config={"model": MODEL_CONFIG})
    imgs = root / "imgs"
    imgs.mkdir()
    for name, hw in (("a.png", (80, 72)), ("b.png", (48, 64))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(imgs / name)
    return root, ckpt, imgs


def _run_dir(base: Path) -> Path:
    runs = list((base / "results" / "prediction" / "runs").glob("run_*"))
    assert len(runs) == 1, runs
    return runs[0]


def test_cli_predict_matches_jax_predictor(workspace):
    root, ckpt, imgs = workspace
    cwd = root / "port"
    cwd.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "spegnet_tpu_torch", "predict", "--model", str(ckpt),
         "--input", str(imgs), "--config", str(CONFIG), "--device", "cpu"],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = _run_dir(cwd)
    summary = json.loads((run / "prediction_summary.json").read_text())
    assert summary["total_predictions"] == 2
    assert set(summary["average_timings"]) == {"preprocessing", "inference", "postprocessing"}
    pngs = sorted(p.relative_to(run / "results") for p in (run / "results").rglob("*.png"))
    assert len(pngs) == 12
    assert {p.parent.as_posix() for p in pngs} == {
        f"{a}/{b}" for a in ("segmentation", "edges") for b in ("binary", "heatmap", "overlay")}
    assert (run / "prediction_log.txt").exists()

    from spegnet_tpu.engine.predictor import Predictor

    config = overlay_checkpoint_config(load_config(CONFIG), {"model": MODEL_CONFIG})
    jdm = DirectoryManager("predict", base_dir=str(root / "jax" / "results"))
    Predictor(str(ckpt), config["model"], jdm, batch_size=1).predict_directory(str(imgs))
    jrun = jdm.run_dirs.root
    for name in ("a.png", "b.png"):
        for kind in ("segmentation", "edges"):
            got = cv2.imread(str(run / "results" / kind / "binary" / name), cv2.IMREAD_GRAYSCALE)
            want = cv2.imread(str(jrun / "results" / kind / "binary" / name),
                              cv2.IMREAD_GRAYSCALE)
            assert got.shape == want.shape
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (name, kind)


def test_port_runs_without_jax(workspace, tmp_path):
    """Import every module of the port (evaluator, metrics and the int8 ops
    included) and run a CPU predict and a CPU
    train through the CLI in a fresh interpreter: neither JAX nor any module
    of the JAX package (``spegnet_tpu``) may be imported."""
    import yaml
    from test_torch_train import train_config, write_dataset

    root, _, imgs = workspace
    data = write_dataset(tmp_path / "ds")
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(train_config([data])))
    code = f"""
import importlib, pkgutil, sys, torch
import spegnet_tpu_torch
for mod in pkgutil.walk_packages(spegnet_tpu_torch.__path__, "spegnet_tpu_torch."):
    importlib.import_module(mod.name)
from spegnet_tpu_torch.__main__ import main
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.weights import init_weights
m = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(0))
torch.save({{"model_state_dict": m.state_dict(), "config": {{"model": {MODEL_CONFIG!r}}}}},
           "m.pth")
for argv in (["predict", "--model", "m.pth", "--input", {str(imgs / "a.png")!r},
              "--config", {str(CONFIG)!r}, "--device", "cpu"],
             ["train", "--config", "train.yaml", "--device", "cpu"]):
    try:
        main(argv)
    except SystemExit as e:
        assert not e.code, (argv[0], e.code)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spegnet_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert len(list((tmp_path / "results" / "prediction").rglob("*.png"))) == 6
    assert len(list((tmp_path / "results" / "training").rglob("checkpoint_000.pth"))) == 1


def test_predictor_defaults_to_the_card(workspace):
    """device=None means CUDA: without a card the Predictor raises instead
    of falling back to the CPU."""
    from spegnet_tpu_torch.engine.predictor import Predictor

    _, ckpt, _ = workspace
    if torch.cuda.is_available():
        assert Predictor(str(ckpt), MODEL_CONFIG, None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Predictor(str(ckpt), MODEL_CONFIG, None, device=None)


def test_orbax_directory_is_refused(tmp_path):
    from spegnet_tpu_torch.engine.model_loader import load_checkpoint

    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path))
