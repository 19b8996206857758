"""The port's evaluate entry point (spegnet_tpu_torch/engine/evaluator.py,
``python -m spegnet_tpu_torch evaluate``) against the JAX Evaluator.

A synthetic COD test split (PNG images and ground truths of ragged sizes)
and a reference-schema .pth written by the JAX package from perturbed
``test``-variant weights (f32, 64^2) go through both evaluators on the CPU.
Per-sample and per-dataset metrics must agree to 1e-4 (measured: at most
6.6e-6): both run f32, but their logits differ by ~1e-5 (summation order),
which can move a prediction across one of the 255 quantization levels.
The output tree, the JSON files and the quality buckets follow the JAX
evaluator's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils.run_manager import DirectoryManager as JaxDirectoryManager
from spegnet_tpu.utils.torch_import import save_torch_checkpoint
from spegnet_tpu_torch.config import overlay_checkpoint_config
from spegnet_tpu_torch.data.dataset import get_test_datasets
from spegnet_tpu_torch.data.pipeline import eval_loader, synthetic_eval_batch
from spegnet_tpu_torch.engine.evaluator import METRIC_KEYS, Evaluator, ResultManager
from spegnet_tpu_torch.utils.run_manager import DirectoryManager

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
MODEL_CONFIG = {"encoder": {"variant": "test"}, "compute_dtype": "float32",
                "image_processing": {"target_size": 64}}
TOL = 1e-4
SIZES = [(48, 56), (64, 48), (56, 64), (40, 40), (70, 66)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(0)
    ds = root / "SYNTH"
    for d in ("Imgs", "GT"):
        (ds / "test" / d).mkdir(parents=True)
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy - h / 2) ** 2 + (xx - w / 2.5) ** 2) < (min(h, w) / 3.5) ** 2
        img[m] = (img[m] * 0.6 + 80).astype(np.uint8)
        Image.fromarray(img).save(ds / "test" / "Imgs" / f"s{i}.jpg")
        Image.fromarray((m * 255).astype(np.uint8)).save(ds / "test" / "GT" / f"s{i}.png")
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), variables)
    ckpt = root / "model.pth"
    save_torch_checkpoint(str(ckpt), variables, config={"model": MODEL_CONFIG})
    return root, ds, ckpt


def _per_sample(run_root: Path, name: str):
    out = {}
    for p in (run_root / name / "metrics").rglob("*_metrics.json"):
        out[p.name[: -len("_metrics.json")]] = (p.parent.name, json.loads(p.read_text()))
    return out


@pytest.fixture(scope="module")
def jax_run(workspace):
    from spegnet_tpu.data.dataset import get_test_datasets as jax_get_test_datasets
    from spegnet_tpu.engine.evaluator import Evaluator as JaxEvaluator

    root, ds, ckpt = workspace
    dm = JaxDirectoryManager("evaluate", base_dir=str(root / "jax"))
    ev = JaxEvaluator(model_path=str(ckpt), dir_manager=dm, model_config=MODEL_CONFIG,
                      batch_size=2, save_visualizations=False, canvas_buckets=(64, 128))
    means = ev.evaluate(jax_get_test_datasets([str(ds)])["SYNTH"], "SYNTH")
    return means, _per_sample(dm.run_dirs.root, "SYNTH")


@pytest.fixture(scope="module")
def port_run(workspace):
    root, ds, ckpt = workspace
    dm = DirectoryManager("evaluate", base_dir=str(root / "port"))
    ev = Evaluator(str(ckpt), dm, MODEL_CONFIG, batch_size=2, save_visualizations=False,
                   canvas_buckets=(64, 128), device="cpu")
    means = ev.evaluate(get_test_datasets([str(ds)])["SYNTH"], "SYNTH")
    return means, _per_sample(dm.run_dirs.root, "SYNTH"), dm.run_dirs.root, ev


@pytest.mark.parametrize("key", METRIC_KEYS)
def test_dataset_means_match_jax(jax_run, port_run, key):
    assert 0.0 <= port_run[0][key] <= 1.0
    assert abs(port_run[0][key] - jax_run[0][key]) <= TOL, (port_run[0][key], jax_run[0][key])


def test_per_sample_metrics_and_buckets_match_jax(jax_run, port_run):
    want, got = jax_run[1], port_run[1]
    assert sorted(got) == sorted(want) == [f"s{i}" for i in range(len(SIZES))]
    for name, (cat, m) in got.items():
        wcat, wm = want[name]
        assert sorted(m) == sorted(wm) == sorted(METRIC_KEYS)
        for k in METRIC_KEYS:
            assert abs(m[k] - wm[k]) <= TOL, (name, k, m[k], wm[k])
        assert cat == ResultManager.determine_quality_category(m)
        assert m == port_run[3].sample_metrics["SYNTH"][name]


def test_summary_json(port_run):
    means, per_sample, run_root, ev = port_run
    summary = json.loads((run_root / "SYNTH" / "evaluation_summary.json").read_text())
    assert summary["metrics"] == pytest.approx(means)
    assert summary["categories"]["total"] == len(SIZES)
    assert sum(summary["categories"]["counts"].values()) == len(SIZES)
    t = summary["timing"]
    assert t["total_samples"] == len(SIZES) and t["device"] == "cpu"
    assert t["forward_ms_per_image"] > 0 and t["metrics_ms_per_image"] > 0
    assert ev.summaries["SYNTH"] == summary


@pytest.mark.parametrize("s,f,cat", [(0.85, 0.81, "good"), (0.85, 0.7, "medium"),
                                     (0.65, 0.95, "medium"), (0.59, 0.9, "bad"),
                                     (0.8, 0.8, "good"), (0.6, 0.6, "medium")])
def test_quality_buckets(s, f, cat):
    assert ResultManager.determine_quality_category({"s_alpha": s, "weighted_f": f}) == cat


def test_eval_loader_pads_the_tail_batch(workspace):
    from spegnet_tpu_torch.data.pipeline import ImageProcessor

    _, ds, _ = workspace
    batches = list(eval_loader(get_test_datasets([str(ds)])["SYNTH"], ImageProcessor(64), 2,
                               (64, 128), num_workers=0))
    assert [int(b.sample_mask.sum()) for b in batches] == [2, 2, 1]
    tail = batches[-1]
    assert tail.names == ["s4", ""] and tail.masks.shape == (2, 128, 128)
    assert tuple(tail.mask_hw[0]) == (70, 66)


def test_in_memory_evaluator_on_synthetic_batches(workspace):
    """dir_manager None: no files, metrics and summaries kept in memory
    (how chip_smoke.py drives it, with synthetic batches)."""
    _, _, ckpt = workspace
    ev = Evaluator(str(ckpt), None, MODEL_CONFIG, batch_size=3, device="cpu")
    rng = np.random.default_rng(2)
    batches = [synthetic_eval_batch(3, rng, size=64, gt_range=(48, 80), buckets=(64, 128),
                                    first=3 * i) for i in range(2)]
    means = ev.evaluate(None, "synthetic", loader=batches)
    assert len(ev.sample_metrics["synthetic"]) == 6
    assert all(0.0 <= v <= 1.0 for v in means.values())
    assert ev.summaries["synthetic"]["timing"]["total_samples"] == 6


def test_overlay_keeps_the_users_int8_switch():
    cfg = {"model": {"compute_dtype": "bfloat16", "int8_encoder": True}}
    out = overlay_checkpoint_config(cfg, {"model": {"compute_dtype": "float32",
                                                    "int8_encoder": False}})
    assert out["model"] == {"compute_dtype": "float32", "int8_encoder": True}


def test_cli_evaluate(workspace, jax_run):
    root, ds, ckpt = workspace
    cwd = root / "cli"
    cwd.mkdir()
    cfg = yaml.safe_load((REPO / "configs" / "default.yaml").read_text())
    cfg["evaluation"].update(datasets=[str(ds)], batch_size=2, save_visualizations=True)
    cfg["training"]["canvas_buckets"] = [64, 128]
    (cwd / "eval.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "spegnet_tpu_torch", "evaluate", "--model", str(ckpt),
         "--config", "eval.yaml", "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = list((cwd / "results" / "evaluation" / "runs").glob("run_*"))
    assert len(runs) == 1
    summary = json.loads((runs[0] / "metrics_summary.json").read_text())
    assert set(summary) == {"SYNTH"}
    for k in METRIC_KEYS:
        assert abs(summary["SYNTH"][k] - jax_run[0][k]) <= TOL
    assert (runs[0] / "SYNTH" / "evaluation_summary.json").exists()
    viz = runs[0] / "SYNTH" / "visualizations"
    for kind in ("segmentation", "edges"):
        for sub in ("binary", "heatmap", "overlay"):
            assert len(list(viz.glob(f"*/{kind}/{sub}/s*.png"))) >= len(SIZES), (kind, sub)
    assert len(list((runs[0] / "SYNTH" / "metrics").rglob("*_metrics.json"))) == len(SIZES)
