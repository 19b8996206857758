"""Validation in the port's trainer (spegnet_tpu_torch/engine/trainer.py
``val_step`` / ``validate`` / the val branch of ``_train``,
data/pipeline.py ``val_loader``) against the JAX trainer, in f32 on the CPU
(``test`` variant, 64^2), and PED block 2's dispatch by dtype.

* ``val_loader`` against the JAX package's on the same on-disk samples
  (both with NumPy preprocessing and scipy's distance transform): masks,
  edges, sizes and nearest indices equal, images and distances to 1e-6;
* ``validate`` against ``Trainer.validate`` of the JAX package on the same
  weights and the same batches: every metric key to 1e-4 (the evaluator's
  tolerance, tests/test_torch_evaluator.py: both run f32, but their logits
  differ by ~1e-5, which can move a prediction across a quantization level);
* a 3-epoch CPU run from disk with ``val_ratio > 0`` whose weighted F is
  scripted over the real validation: ``model_best.pth`` on improvement by
  more than ``min_delta``, the plateau scale after ``patience`` epochs
  without improvement, the early stop after ``early_stop_patience``;
* f32 runs PED block 2 decomposed and bf16 through the fused block, as the
  JAX package's ``dtype == bfloat16`` term; the f32 predictions against the
  JAX model's (the model tolerance of tests/test_torch_model.py)."""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spegnet_tpu import native
from spegnet_tpu.data import dataset as jdataset
from spegnet_tpu.data import pipeline as jpipe
from spegnet_tpu.engine import trainer as jtrainer
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils.run_manager import DirectoryManager as JaxDirectoryManager
from spegnet_tpu_torch.data.dataset import concat_train_datasets
from spegnet_tpu_torch.data.pipeline import ImageProcessor, val_loader
from spegnet_tpu_torch.engine import trainer as ttrainer
from spegnet_tpu_torch.engine.model_loader import load_checkpoint
from spegnet_tpu_torch.models import ped as tped
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.run_manager import DirectoryManager
from spegnet_tpu_torch.utils.weights import state_dict_from_jax, to_torch

torch.set_num_threads(1)
TOL = 1e-4
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
SIZES = [(70, 90), (64, 64), (80, 50), (60, 72), (66, 66), (56, 76)]
KEYS = ("loss", "seg_loss", "edge_loss", "s_alpha", "weighted_f", "mae", "e_phi", "mean_f",
        "edge_mae", "edge_f")


def _config(**training):
    cfg = {"model": {"encoder": {"variant": "test", "checkpoint_path": None},
                     "compute_dtype": "float32", "image_processing": {"target_size": 64}},
           "training": {"batch_size": 2, "num_epochs": 1, "num_workers": 0, "val_ratio": 0,
                        "save_freq": 100, "gradient_clip": 1.0, "canvas_buckets": [64, 128],
                        "optimizer": {"learning_rate": 1e-3, "weight_decay": 1e-5,
                                      "encoder_lr_ratio": 0.05},
                        "scheduler": {"factor": 0.7, "patience": 5, "min_lr": 1e-6},
                        "loss": {}},
           "parallel": {"mesh": {"data": 1}}}
    cfg["training"].update(training)
    return cfg


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """{root}/train/{Imgs,GT,Edges}: seeded PNGs of ragged sizes, ellipse
    ground truths and their boundaries."""
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(0)
    for sub in ("Imgs", "GT", "Edges"):
        (root / "train" / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(SIZES):
        yy, xx = np.mgrid[:h, :w]
        m = (((yy - h * rng.uniform(0.4, 0.6)) / (h / 3)) ** 2
             + ((xx - w * rng.uniform(0.4, 0.6)) / (w / 4)) ** 2) < 1
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        img[m] = (img[m] * 0.5 + 90).astype(np.uint8)
        p = np.pad(m, 1)
        edge = m & ~(p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:])
        Image.fromarray(img).save(root / "train" / "Imgs" / f"s{i}.png")
        Image.fromarray((m * 255).astype(np.uint8)).save(root / "train" / "GT" / f"s{i}.png")
        Image.fromarray((edge * 255).astype(np.uint8)).save(root / "train" / "Edges" / f"s{i}.png")
    return root


@pytest.fixture(scope="module")
def jax_variables():
    """Perturbed ``test``-variant weights and BN statistics (f32)."""
    rng = np.random.default_rng(5)
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    return model, variables


def _port_model(variables, compute_dtype="float32"):
    model = SPEGNet(SPEGNetConfig(variant="test", compute_dtype=compute_dtype))
    model.load_state_dict(to_torch(state_dict_from_jax(variables)))
    return model


@pytest.fixture
def numpy_host_path(monkeypatch):
    """The JAX pipeline's NumPy / scipy host path (its native library, where
    built, resizes and breaks EDT ties its own way)."""
    monkeypatch.setattr(native, "preprocess_image", lambda *a, **k: None)
    monkeypatch.setattr(native, "edt_with_indices", lambda *a, **k: None)


def _port_batches(root, batch_size):
    ds = concat_train_datasets([str(root)])
    return list(val_loader(ds, ImageProcessor(64), batch_size, (64, 128), num_workers=0))


def test_val_loader_matches_jax(data_root, numpy_host_path):
    got = _port_batches(data_root, 4)
    want = list(jpipe.val_loader(jdataset.concat_train_datasets([str(data_root)]),
                                 jpipe.ImageProcessor(64), 4, (64, 128), num_workers=0))
    assert [b.images.shape[0] for b in got] == [b.images.shape[0] for b in want] == [4, 2]
    for g, w in zip(got, want):
        assert g.images.dtype == np.float32
        np.testing.assert_allclose(g.images, w.images, rtol=0, atol=1e-6)
        for key in ("masks", "edges", "mask_hw", "edge_hw", "nearest_idx"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)
        np.testing.assert_allclose(g.dst, w.dst, rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_size", [2, 4])
def test_validate_matches_jax_trainer(data_root, jax_variables, tmp_path, batch_size):
    """``batch_size`` 4 leaves a short tail batch of 2 (no padding on one
    device on either side)."""
    _, variables = jax_variables
    batches = _port_batches(data_root, batch_size)
    jt = jtrainer.Trainer(_config(batch_size=batch_size),
                          JaxDirectoryManager("train", base_dir=str(tmp_path / "jax")))
    jt.params, jt.batch_stats = variables["params"], variables["batch_stats"]
    fields = [f.name for f in jpipe.dataclasses.fields(jpipe.ValBatch)]
    jbatches = [jpipe.ValBatch(**{k: (getattr(b, k).astype(np.float32)
                                      if k in ("masks", "edges") else getattr(b, k))
                                  for k in fields}) for b in batches]
    want = jt.validate(jbatches, 0)

    tt = ttrainer.Trainer(_config(batch_size=batch_size), None, device="cpu",
                          model=_port_model(variables))
    got = tt.validate(batches, 0)
    assert tt.model.training   # back in train mode
    assert set(got) == set(want) == set(KEYS) | {"batch_time"}
    for key in KEYS:
        assert abs(got[key] - want[key]) <= TOL, (key, got[key], want[key])


def test_training_validates_keeps_best_steps_plateau_and_stops(data_root, monkeypatch,
                                                               tmp_path):
    """val_ratio 0.34 of 6 samples: 3 train, 3 val.  The real validation runs
    each epoch; its weighted F is then replaced by the script 0.5, 0.504,
    0.504 (min_delta 0.005, early-stop patience 2): epoch 0 improves
    (model_best.pth), epochs 1 and 2 do not (0.004 over the best, below
    min_delta), so the loop stops after epoch 2.  The scheduler's own rule
    is a relative 1e-4: epoch 1 is better, epoch 2 its first bad epoch, which
    cuts the lr scales under scheduler patience 0 and not under 1."""
    real = ttrainer.Trainer.validate
    seen = []

    def scripted(self, loader, epoch):
        nonlocal script
        stats = real(self, loader, epoch)
        assert set(KEYS) <= set(stats) and all(np.isfinite(stats[k]) for k in KEYS)
        seen.append(dict(stats))
        self.monitor.batch_stats["weighted_f"] = {"sum": next(script), "count": 1}
        return self.monitor.get_current_stats()

    monkeypatch.setattr(ttrainer.Trainer, "validate", scripted)
    runs = {}
    for patience in (1, 0):
        script = iter([0.5, 0.504, 0.504])
        seen.clear()
        cfg = _config(num_epochs=5, val_ratio=0.34, early_stop_patience=2, min_delta=0.005,
                      scheduler={"factor": 0.7, "patience": patience, "min_lr": 1e-6})
        dm = DirectoryManager("train", base_dir=str(tmp_path / f"p{patience}"))
        tr = ttrainer.Trainer(cfg, dm, device="cpu")
        tr.train([str(data_root)])
        runs[patience] = (tr, dm, len(seen))
    for patience, (tr, dm, n_val) in runs.items():
        assert n_val == 3, patience   # early stop after epoch 2
        hist = json.loads(dm.run_dirs.metrics_file.read_text())
        assert len(hist["epochs"]) == 3
        assert all("val" in e and "train" in e for e in hist["epochs"])
        assert set(KEYS) <= set(hist["epochs"][1]["val"]["metrics"])
        assert hist["best_metrics"]["weighted_f"] == 0.5
        ckpt = dm.run_dirs.checkpoints / "model_best.pth"
        state, config = load_checkpoint(str(ckpt))
        saved = torch.load(ckpt, weights_only=False)
        assert saved["epoch"] == 0 and saved["metrics"]["weighted_f"] == 0.5
        SPEGNet(SPEGNetConfig.from_dict(config["model"])).load_state_dict(state, strict=True)
        scale = 1.0 if patience == 1 else 0.7
        assert tr.scheduler.scales == {g: pytest.approx(scale) for g in tr.scheduler.scales}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_block2_dispatch_follows_dtype(jax_variables, monkeypatch, dtype):
    model_j, variables = jax_variables
    model = _port_model(variables, dtype).eval().to_compute()
    calls = collections.Counter()
    fn = tped.fused_decoder_block
    monkeypatch.setattr(tped, "fused_decoder_block",
                        lambda *a, **k: calls.update(["fused"]) or fn(*a, **k))
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert calls["fused"] == (dtype == "bfloat16")
    if dtype == "float32":
        want = jax.device_get(jax.jit(model_j.apply)(variables, jnp.asarray(x)))
        for g, w in zip(got["predictions"], want["predictions"]):
            np.testing.assert_allclose(g.numpy(), w, **MODEL_TOL)
