"""The port's training path (spegnet_tpu_torch/engine/trainer.py and the
train-mode model) against the JAX package, in f32 (one step in f64) on
the CPU.

* optimizer groups: every parameter's group equals the JAX label of the
  same parameter, carried across by ``state_dict_from_jax``;
* train-mode BatchNorm: output and updated running statistics against
  flax BatchNorm and the JAX decoder's ``_BNParams`` (1e-5);
* one train step (``test`` variant, 64^2, batch 2, same weights and batch),
  in f64 on both sides: the loss and every gradient against jax.grad of the
  JAX trainer's loss function, and the updated BN running statistics
  (tolerances at GRAD_* below);
* the optimizer alone: 3 steps of identical gradients (clip included)
  through the port's AdamW groups and the JAX trainer's optax chain, params
  to 1e-6;
* PlateauScheduler: the same lr scales over a metric sequence;
* ``python -m spegnet_tpu_torch train --device cpu`` on a tiny PNG dataset
  written with cv2: metrics.json, a .pth that model_loader reads, and a
  resume that continues at the next epoch;
* the config's ``val_ratio`` trains and validates, and without a card the
  default device is refused."""

import contextlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spegnet_tpu import losses as jl
from spegnet_tpu.engine import trainer as jtrainer
from spegnet_tpu.models.ped import _BNParams
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils.torch_import import _map_hiera_key
from spegnet_tpu_torch.data.pipeline import pack_train_batch
from spegnet_tpu_torch.engine import trainer as ttrainer
from spegnet_tpu_torch.models.cfi import BatchNorm2d
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.weights import state_dict_from_jax, to_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
MODEL = {"encoder": {"variant": "test", "checkpoint_path": None}, "compute_dtype": "float32",
         "image_processing": {"target_size": 64}}
# Gradients of one step, in f64 on both sides.  In f32 the problem is
# ill-conditioned at this size: ReLU kinks and batch-statistics BatchNorm
# (the e-ASPP global branch normalizes two 1x1 maps) move the JAX gradient
# itself by up to 1.3e-2 of a tensor's max when the input moves by 1e-6
# relative, so f32 rounding on either side would hide a wrong gradient.  In
# f64 the two agree to 2.3e-12 of a tensor's max at worst (1.2e-14 relative
# L2): each tensor is held to 1e-8 of its max, the whole flattened gradient
# to 1e-10 relative L2, the gradients that are 0 in exact arithmetic (conv
# biases feeding a batch-statistics BatchNorm) to 1e-12 of the largest
# gradient, and the updated running statistics to 1e-10 relative.
GRAD_TENSOR_RTOL = 1e-8
GRAD_L2_RTOL = 1e-10


def train_config(datasets, **training):
    cfg = {"model": dict(MODEL),
           "training": {"batch_size": 2, "num_epochs": 1, "num_workers": 0, "val_ratio": 0,
                        "save_freq": 1, "gradient_clip": 1.0, "canvas_buckets": [64, 128],
                        "optimizer": {"learning_rate": 1e-3, "weight_decay": 1e-5,
                                      "encoder_lr_ratio": 0.05},
                        "scheduler": {"factor": 0.7, "patience": 5, "min_lr": 1e-6},
                        "loss": {}, "datasets": [str(d) for d in datasets]},
           "prediction": {"batch_size": 1, "output_size": None},
           "parallel": {"mesh": {"data": 1}}}
    cfg["training"].update(training)
    return cfg


def write_dataset(root: Path, sizes=((70, 90), (64, 64), (80, 50))) -> Path:
    """{root}/train/{Imgs,GT,Edges} with one seeded sample per size."""
    rng = np.random.default_rng(0)
    for sub in ("Imgs", "GT", "Edges"):
        (root / "train" / sub).mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(root / "train" / "Imgs" / f"s{i}.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        mask = np.zeros((h, w), np.uint8)
        cv2.ellipse(mask, (w // 2, h // 2), (w // 4, h // 3), 0, 0, 360, 255, -1)
        cv2.imwrite(str(root / "train" / "GT" / f"s{i}.png"), mask)
        cv2.imwrite(str(root / "train" / "Edges" / f"s{i}.png"),
                    cv2.morphologyEx(mask, cv2.MORPH_GRADIENT, np.ones((3, 3), np.uint8)))
    return root


@pytest.fixture(scope="module")
def jax_variables():
    rng = np.random.default_rng(5)
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    return model, variables


def _port_model(variables, kernels=True, compute_dtype="float32"):
    model = SPEGNet(SPEGNetConfig(variant="test", compute_dtype=compute_dtype),
                    kernels=kernels)
    model.load_state_dict(to_torch(state_dict_from_jax(variables)))
    return model.double() if compute_dtype == "float64" else model


@contextlib.contextmanager
def _jax_in_f64(monkeypatch):
    """x64 on, and every JAX-package module's ``jnp.float32`` (its explicit
    f32 accumulation points: LayerNorm and BatchNorm statistics, the loss,
    the resizes) read as float64, for the duration of the block."""

    class F64(types.ModuleType):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    shim = F64("jax.numpy")
    for name, mod in list(sys.modules.items()):
        if name.startswith("spegnet_tpu.") and getattr(mod, "jnp", None) is jnp:
            monkeypatch.setattr(mod, "jnp", shim)
    with jax.enable_x64(True):
        yield
    monkeypatch.undo()


def _to_port_names(params_like, batch_stats_like):
    return state_dict_from_jax({"params": params_like, "batch_stats": batch_stats_like})


def test_param_groups_match_jax_labels(jax_variables):
    _, variables = jax_variables
    labels = jax.tree_util.tree_map_with_path(
        lambda p, a: np.full(np.shape(a), jtrainer._GROUPS.index(jtrainer._param_label(p)),
                             np.float32), variables["params"])
    want = _to_port_names(labels, variables["batch_stats"])
    got = ttrainer.param_labels(_port_model(variables))
    assert set(got) <= set(want)
    assert len(got) == sum(1 for k in want if "running" not in k and "num_batches" not in k)
    for name, group in got.items():
        vals = np.unique(want[name])
        assert len(vals) == 1 and jtrainer._GROUPS[int(vals[0])] == group, name


@pytest.mark.parametrize("kind", ["flax", "ped"])
def test_train_batchnorm_matches_jax(rng, kind):
    c = 8
    x = (rng.standard_normal((3, 5, 6, c)) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = (1 + 0.1 * rng.random(c)).astype(np.float32)
    if kind == "flax":
        mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        call = lambda v: mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])  # noqa: E731
    else:
        mod = _BNParams(c)
        call = lambda v: mod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])  # noqa: E731
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y, new = call(variables)

    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            p.copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), new["batch_stats"]["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["batch_stats"]["var"],
                               rtol=1e-5, atol=1e-6)


def _batch(rng):
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    masks, edges = [], []
    for h, w in ((50, 70), (72, 60)):
        yy, xx = np.mgrid[:h, :w]
        m = (((yy - h / 2) / (h / 3)) ** 2 + ((xx - w / 2) / (w / 4)) ** 2 < 1).astype(np.uint8)
        masks.append(m)
        edges.append(cv2.morphologyEx(m, cv2.MORPH_GRADIENT, np.ones((3, 3), np.uint8)))
    return pack_train_batch(images, masks, edges, (64, 128))


def test_train_step_loss_and_grads_match_jax(rng, jax_variables, monkeypatch):
    _, variables = jax_variables
    batch = _batch(rng)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    variables = f64(variables)
    trainer = ttrainer.Trainer(train_config([]), None, device="cpu",
                               model=_port_model(variables, compute_dtype="float64"))
    proc = trainer.processor
    images = (batch.images / 255.0 - proc.mean.astype(np.float64)) / proc.std.astype(np.float64)
    _, *rest = trainer.to_device(batch)
    ld = trainer.forward_loss(torch.from_numpy(images), *rest)
    assert ld["loss"].dtype == torch.float64
    ld["loss"].backward()

    cfg = jl.LossConfig()
    with _jax_in_f64(monkeypatch):
        jmodel = JaxSPEGNet(JaxConfig(variant="test", compute_dtype="float64"))

        def loss_fn(p):
            out, mut = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(images), train=True, mutable=["batch_stats"])
            l = jl.cod_loss(out["predictions"], out["edge"],
                            jnp.asarray(batch.masks, jnp.float64),
                            jnp.asarray(batch.edges, jnp.float64), jnp.asarray(batch.mask_hw),
                            jnp.asarray(batch.edge_hw), cfg)
            return l["loss"], mut["batch_stats"]

        (jloss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        jloss, grads, new_bs = jax.device_get((jloss, grads, new_bs))
    assert jloss.dtype == np.float64
    np.testing.assert_allclose(ld["loss"].item(), float(jloss), rtol=1e-12)

    want = _to_port_names(grads, new_bs)
    named = dict(trainer.model.named_parameters())
    gmax = max(np.abs(want[n]).max() for n in named)
    diff2 = ref2 = 0.0
    for name, p in named.items():
        got, g = p.grad.numpy(), want[name]
        assert g.dtype == got.dtype == np.float64, name
        diff2 += float(((got - g) ** 2).sum())
        ref2 += float((g ** 2).sum())
        if np.abs(g).max() <= 1e-12 * gmax:
            assert np.abs(got).max() <= 1e-12 * gmax, name
            continue
        np.testing.assert_allclose(got, g, rtol=0, atol=GRAD_TENSOR_RTOL * np.abs(g).max(),
                                   err_msg=name)
    assert np.sqrt(diff2 / ref2) <= GRAD_L2_RTOL
    for name, buf in trainer.model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-10, atol=1e-14,
                                       err_msg=name)


def test_optimizer_matches_optax_chain(tmp_path, monkeypatch):
    """3 steps of identical numpy gradients (the first two above the clip
    norm, the third below it) through both optimizers."""
    monkeypatch.chdir(tmp_path)
    cfg = train_config([])
    jt = jtrainer.Trainer(cfg, jtrainer_dirs(tmp_path))
    model = SPEGNet(SPEGNetConfig(variant="test"))
    model.load_state_dict(to_torch(_to_port_names(jax.device_get(jt.params),
                                                  jax.device_get(jt.batch_stats))))
    tt = ttrainer.Trainer(cfg, None, device="cpu", model=model)

    @jax.jit
    def jax_step(grads, opt_state, params, scales):
        # the update half of the JAX trainer's train_step
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u, lr, g: u * (-lr) * scales[g], updates,
                                         jt.lr_tree, jt.group_idx_tree)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    rng = np.random.default_rng(11)
    params, opt_state = jt.params, jt.opt_state
    for step, mag in enumerate((0.5, 0.2, 0.001)):
        grads = jax.tree_util.tree_map(
            lambda a: (mag * rng.standard_normal(np.shape(a))).astype(np.float32), params)
        params, opt_state = jax_step(grads, opt_state, params, jt._scales_array())

        tgrads = _to_port_names(jax.device_get(grads), jax.device_get(jt.batch_stats))
        for name, p in tt.model.named_parameters():
            p.grad = torch.from_numpy(np.ascontiguousarray(tgrads[name]))
        tt.clip_and_step()

    want = _to_port_names(jax.device_get(params), jax.device_get(jt.batch_stats))
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-6,
                                   err_msg=name)


def jtrainer_dirs(root: Path):
    from spegnet_tpu.utils.run_manager import DirectoryManager

    return DirectoryManager("train", base_dir=str(root / "jax_results"))


def test_plateau_scheduler_matches_jax():
    base = {"encoder": 5e-6, "decoder": 1e-4, "decoder_norm": 1e-4}
    a = jtrainer.PlateauScheduler(base, factor=0.7, patience=1, min_lr=2e-5)
    b = ttrainer.PlateauScheduler(base, factor=0.7, patience=1, min_lr=2e-5)
    for metric in (0.1, 0.2, 0.2, 0.19, 0.2, 0.20001, 0.3, 0.1, 0.1, 0.1, 0.1, 0.1):
        assert a.step(metric) == b.step(metric)
        assert a.scales == b.scales
    assert b.state_dict() == a.state_dict()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


def test_cli_train_writes_checkpoint_and_resumes(tmp_path):
    import yaml

    from spegnet_tpu_torch.engine.model_loader import load_checkpoint

    data = write_dataset(tmp_path / "ds")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(train_config([data])))
    code = """
import sys
from spegnet_tpu_torch.__main__ import main
try:
    main(sys.argv[1:])
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spegnet_tpu"))
assert not bad, bad
"""

    def run(cfg):
        proc = subprocess.run([sys.executable, "-c", code, "train", "--config", str(cfg),
                               "--device", "cpu"], cwd=tmp_path, env=_env(),
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]

    run(cfg_path)
    runs = sorted((tmp_path / "results" / "training" / "runs").glob("run_*"))
    assert len(runs) == 1
    hist = json.loads((runs[0] / "metrics.json").read_text())
    assert len(hist["epochs"]) == 1 and np.isfinite(hist["epochs"][0]["train"]["metrics"]["loss"])
    assert {"forward_time", "backward_time", "epoch_time"} <= set(
        hist["epochs"][0]["train"]["timing"])
    ckpt = runs[0] / "checkpoints" / "checkpoint_000.pth"
    state, config = load_checkpoint(str(ckpt))
    model = SPEGNet(SPEGNetConfig.from_dict(config["model"]))
    model.load_state_dict(state, strict=True)

    resume = train_config([data], num_epochs=2, resume_from=str(ckpt))
    cfg2 = tmp_path / "cfg2.yaml"
    cfg2.write_text(yaml.safe_dump(resume))
    run(cfg2)
    runs2 = [r for r in (tmp_path / "results" / "training" / "runs").glob("run_*")
             if r != runs[0]]
    assert len(runs2) == 1, runs2
    assert not (runs2[0] / "checkpoints" / "checkpoint_000.pth").exists()
    saved = torch.load(runs2[0] / "checkpoints" / "checkpoint_001.pth", weights_only=False)
    assert saved["epoch"] == 1
    hist2 = json.loads((runs2[0] / "metrics.json").read_text())
    assert "train" in hist2["epochs"][1] and "train" not in hist2["epochs"][0]


@pytest.mark.parametrize("fault", [None, "renamed", "dropped"])
def test_trainer_loads_the_sam2_trunk(tmp_path, fault):
    """The config's encoder checkpoint (a SAM2 ``image_encoder.trunk.*``
    state dict) initializes the trunk, as in the JAX trainer; every trunk
    name is one the JAX package maps from SAM2, and a checkpoint whose trunk
    keys do not match the encoder's is refused."""
    src = SPEGNet(SPEGNetConfig(variant="test"))
    trunk = {f"image_encoder.trunk.{k}": torch.randn_like(v)
             for k, v in src.encoder.encoder.state_dict().items()}
    for k in trunk:
        assert _map_hiera_key(k[len("image_encoder.trunk."):]) is not None, k
    key = "image_encoder.trunk.blocks.0.attn.qkv.weight"
    if fault == "renamed":
        trunk["image_encoder.trunk.blocks.0.attn.qkv_w"] = trunk.pop(key)
    elif fault == "dropped":
        del trunk[key]
    path = tmp_path / "sam2.pt"
    torch.save({"model": trunk}, path)
    cfg = train_config([])
    cfg["model"]["encoder"] = {"variant": "test", "checkpoint_path": str(path)}
    if fault:
        with pytest.raises(ValueError, match="qkv"):
            ttrainer.Trainer(cfg, None, device="cpu")
        return
    got = ttrainer.Trainer(cfg, None, device="cpu").model.encoder.encoder.state_dict()
    for k, v in trunk.items():
        torch.testing.assert_close(got[k[len("image_encoder.trunk."):]], v)


def test_trainer_refuses_validation_and_missing_card(tmp_path):
    """The config's val_ratio 0.1 trains and validates (3 samples: 2 train,
    1 val; tests/test_torch_validation.py holds validation against the JAX
    trainer); without a card the default device is refused."""
    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    dm = DirectoryManager("train", base_dir=str(tmp_path / "results"))
    tr = ttrainer.Trainer(train_config([], val_ratio=0.1), dm, device="cpu")
    tr.train([str(write_dataset(tmp_path / "ds"))])
    epoch = json.loads(dm.run_dirs.metrics_file.read_text())["epochs"][0]
    assert {"loss", "weighted_f", "s_alpha", "mae", "e_phi", "mean_f", "edge_mae",
            "edge_f"} <= set(epoch["val"]["metrics"])
    assert all(np.isfinite(v) for v in epoch["val"]["metrics"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrainer.Trainer(train_config([]), None)
