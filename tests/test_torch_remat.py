"""``training.remat`` in the port (models/hiera.py, engine/trainer.py)
against the JAX trainer's rule, on the CPU.

* the default (remat when the batch per rank exceeds 16) and the
  ``training.remat`` override give the JAX trainer's ``model.config.remat``
  for the same batch size and data axis;
* remat on against off, same weights and batch (``test`` variant: f32 on
  the plain path and the kernel path, bf16 on the kernel path at 64 x 96,
  where two of the four blocks are decomposed): the loss and every gradient
  bit-equal, each decomposed block run twice (its forward again in the
  backward) and the kernel blocks once, and fewer bytes saved for the
  backward outside the checkpointed blocks;
* the Trainer sets the model's ``remat`` from its config."""

import jax
import numpy as np
import pytest
import torch

from spegnet_tpu.engine import trainer as jtrainer
from spegnet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from spegnet_tpu.utils.run_manager import DirectoryManager as JaxDirectoryManager
from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
from spegnet_tpu_torch.engine import trainer as ttrainer
from spegnet_tpu_torch.models import hiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.weights import init_weights

torch.set_num_threads(1)


def _config(batch_size, remat=None, dtype="float32", size=64):
    training = {"batch_size": batch_size, "num_epochs": 1, "num_workers": 0, "val_ratio": 0,
                "canvas_buckets": [64, 128], "loss": {},
                "optimizer": {"learning_rate": 1e-3, "weight_decay": 1e-5,
                              "encoder_lr_ratio": 0.05}}
    if remat is not None:
        training["remat"] = remat
    return {"model": {"encoder": {"variant": "test", "checkpoint_path": None},
                      "compute_dtype": dtype, "image_processing": {"target_size": size}},
            "training": training}


@pytest.mark.parametrize("batch,data,remat", [
    (16, 1, None), (17, 1, None), (42, 1, None), (32, 2, None), (33, 2, None), (42, 4, None),
    (8, 1, True), (42, 1, False),
])
def test_remat_rule_matches_jax(tmp_path, monkeypatch, batch, data, remat):
    """The JAX trainer's rule, read off its constructor (its model init and
    step compiles skipped)."""
    monkeypatch.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
    monkeypatch.setattr(jtrainer.Trainer, "_build_steps", lambda self: None)
    cfg = _config(batch, remat)
    jt = jtrainer.Trainer(cfg, JaxDirectoryManager("train", base_dir=str(tmp_path)),
                          mesh=jax_create_mesh({"data": data}, jax.devices()[:data]))
    assert ttrainer.remat_for(cfg["training"], data) == jt.model.config.remat


def test_trainer_sets_model_remat():
    for batch, remat, want in ((2, None, False), (17, None, True), (2, True, True),
                               (17, False, False)):
        tr = ttrainer.Trainer(_config(batch, remat), None, device="cpu")
        assert tr.model.config.remat is want


def _grads(model, batch, dtype, remat):
    """Loss, gradients and the bytes saved for the backward (outside the
    checkpointed blocks) of one training forward."""
    tr = ttrainer.Trainer(_config(2, remat, dtype, batch.images.shape[1]), None, device="cpu",
                          model=model)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ld = tr.forward_loss(*tr.to_device(batch))
    tr.optimizer.zero_grad(set_to_none=True)
    ld["loss"].backward()
    return ld["loss"].item(), {n: p.grad.clone() for n, p in model.named_parameters()}, sum(saved)


@pytest.mark.parametrize("dtype,kernels,hw", [
    ("float32", False, (64, 64)), ("float32", True, (64, 64)), ("bfloat16", True, (64, 96)),
])
def test_remat_gradients_bit_equal(monkeypatch, dtype, kernels, hw):
    calls = []
    forward = hiera.MultiScaleBlock.forward

    def counted(self, *args, **kwargs):
        calls.append(self)
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(hiera.MultiScaleBlock, "forward", counted)
    rng = np.random.default_rng(4)
    batch = synthetic_train_batch(2, rng, hw[0], gt_range=(40, 72))
    if hw[1] != hw[0]:
        batch.images = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    model = init_weights(SPEGNet(SPEGNetConfig(variant="test", compute_dtype=dtype),
                                 kernels=kernels),
                         torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    routes = hiera.trunk_routes(model.encoder.encoder.config, (hw[0] // 4, hw[1] // 4),
                                getattr(torch, dtype), False)
    decomposed = (len(routes) if not kernels else
                  sum(r not in hiera.TOKEN_ROUTES for r in routes))
    assert decomposed >= 2
    out = {}
    for remat in (False, True):
        model.load_state_dict(state)
        calls.clear()
        out[remat] = _grads(model, batch, dtype, remat)
        assert len(calls) == decomposed * (2 if remat else 1), (remat, len(calls))
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert s1 < s0, (s1, s0)
