"""The trainer's ``training.profile`` / ``profile_dir`` and
``training.debug_nans`` (the JAX trainer's, spegnet_tpu/engine/trainer.py
:229-237, spegnet_tpu/utils/profiling.py), on the CPU:

* a torch.profiler trace of steps 2-6 written as a Chrome trace into
  ``profile_dir`` (or the run's ``profile/`` directory under
  ``profile: true``), and nothing without either key;
* ``debug_nans`` raises FloatingPointError on a non-finite loss, and on a
  non-finite gradient naming its parameter, before the optimizer moves any
  parameter."""

import json

import numpy as np
import pytest
import torch

from spegnet_tpu_torch.engine.trainer import Trainer
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils.run_manager import DirectoryManager
from spegnet_tpu_torch.utils.weights import init_weights

from test_torch_train import _batch, train_config  # noqa: E402  (same directory)

torch.set_num_threads(1)


def _trainer(dir_manager=None, **training):
    model = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(3))
    return Trainer(train_config([], **training), dir_manager, device="cpu", model=model)


@pytest.mark.parametrize("key", ["profile_dir", "profile"])
def test_profile_traces_steps_two_to_six(tmp_path, key):
    if key == "profile":
        dm = DirectoryManager("train", base_dir=str(tmp_path))
        tr, out = _trainer(dm, profile=True), dm.run_dirs.root / "profile"
    else:
        out = tmp_path / "trace"
        tr = _trainer(profile_dir=str(out))
    batch = _batch(np.random.default_rng(0))
    for i in range(7):
        tr.train_step(batch)
        assert (out / "trace.json").exists() == (i == 6), i   # written before step 7
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") for e in events)
    tr.trace.close()


def test_no_profile_without_the_keys(tmp_path):
    dm = DirectoryManager("train", base_dir=str(tmp_path))
    tr = _trainer(dm)
    tr.train_step(_batch(np.random.default_rng(0)))
    tr.train_step(_batch(np.random.default_rng(0)))
    assert tr.trace.trace_dir is None and not (dm.run_dirs.root / "profile").exists()


@pytest.mark.parametrize("fault", ["loss", "gradient"])
def test_debug_nans_raises_with_the_parameter(fault):
    tr = _trainer(debug_nans=True)
    params = dict(tr.model.named_parameters())
    name = "decoder.pred_heads.2.weight"
    if fault == "loss":
        with torch.no_grad():
            params[name].fill_(float("nan"))
        match = "non-finite loss"
    else:
        params[name].register_hook(lambda g: g * float("inf"))
        match = f"non-finite gradient of {name}"
    before = {n: p.detach().clone() for n, p in params.items()}
    with pytest.raises(FloatingPointError, match=match):
        tr.train_step(_batch(np.random.default_rng(0)))
    for n, p in params.items():
        assert torch.equal(p, before[n]) or (p.isnan() == before[n].isnan()).all(), n
    tr.debug_nans = False
    if fault == "gradient":   # without the flag the step runs on
        tr.train_step(_batch(np.random.default_rng(0)))
