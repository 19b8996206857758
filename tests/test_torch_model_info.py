"""The model report of the port (spegnet_tpu_torch/utils/model_info.py)
against the JAX package's (spegnet_tpu/utils/model_info.py).

* the exact parameter count of the ``test`` variant and of Hiera-L equals
  JAX's (``jax.eval_shape`` of the init; the port's model on the meta
  device), and so does each top-level module's count in the architecture
  lines;
* the forward FLOPs counted on the meta device equal those counted on the
  CPU with real tensors (the same ops reach the counter), and grow with the
  input;
* ``print_model_info`` logs the tree, the parameters and the FLOPs."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.utils import model_info as jinfo
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.utils import model_info


@pytest.mark.parametrize("variant", ["test", "large"])
def test_parameter_count_matches_jax(variant):
    shapes = jax.eval_shape(JaxSPEGNet(JaxConfig(variant=variant)).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    got = model_info.model_complexity({"encoder": {"variant": variant}}, 64, flops=False)
    assert got == {"params": want, "flops": None}


def test_architecture_lines_match_jax_per_module():
    def top(lines):
        return {ln.split(":")[0].strip(): ln.split()[-3] for ln in lines
                if ln.startswith("  ") and not ln.startswith("    ")}

    want = top(jinfo.architecture_lines(JaxSPEGNet(JaxConfig(variant="test")), 64))
    lines = model_info.architecture_lines(SPEGNetConfig(variant="test"))
    assert lines[0] == "SPEGNet(" and lines[-1] == ")"
    assert top(lines) == want


def test_meta_flops_equal_cpu_flops():
    got = model_info.model_complexity(SPEGNetConfig(variant="test"), 64)["flops"]
    model = SPEGNet(SPEGNetConfig(variant="test"), kernels=False).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, 64, 64, 3))
    assert got == counter.get_total_flops() > 0
    assert model_info.model_complexity(SPEGNetConfig(variant="test"), 128)["flops"] > 4 * got


def test_print_model_info_logs_the_report(caplog):
    with caplog.at_level(logging.INFO, logger="spegnet_tpu_torch.utils.model_info"):
        model_info.print_model_info({"encoder": {"variant": "test"}}, 64)
    text = caplog.text
    assert "Number of Parameters: 2.62 M" in text
    assert "GFLOPs" in text and "encoder:" in text
