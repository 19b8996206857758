"""nn.Linear / nn.Conv2d that cast their parameters to the input's dtype
where they are used, as the JAX package's modules cast their f32 params to
the compute dtype (spegnet_tpu/models/hiera.py:463-471, ped.py:84).

Training keeps every parameter in f32 (AdamW's master weights) and runs the
forward in the compute dtype; for predict, ``SPEGNet.to_compute`` casts the
modules once and the cast at use is a no-op.  Names and state-dict keys are
those of nn.Linear / nn.Conv2d.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def cast(p, dtype: torch.dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))
