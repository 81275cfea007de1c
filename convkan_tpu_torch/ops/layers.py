"""Linear layer with torch's default init, port of ``Linear`` in
``convkan_tpu/ops/layers.py``.  The weight keeps the JAX layout
``w: (in, out)`` so that ``y = x @ w + b``."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..utils import initializers as init_lib


class Linear(nn.Module):
    """torch.nn.Linear init (kaiming_uniform a=sqrt(5), uniform bias)
    drawn on the CPU from ``generator``, then moved to ``device`` (None:
    the GPU); without a generator the parameters start at zero, for a
    caller that loads a state_dict next."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.w = nn.Parameter(torch.zeros(in_features, out_features,
                                          dtype=dtype))
        self.b = nn.Parameter(torch.zeros(out_features, dtype=dtype))
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: torch.Generator):
        init_lib.kaiming_uniform("leaky_relu", a=math.sqrt(5.0),
                                 layout="linear_io")(self.w, generator)
        init_lib.torch_linear_bias(self.in_features)(self.b, generator)

    def forward(self, x):
        return x @ self.w + self.b
