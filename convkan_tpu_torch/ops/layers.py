"""Linear layer with torch's default init, stochastic depth and the
squeeze-excitation block, port of ``Linear``, ``DropPath`` and
``SqueezeExcitation`` in ``convkan_tpu/ops/layers.py``.  The weights keep
the JAX layouts: ``w: (in, out)`` so that ``y = x @ w + b``, and the SE
block's 1x1 convs HWIO (``fc1_w`` (1, 1, C, S), ``fc2_w`` (1, 1, S, C))."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..utils import initializers as init_lib
from ..utils.activations import relu, sigmoid
from .dropout import uniform


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


class DropPath(nn.Module):
    """Per-sample stochastic depth (the reference's DropPath,
    kan_efficientnet.py:31-50): in train mode each sample is kept with
    probability 1 - ``drop_prob``, as ``x / keep * mask``; an identity in
    eval mode or at ``drop_prob`` 0.  The (B, 1, .., 1) mask is U[0, 1) <
    keep, drawn from the forward's generator (None: the device's default
    one), as ``ops/dropout.py`` draws its masks."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, generator: torch.Generator = None):
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = (uniform(shape, x.device, generator) < keep).to(x.dtype)
        return x / keep * mask


class SqueezeExcitation(nn.Module):
    """torchvision.ops.SqueezeExcitation on NHWC: global average pool ->
    1x1 conv (fc1, bias) -> ``activation`` (ReLU) -> 1x1 conv (fc2, bias)
    -> ``scale_activation`` (sigmoid, as torchvision and the JAX module) ->
    times x; the 1x1 convs as matmuls, the init as torch's Conv2d
    (kaiming_uniform a=sqrt(5) over the HWIO fans, bias
    U(+-1/sqrt(fan_in)))."""

    def __init__(self, input_channels: int, squeeze_channels: int,
                 activation=relu, scale_activation=sigmoid, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        C, S = input_channels, squeeze_channels
        self.input_channels = C
        self.activation, self.scale_activation = activation, scale_activation
        self.fc1_w = nn.Parameter(torch.zeros(1, 1, C, S, dtype=dtype))
        self.fc1_b = nn.Parameter(torch.zeros(S, dtype=dtype))
        self.fc2_w = nn.Parameter(torch.zeros(1, 1, S, C, dtype=dtype))
        self.fc2_b = nn.Parameter(torch.zeros(C, dtype=dtype))
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: torch.Generator):
        ku = init_lib.kaiming_uniform("leaky_relu", a=math.sqrt(5.0),
                                      layout="conv_hwio")
        ku(self.fc1_w, generator)
        init_lib.torch_linear_bias(self.input_channels)(self.fc1_b, generator)
        ku(self.fc2_w, generator)
        init_lib.torch_linear_bias(self.fc1_b.numel())(self.fc2_b, generator)

    def forward(self, x):
        s = x.mean(dim=tuple(range(1, x.ndim - 1)), keepdim=True)
        s = self.activation(s @ self.fc1_w[0, 0] + self.fc1_b)
        s = self.scale_activation(s @ self.fc2_w[0, 0] + self.fc2_b)
        return x * s
