"""Standard (non-KAN) conv block, port of ``convkan_tpu/ops/std_conv.py``:
Dropout? -> Conv -> Norm -> Act, channel-last.

The conv is ``conv_nd`` (``F.conv2d``: cuDNN on the card, as XLA's conv in
the JAX package), grouped, strided and dilated; torch Conv2d's default init
(kaiming_uniform a=sqrt(5) for ``w`` (k, k, C/groups, O) HWIO, bias
U(+-1/sqrt(fan_in))); a bias only without a norm unless ``use_bias``
says otherwise.  Submodules keep flax's scope names: ``Conv_0`` and the
norm (flax's ``BatchNorm_0``) as ``norm``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..utils import initializers as init_lib
from ..utils.activations import resolve_activation
from ..utils.norms import make_norm, resolve_norm
from .conv import conv_nd
from .dropout import dropout as elementwise_dropout


class Conv(nn.Module):
    """Plain channel-last 2-D conv with torch's default init, drawn on the
    CPU from ``generator`` (none: zeros, for a caller that loads a
    state_dict next) and moved to ``device`` (None: the GPU)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 use_bias: bool = True, *, generator: torch.Generator = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if in_planes % groups or out_planes % groups:
            raise ValueError(f"{in_planes} -> {out_planes} channels do not "
                             f"split into {groups} groups")
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        k = kernel_size
        self.w = nn.Parameter(torch.zeros(k, k, in_planes // groups,
                                          out_planes, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(out_planes, dtype=dtype)) \
            if use_bias else None
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: torch.Generator):
        init_lib.kaiming_uniform("leaky_relu", a=math.sqrt(5.0),
                                 layout="conv_hwio")(self.w, generator)
        if self.b is not None:
            fan_in = self.w.shape[0] * self.w.shape[1] * self.w.shape[2]
            init_lib.torch_linear_bias(fan_in)(self.b, generator)

    def forward(self, x):
        y = conv_nd(x, self.w, stride=self.stride, padding=self.padding,
                    dilation=self.dilation, groups=self.groups)
        return y if self.b is None else y + self.b


class StdConvBlock(nn.Module):
    """Dropout (element-wise, train mode) -> Conv -> Norm -> Act; the
    reference's ``conv()`` block."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 groups: int = 1, stride=1, dilation=1, padding=0,
                 base_activation: Any = "gelu", norm_layer: Any = None,
                 norm_kwargs: Optional[Mapping[str, Any]] = None,
                 dropout: float = 0.0, use_bias: Optional[bool] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        norm_layer = resolve_norm(norm_layer)
        self.dropout = dropout
        bias = norm_layer is None if use_bias is None else use_bias
        self.Conv_0 = Conv(in_planes, out_planes, kernel_size, stride=stride,
                           padding=padding, dilation=dilation, groups=groups,
                           use_bias=bias, generator=generator, device=device,
                           dtype=dtype)
        self.norm = None if norm_layer is None else make_norm(
            norm_layer, out_planes, **dict(norm_kwargs or {}))
        self.act = resolve_activation(base_activation)
        self.to(device=device, dtype=dtype)

    def forward(self, x, generator: torch.Generator = None):
        if self.training and self.dropout > 0:
            x = elementwise_dropout(x, self.dropout, generator)
        y = self.Conv_0(x)
        if self.norm is not None:
            y = self.norm(y)
        return y if self.act is None else self.act(y)
