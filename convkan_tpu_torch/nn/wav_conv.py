"""WavKAN convolution, port of ``convkan_tpu/nn/wav_conv.py`` for 2-D,
groups 1, stride 1, dilation 1.

    y = Norm(mix(psi_conv(Dropout(x))) + conv(SiLU(x), base_w))

Norm is BatchNorm by default, as in JAX (``WavKANConv2DLayer`` too); the
factory's ``wavkan_conv`` defaults to InstanceNorm.

The base path reads x before the dropout; the dropout (train mode) drops
whole input channels of the wavelet path only.  ``psi_conv`` is
``kernels.wav_conv2d.wav_conv2d``: on CUDA the hand-written kernels, forward
and backward; on the CPU its plain version under autograd.  The 1x1 mix and
the base conv are plain PyTorch, as the JAX module leaves them to XLA.  The
reference's three engines ('base', 'fast', 'fast_plus_one') compute one
contraction, so ``wav_version`` is kept for API parity only.

Parameters keep the JAX names and shapes: ``base_w`` and ``wavelet_w``
(k,k,C,O) HWIO, ``scale`` and ``translation`` (1,O,C), ``wavelet_out_w``
(1,1,O,O).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..basis.wavelet import WAVELET_TYPES
from ..device import resolve_device
from ..kernels.wav_conv2d import wav_conv2d
from ..ops.conv import conv_nd
from ..ops.dropout import channel_dropout
from ..utils import initializers as init_lib
from ..utils.norms import BatchNorm, make_norm
from .kan_conv import _single

WAV_VERSIONS = ("fast", "base", "fast_plus_one")


class WavKANConvND(nn.Module):
    """WavKAN convolution (channel-last), 2-D, groups 1.

    Args mirror the JAX module: input_dim/output_dim, kernel_size, padding
    (stride, dilation and groups must stay 1), dropout (on the wavelet
    path's input, train mode), wavelet_type, wav_version, norm_layer.
    Parameters are drawn on the CPU from ``generator`` (so one seed gives
    the same weights on every device) and then moved to ``device``: None
    means the GPU, and raises without one."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size,
                 ndim: int = 2, groups: int = 1, padding=0, stride=1,
                 dilation=1, dropout: float = 0.0,
                 wavelet_type: str = "mexican_hat", wav_version: str = "fast",
                 norm_layer: Any = BatchNorm,
                 norm_kwargs: Optional[Mapping[str, Any]] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        config = (f"WavKANConvND(ndim={ndim}, groups={groups}, "
                  f"stride={stride}, dilation={dilation})")
        if ndim != 2 or groups != 1 or _single(stride, "stride") != 1 or \
                _single(dilation, "dilation") != 1:
            raise NotImplementedError(f"{config} is not ported")
        if wavelet_type not in WAVELET_TYPES:
            raise ValueError(f"Unsupported wavelet type: {wavelet_type}")
        if wav_version not in WAV_VERSIONS:
            raise ValueError(f"unknown wav_version {wav_version!r}")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.kernel_size = _single(kernel_size, "kernel_size")
        self.padding = _single(padding, "padding")
        self.dropout = dropout
        self.wavelet_type = wavelet_type
        self.wav_version = wav_version
        k, C, O = self.kernel_size, input_dim, output_dim

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=dtype))

        self.base_w = param(k, k, C, O)
        self.scale = param(1, O, C)
        self.translation = param(1, O, C)
        self.wavelet_w = param(k, k, C, O)
        self.wavelet_out_w = param(1, 1, O, O)
        self.norm = make_norm(norm_layer, O, **dict(norm_kwargs or {}))
        self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]):
        """JAX init: kaiming_uniform('linear') over HWIO fans for the three
        weights (drawn only when ``generator`` is given), scale 1,
        translation 0."""
        init_lib.ones(self.scale)
        init_lib.zeros(self.translation)
        if generator is None:
            return
        ku = init_lib.kaiming_uniform("linear", layout="conv_hwio")
        for p in (self.base_w, self.wavelet_w, self.wavelet_out_w):
            ku(p, generator)

    def forward(self, x, generator: torch.Generator = None):
        """``generator`` draws the channel-dropout mask in train mode (None:
        the device's default generator); eval mode ignores it."""
        if x.shape[-1] != self.input_dim:
            raise ValueError(f"expected {self.input_dim} channels (NHWC), "
                             f"got {tuple(x.shape)}")
        x = x.contiguous()
        base = conv_nd(torch.nn.functional.silu(x), self.base_w,
                       padding=self.padding)
        xw = x
        if self.training and self.dropout > 0:
            xw = channel_dropout(x, self.dropout, generator).contiguous()
        O, C = self.output_dim, self.input_dim
        y = wav_conv2d(xw, self.wavelet_w, self.translation.reshape(O, C),
                       self.scale.reshape(O, C),
                       wavelet_type=self.wavelet_type, padding=self.padding)
        y = torch.matmul(y, self.wavelet_out_w.reshape(O, O))
        return self.norm(y + base)


def WavKANConv2DLayer(input_dim, output_dim, kernel_size, **kwargs):
    """The JAX package's ``WavKANConv2DLayer``: a 2-D WavKANConvND (with
    its BatchNorm default)."""
    return WavKANConvND(input_dim, output_dim, kernel_size, ndim=2, **kwargs)
