"""Normalization for channel-last inputs, port of the InstanceNorm and
BatchNorm parts of ``convkan_tpu/utils/norms.py``.

InstanceNorm: eps 1e-5, ``affine=False``, no running statistics; each
(sample, channel) is normalized over the spatial axes with the biased
variance, in training and evaluation alike.

BatchNorm: eps 1e-5, momentum 0.1, ``affine=True``, running statistics
(the buffers ``mean`` and ``var``, 0 and 1 at first).  In training each
channel is normalized over every other axis with the biased variance, and
the running statistics move towards the batch's mean and unbiased
variance (n / max(n - 1, 1), n = B * H * W: a single value per channel
moves ``var`` towards 0); in evaluation the running statistics normalize.
GroupNorm, LayerNorm, RMSNorm and "None" are not ported.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """torch.nn.InstanceNormNd numerics for channel-last inputs (B, *S, C)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = False):
        super().__init__()
        if affine:
            raise NotImplementedError(
                "InstanceNorm(affine=True) is not ported yet")
        self.num_features = num_features
        self.eps = eps

    def forward(self, x):
        axes = tuple(range(1, x.ndim - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps)


class BatchNorm(nn.Module):
    """torch.nn.BatchNormNd numerics for channel-last inputs (B, *S, C), with
    the JAX module's running-statistics update.  The normalization is
    ``torch.batch_norm`` over the (B, C, *S) view of x (channel-last in
    memory), so on CUDA it is PyTorch's kernel: the JAX package leaves
    BatchNorm to XLA, not to a Pallas kernel."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.track_running_stats = track_running_stats
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x):
        xc = x.movedim(-1, 1)
        batch = self.training or not self.track_running_stats
        if self.training and self.track_running_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(
                    x.reshape(-1, self.num_features), dim=0, correction=0)
                n = x.numel() / self.num_features
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * (var * (n / max(n - 1.0, 1.0))))
        y = torch.batch_norm(xc, self.weight, self.bias,
                             None if batch else self.mean,
                             None if batch else self.var, batch, 0.0,
                             self.eps, torch.backends.cudnn.enabled)
        return y.movedim(1, -1)


NORM_LAYERS: dict[str, Optional[type]] = {
    "BatchNorm1d": BatchNorm,
    "BatchNorm2d": BatchNorm,
    "BatchNorm3d": BatchNorm,
    "InstanceNorm1d": InstanceNorm,
    "InstanceNorm2d": InstanceNorm,
    "InstanceNorm3d": InstanceNorm,
}


def resolve_norm(norm):
    """Accept a module class or a registry name."""
    if isinstance(norm, str):
        if norm not in NORM_LAYERS:
            raise NotImplementedError(f"norm layer {norm!r} is not ported yet")
        return NORM_LAYERS[norm]
    return norm


def make_norm(norm, num_features: int, **norm_kwargs):
    """Instantiate a norm class with signature-filtered kwargs (the
    reference's ``inspect.signature`` filtering)."""
    cls = resolve_norm(norm)
    valid = inspect.signature(cls).parameters
    kwargs = {k: v for k, v in norm_kwargs.items() if k in valid}
    return cls(num_features, **kwargs)
