"""Normalization for channel-last inputs, port of
``convkan_tpu/utils/norms.py``.

InstanceNorm: eps 1e-5, ``affine=False``, no running statistics; each
(sample, channel) is normalized over the spatial axes with the biased
variance, in training and evaluation alike.

BatchNorm: eps 1e-5, momentum 0.1, ``affine=True``, running statistics
(the buffers ``mean`` and ``var``, 0 and 1 at first).  In training each
channel is normalized over every other axis with the biased variance, and
the running statistics move towards the batch's mean and unbiased
variance (n / max(n - 1, 1), n = B * H * W: a single value per channel
moves ``var`` towards 0); in evaluation the running statistics normalize.

LayerNorm: eps 1e-5, over the last axis, ``elementwise_affine``.
RMSNorm: eps the dtype's machine epsilon unless given, over the last
axis, a weight only.  GroupNorm: ``num_groups`` 1 by default, eps 1e-5,
each (sample, group) over the spatial axes and the group's channels,
``affine``.  "None" builds no norm: ``make_norm`` returns ``Identity``.
``make_norm`` maps the reference's ``affine`` onto ``elementwise_affine``
where a norm takes that instead.
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


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the last axis (biased variance)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 elementwise_affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y if self.weight is None else y * self.weight + self.bias


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm for channel-last inputs (B, *S, C): C split into
    ``num_groups`` groups of consecutive channels."""

    def __init__(self, num_features: int, num_groups: int = 1,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_features} channels do not split into "
                             f"{num_groups} groups")
        self.num_features = num_features
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        g = self.num_groups
        xg = x.reshape(*x.shape[:-1], g, self.num_features // g)
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mean = xg.mean(dim=axes, keepdim=True)
        var = (xg - mean).square().mean(dim=axes, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        return y if self.weight is None else y * self.weight + self.bias


class RMSNorm(nn.Module):
    """torch.nn.RMSNorm over the last axis: x / sqrt(mean(x^2) + eps),
    eps the input dtype's machine epsilon when None, then a weight."""

    def __init__(self, num_features: int, eps: Optional[float] = None,
                 elementwise_affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features)) \
            if elementwise_affine else None

    def forward(self, x):
        eps = torch.finfo(x.dtype).eps if self.eps is None else self.eps
        y = x / torch.sqrt(x.square().mean(dim=-1, keepdim=True) + eps)
        return y if self.weight is None else y * self.weight


class Identity(nn.Module):
    """No norm (the registry's "None")."""

    def __init__(self, num_features: int = 0):
        super().__init__()
        self.num_features = num_features

    def forward(self, x):
        return x


NORM_LAYERS: dict[str, Optional[type]] = {
    "BatchNorm1d": BatchNorm,
    "BatchNorm2d": BatchNorm,
    "BatchNorm3d": BatchNorm,
    "InstanceNorm1d": InstanceNorm,
    "InstanceNorm2d": InstanceNorm,
    "InstanceNorm3d": InstanceNorm,
    "GroupNorm": GroupNorm,
    "LayerNorm": LayerNorm,
    "RMSNorm": RMSNorm,
    "None": None,
    "Identity": Identity,
}


def resolve_norm(norm):
    """Accept a module class, a registry name, or None (no norm)."""
    if isinstance(norm, str):
        if norm not in NORM_LAYERS:
            raise NotImplementedError(f"norm layer {norm!r} is not ported yet")
        return NORM_LAYERS[norm]
    return norm


def make_norm(norm, num_features: int, **norm_kwargs):
    """Instantiate a norm class with signature-filtered kwargs (the
    reference's ``inspect.signature`` filtering; ``affine`` reaches a norm
    that takes ``elementwise_affine`` instead); None builds ``Identity``."""
    cls = resolve_norm(norm)
    if cls is None:
        return Identity(num_features)
    valid = inspect.signature(cls).parameters
    kwargs = {}
    for k, v in norm_kwargs.items():
        if k in valid:
            kwargs[k] = v
        elif k == "affine" and "elementwise_affine" in valid:
            kwargs["elementwise_affine"] = v
    return cls(num_features, **kwargs)
