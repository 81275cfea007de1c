"""Normalization for channel-last inputs, port of the InstanceNorm part of
``convkan_tpu/utils/norms.py``.

InstanceNorm: eps 1e-5, ``affine=False``, no running statistics; each
(sample, channel) is normalized over the spatial axes with the biased
variance, in training and evaluation alike.
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


NORM_LAYERS: dict[str, Optional[type]] = {
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
