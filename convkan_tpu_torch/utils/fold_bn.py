"""Inference-time BatchNorm folding, port of ``convkan_tpu/utils/fold_bn.py``
for the port's convs.

A deployment transform on a trained model: every ``KanConvND`` whose output
norm is a BatchNorm has the norm's scale ``weight / sqrt(var + eps)``
multiplied into ``poly_w`` and ``base_w`` along the output channel (the
norm sits directly on the sum of the two convs, both linear in their
weights, so scaling both is exact), and the norm becomes a shift: weight
1, mean scale * mean, var v with ``v + eps == 1`` exactly in the buffer's
dtype, so its ``1 / sqrt(var + eps)`` is exactly 1.  What follows the norm
(PReLU, SiLU) stays where it is.  Every other module is left as it is,
WavKAN convs included, as in the JAX package.  The folded weights go
through the same kernels as any other.

All BatchNorms must share one ``eps``: passing the wrong one folds the
wrong scale.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.kan_conv import KanConvND
from .norms import BatchNorm

__all__ = ["fold_batch_norms"]


def _var_for_exact_unit_sqrt(eps: float, dtype: torch.dtype) -> float:
    """v of ``dtype`` such that v + eps == 1.0 bit-exactly in ``dtype``."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    one, e = np_dtype(1.0), np_dtype(eps)
    v = one - e
    for _ in range(8):
        s = np_dtype(v + e)
        if s == one:
            return float(v)
        v = np.nextafter(v, np_dtype(1.0 if s < one else 0.0))
    raise ValueError(f"could not construct exact-unit variance for eps={eps}")


@torch.no_grad()
def fold_batch_norms(model: nn.Module, eps: float = 1e-5) -> int:
    """Fold, in place, the BatchNorm of every ``KanConvND`` in ``model``
    into its weights; returns the number of norms folded.  ``eps`` must be
    the models' BatchNorm eps."""
    n = 0
    for conv in model.modules():
        if not isinstance(conv, KanConvND) or \
                not isinstance(conv.norm, BatchNorm):
            continue
        bn = conv.norm
        scale = (1.0 if bn.weight is None else bn.weight) / \
            torch.sqrt(bn.var + eps)
        if bn.weight is not None:
            bn.weight.fill_(1.0)
        for w in (conv.poly_w, conv.base_w):
            if w is not None:
                w.mul_(scale)
        bn.mean.mul_(scale)
        bn.var.fill_(_var_for_exact_unit_sqrt(eps, bn.var.dtype))
        n += 1
    return n
