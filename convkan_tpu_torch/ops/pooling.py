"""Channel-last pooling, port of ``max_pool`` and ``adaptive_avg_pool`` of
``convkan_tpu/ops/pooling.py``."""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def max_pool(x, kernel_size: IntOr2, stride: IntOr2 = None):
    """torch.nn.MaxPool2d (no padding) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(kernel_size),
                     _pair(stride if stride is not None else kernel_size))
    return y.permute(0, 2, 3, 1)


def adaptive_avg_pool(x, output_size: IntOr2):
    """torch.nn.AdaptiveAvgPool2d on NHWC: bin b over a dim of size n
    covers [floor(b*n/o), ceil((b+1)*n/o))."""
    oh, ow = _pair(output_size)
    B, H, W, C = x.shape
    rows = []
    for hs, he in [(b * H // oh, -(-(b + 1) * H // oh)) for b in range(oh)]:
        cols = [x[:, hs:he, ws:we, :].mean(dim=(1, 2))
                for ws, we in [(b * W // ow, -(-(b + 1) * W // ow))
                               for b in range(ow)]]
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)
