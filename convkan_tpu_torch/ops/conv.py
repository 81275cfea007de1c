"""Channel-last 2-D convolution, port of ``convkan_tpu/ops/conv.py``
(``conv_nd``, ``same_padding``) for what VGG needs."""

from __future__ import annotations

from typing import Tuple, Union

import torch.nn.functional as F

IntOrTuple = Union[int, Tuple[int, ...]]


def _to_tuple(v: IntOrTuple, ndim: int) -> Tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        if len(v) != ndim:
            raise ValueError(f"expected {ndim} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * ndim


def conv_nd(x, w, *, ndim: int = 2, stride: IntOrTuple = 1,
            padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
            groups: int = 1):
    """x: (B, H, W, Cin) NHWC; w: (kh, kw, Cin//groups, Cout) HWIO.
    Symmetric zero padding, torch Conv semantics.  Returns NHWC."""
    if ndim != 2:
        raise NotImplementedError("only 2-D convolutions are ported")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=_to_tuple(stride, 2), padding=_to_tuple(padding, 2),
                 dilation=_to_tuple(dilation, 2), groups=groups)
    return y.permute(0, 2, 3, 1)


def same_padding(kernel_size: IntOrTuple, dilation: IntOrTuple, ndim: int = 2):
    """'same' padding for stride 1 (the reference's
    ``_calculate_same_padding``)."""
    k = _to_tuple(kernel_size, ndim)
    d = _to_tuple(dilation, ndim)
    pads = tuple((dd * (kk - 1)) // 2 for kk, dd in zip(k, d))
    if all(p == pads[0] for p in pads):
        return pads[0]
    return pads
