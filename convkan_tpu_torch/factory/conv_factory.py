"""CONV_KAN_FACTORY, port of the ``"KAN"`` key of
``convkan_tpu/factory/conv_factory.py``: the reference signature with
'same' padding when ``padding`` is None."""

from __future__ import annotations

from typing import Callable

from ..nn.kan_conv import KanConvND
from ..ops.conv import same_padding
from ..utils.norms import InstanceNorm, resolve_norm


def kan_conv(in_planes, out_planes, kernel_size, spline_order=3, groups=1,
             stride=1, dilation=1, padding=None, grid_size=5,
             base_activation="gelu", grid_range=(-1, 1), l1_decay=0.0,
             dropout=0.0, norm_layer=InstanceNorm, *, generator=None,
             device=None, **norm_kwargs):
    """The reference's ``kan_conv`` builder.  ``l1_decay`` (a training
    regularizer) is not ported yet."""
    if l1_decay and l1_decay > 0:
        raise NotImplementedError("l1_decay > 0 is not ported")
    pad = same_padding(kernel_size, dilation) if padding is None else padding
    return KanConvND(
        family="kan", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, spline_order=spline_order,
        stride=stride, padding=pad, dilation=dilation, groups=groups,
        grid_size=grid_size, base_activation=base_activation,
        grid_range=tuple(grid_range), dropout=dropout,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


CONV_KAN_FACTORY: dict[str, Callable] = {"KAN": kan_conv}
