"""CONV_KAN_FACTORY, port of the ``"KAN"``, ``"FastKAN"``, ``"ChebyKAN"``,
``"GRAMKAN"`` and ``"WavKAN"`` keys of
``convkan_tpu/factory/conv_factory.py``: the reference signatures with
'same' padding when ``padding`` is None; groups, stride and dilation reach
the conv.  Each function's ``norm_layer`` (a class or a registry name such
as "BatchNorm2d") and ``**norm_kwargs`` reach the conv's norm (FastKAN's
per-group input norms), as in the reference."""

from __future__ import annotations

from typing import Callable

from ..nn.kan_conv import KanConvND
from ..nn.wav_conv import WavKANConvND
from ..ops.conv import same_padding
from ..utils.norms import InstanceNorm, resolve_norm


def _pad(padding, kernel_size, dilation):
    return same_padding(kernel_size, dilation) if padding is None else padding


def _no_l1(l1_decay):
    if l1_decay and l1_decay > 0:
        raise NotImplementedError("l1_decay > 0 is not ported")


def kan_conv(in_planes, out_planes, kernel_size, spline_order=3, groups=1,
             stride=1, dilation=1, padding=None, grid_size=5,
             base_activation="gelu", grid_range=(-1, 1), l1_decay=0.0,
             dropout=0.0, norm_layer=InstanceNorm, *, generator=None,
             device=None, **norm_kwargs):
    """The reference's ``kan_conv`` builder.  ``l1_decay`` (a training
    regularizer) is not ported yet."""
    _no_l1(l1_decay)
    return KanConvND(
        family="kan", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, spline_order=spline_order,
        stride=stride, padding=_pad(padding, kernel_size, dilation),
        dilation=dilation, groups=groups, grid_size=grid_size,
        base_activation=base_activation, grid_range=tuple(grid_range),
        dropout=dropout, norm_layer=resolve_norm(norm_layer),
        norm_kwargs=norm_kwargs, generator=generator, device=device)


def fastkan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                 dilation=1, padding=None, grid_size=8,
                 base_activation="silu", grid_range=(-2, 2), l1_decay=0.0,
                 dropout=0.0, norm_layer=InstanceNorm, *, generator=None,
                 device=None, **norm_kwargs):
    """The reference's ``fastkan_conv`` builder (grid 8 over (-2, 2) by
    default)."""
    _no_l1(l1_decay)
    return KanConvND(
        family="fastkan", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, stride=stride,
        padding=_pad(padding, kernel_size, dilation), dilation=dilation,
        groups=groups, grid_size=grid_size, base_activation=base_activation,
        grid_range=tuple(grid_range), dropout=dropout,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


def chebykan_conv(in_planes, out_planes, kernel_size, degree=3, groups=1,
                  stride=1, dilation=1, padding=None, l1_decay=0.0,
                  dropout=0.0, base_activation="__default__",
                  norm_layer=InstanceNorm, *, generator=None, device=None,
                  **norm_kwargs):
    """The reference's ``chebykan_conv`` builder (``_poly_conv("cheby")``).
    ChebyKAN has no base path, so ``base_activation`` is taken and not
    read, as in the reference."""
    _no_l1(l1_decay)
    return KanConvND(
        family="cheby", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, degree=degree, stride=stride,
        padding=_pad(padding, kernel_size, dilation), dilation=dilation,
        groups=groups, dropout=dropout, norm_layer=resolve_norm(norm_layer),
        norm_kwargs=norm_kwargs, generator=generator, device=device)


def gramkan_conv(in_planes, out_planes, kernel_size, degree=3, groups=1,
                 stride=1, dilation=1, padding=None, l1_decay=0.0,
                 dropout=0.0, base_activation="__default__",
                 norm_layer=InstanceNorm, *, generator=None, device=None,
                 **norm_kwargs):
    """The reference's ``gramkan_conv`` builder (``_poly_conv("gram")``):
    ``base_activation`` ("__default__": SiLU) acts on every basis row, the
    base path and the normed output."""
    _no_l1(l1_decay)
    return KanConvND(
        family="gram", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, degree=degree, stride=stride,
        padding=_pad(padding, kernel_size, dilation), dilation=dilation,
        groups=groups, dropout=dropout, base_activation=base_activation,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


def wavkan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                wavelet_type="mexican_hat", wav_version="fast",
                norm_layer=InstanceNorm, *, generator=None, device=None,
                **norm_kwargs):
    """The reference's ``wavkan_conv`` builder, with its InstanceNorm
    default (the bare layer class defaults to BatchNorm)."""
    _no_l1(l1_decay)
    return WavKANConvND(
        input_dim=in_planes, output_dim=out_planes, kernel_size=kernel_size,
        ndim=2, stride=stride, padding=_pad(padding, kernel_size, dilation),
        dilation=dilation, groups=groups, wavelet_type=wavelet_type,
        wav_version=wav_version, dropout=dropout,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


CONV_KAN_FACTORY: dict[str, Callable] = {"KAN": kan_conv,
                                         "FastKAN": fastkan_conv,
                                         "GRAMKAN": gramkan_conv,
                                         "ChebyKAN": chebykan_conv,
                                         "WavKAN": wavkan_conv}
