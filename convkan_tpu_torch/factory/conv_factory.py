"""CONV_KAN_FACTORY, port of ``convkan_tpu/factory/conv_factory.py``:
every key but ``"ReLUKAN"``, with the reference signatures and 'same'
padding when ``padding`` is None; groups, stride and dilation reach the
conv.  Each function's ``norm_layer`` (a class or a registry name such as
"BatchNorm2d") and ``**norm_kwargs`` reach the conv's norm (FastKAN's
per-group input norms), as in the reference.  The reference's misspelled
``"BersnsteinKAN"`` is kept."""

from __future__ import annotations

from typing import Callable

from ..nn.kan_conv import KanConvND
from ..nn.wav_conv import WavKANConvND
from ..ops.conv import same_padding
from ..ops.std_conv import StdConvBlock
from ..utils.norms import BatchNorm, InstanceNorm, resolve_norm


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


def _poly_conv(family):
    """The reference's builder of a polynomial family (the JAX
    ``_poly_conv``): ``alpha_param``, ``alpha``, ``a``, ``b`` and
    ``grid_size`` in ``**extra`` reach the conv, the rest of it its norm.
    ``base_activation`` "__default__" is the family's (ChebyKAN has no base
    path: taken and not read, as in the reference)."""
    def builder(in_planes, out_planes, kernel_size, degree=3, groups=1,
                stride=1, dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                base_activation="__default__", norm_layer=InstanceNorm, *,
                generator=None, device=None, **extra):
        _no_l1(l1_decay)
        hyper = {key: extra.pop(key) for key in ("alpha_param", "alpha", "a",
                                                 "b", "grid_size")
                 if key in extra}
        return KanConvND(
            family=family, input_dim=in_planes, output_dim=out_planes,
            kernel_size=kernel_size, ndim=2, degree=degree, stride=stride,
            padding=_pad(padding, kernel_size, dilation), dilation=dilation,
            groups=groups, dropout=dropout, base_activation=base_activation,
            norm_layer=resolve_norm(norm_layer), norm_kwargs=extra,
            generator=generator, device=device, **hyper)

    builder.__name__ = f"{family}kan_conv"
    return builder


legendrekan_conv = _poly_conv("legendre")      # layers/kan_conv.py:120-156
gramkan_conv = _poly_conv("gram")              # :158-194
chebykan_conv = _poly_conv("cheby")            # :197-232
bersnsteinkan_conv = _poly_conv("bernstein")   # :319-352
besselkan_conv = _poly_conv("bessel")          # :354-388
fibonaccikan_conv = _poly_conv("fibonacci")    # :391-425
hermitekan_conv = _poly_conv("hermite")        # :502-536
lucaskan_conv = _poly_conv("lucas")            # :616-650
taylorkan_conv = _poly_conv("taylor")          # :692-724


def fourierkan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                    dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                    grid_size=3, base_activation="gelu",
                    norm_layer=InstanceNorm, *, generator=None, device=None,
                    **norm_kwargs):
    """layers/kan_conv.py:427-461: grid_size 3 by default for convs."""
    _no_l1(l1_decay)
    return KanConvND(
        family="fourier", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, grid_size=grid_size, stride=stride,
        padding=_pad(padding, kernel_size, dilation), dilation=dilation,
        groups=groups, dropout=dropout, base_activation=base_activation,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


def gegenbauerkan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                       dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                       degree=3, alpha_param=0.0, base_activation="gelu",
                       norm_layer=InstanceNorm, *, generator=None,
                       device=None, **norm_kwargs):
    """layers/kan_conv.py:464-500."""
    _no_l1(l1_decay)
    return KanConvND(
        family="gegenbauer", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, degree=degree,
        alpha_param=alpha_param, stride=stride,
        padding=_pad(padding, kernel_size, dilation), dilation=dilation,
        groups=groups, dropout=dropout, base_activation=base_activation,
        norm_layer=resolve_norm(norm_layer), norm_kwargs=norm_kwargs,
        generator=generator, device=device)


def jacobikan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                   dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                   degree=3, a=1.0, b=1.0, base_activation="gelu",
                   norm_layer=InstanceNorm, *, generator=None, device=None,
                   **norm_kwargs):
    """layers/kan_conv.py:538-576."""
    _no_l1(l1_decay)
    return KanConvND(
        family="jacobi", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, degree=degree, a=a, b=b,
        stride=stride, padding=_pad(padding, kernel_size, dilation),
        dilation=dilation, groups=groups, dropout=dropout,
        base_activation=base_activation, norm_layer=resolve_norm(norm_layer),
        norm_kwargs=norm_kwargs, generator=generator, device=device)


def laguerrekan_conv(in_planes, out_planes, kernel_size, groups=1, stride=1,
                     dilation=1, padding=None, l1_decay=0.0, dropout=0.0,
                     degree=3, alpha=1.0, base_activation="gelu",
                     norm_layer=InstanceNorm, *, generator=None, device=None,
                     **norm_kwargs):
    """layers/kan_conv.py:578-614."""
    _no_l1(l1_decay)
    return KanConvND(
        family="laguerre", input_dim=in_planes, output_dim=out_planes,
        kernel_size=kernel_size, ndim=2, degree=degree, alpha=alpha,
        stride=stride, padding=_pad(padding, kernel_size, dilation),
        dilation=dilation, groups=groups, dropout=dropout,
        base_activation=base_activation, norm_layer=resolve_norm(norm_layer),
        norm_kwargs=norm_kwargs, generator=generator, device=device)


def conv(in_planes, out_planes, kernel_size, groups=1, stride=1, dilation=1,
         padding=None, base_activation="gelu", norm_layer=BatchNorm,
         l1_decay=0.0, dropout=0.0, norm_kwargs=None, *, generator=None,
         device=None, **kwargs):
    """The standard Dropout -> Conv -> Norm -> Act block (layers/
    kan_conv.py:71-117); ``**kwargs`` are taken and dropped, as the
    reference's ``conv()`` drops them."""
    _no_l1(l1_decay)
    return StdConvBlock(
        in_planes, out_planes, kernel_size, groups=groups, stride=stride,
        dilation=dilation, padding=_pad(padding, kernel_size, dilation),
        base_activation=base_activation, norm_layer=resolve_norm(norm_layer),
        norm_kwargs=dict(norm_kwargs or {}), dropout=dropout,
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


# layers/kan_conv.py:726-745: every key of the JAX factory but "ReLUKAN"
CONV_KAN_FACTORY: dict[str, Callable] = {
    "KAN": kan_conv,
    "FastKAN": fastkan_conv,
    "LegendreKAN": legendrekan_conv,
    "GRAMKAN": gramkan_conv,
    "ChebyKAN": chebykan_conv,
    "WavKAN": wavkan_conv,
    "BersnsteinKAN": bersnsteinkan_conv,
    "BesselKAN": besselkan_conv,
    "FibonacciKAN": fibonaccikan_conv,
    "FourierKAN": fourierkan_conv,
    "GegenbauerKAN": gegenbauerkan_conv,
    "HermiteKAN": hermitekan_conv,
    "JacobiKAN": jacobikan_conv,
    "LaguerreKAN": laguerrekan_conv,
    "LucasKAN": lucaskan_conv,
    "TaylorKAN": taylorkan_conv,
    "conv": conv,
}
