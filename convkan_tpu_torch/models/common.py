"""Shared builder plumbing for the model zoo, port of
``convkan_tpu/models/common.py``: the signature-filtered KAN conv factory
of ``conv_type="kanconv"``, the ``MLP_KAN_FACTORY`` partial of the KAN
classifier heads and the ``classifier_*`` overrides that shape them, and
``_Scoped``, which names submodules as flax names them.  The models build
the standard Conv->Norm->Act blocks of ``conv_type="conv"`` themselves
(``ops/std_conv.py``)."""

from __future__ import annotations

from functools import partial
from inspect import signature
from typing import Any, Callable, Mapping, Optional

from torch import nn

from ..factory.conv_factory import CONV_KAN_FACTORY
from ..ops.conv import same_padding
from ..ops.std_conv import StdConvBlock
from ..utils.norms import resolve_norm


def make_conv_factory(kan_conv: str, *, spline_order=3, grid_size=5,
                      base_activation="silu", grid_range=(-1, 1),
                      dropout=0.0, l1_decay=0.0, degree=3, norm_layer=None,
                      kan_norm_layer=None, affine=False, generator=None,
                      device=None, **extra) -> Callable:
    """fn(in_planes, out_planes, kernel_size=..., stride=..., groups=...,
    ...) building a KAN conv of the factory key ``kan_conv`` (a per-call
    ``activation`` is ignored, as the reference's signature filtering drops
    it), its weights drawn from ``generator`` onto ``device``.  Keys of
    ``extra`` that the builder does not name reach its norm (eps,
    momentum)."""
    if kan_conv not in CONV_KAN_FACTORY:
        raise NotImplementedError(f"kan_conv={kan_conv!r} is not ported; "
                                  f"only {sorted(CONV_KAN_FACTORY)} are")
    fn = CONV_KAN_FACTORY[kan_conv]
    args = {"spline_order": spline_order, "grid_size": grid_size,
            "base_activation": base_activation, "grid_range": grid_range,
            "dropout": dropout, "l1_decay": l1_decay,
            "norm_layer": resolve_norm(kan_norm_layer or norm_layer),
            "affine": affine, "degree": degree, **extra}
    valid = signature(fn).parameters
    has_kwargs = any(p.kind == p.VAR_KEYWORD for p in valid.values())
    part = partial(fn, generator=generator, device=device,
                   **{k: v for k, v in args.items()
                      if k in valid or has_kwargs})

    def kan_builder(in_planes, out_planes, activation="__ignored__", **kw):
        return part(in_planes, out_planes, **kw)

    return kan_builder


def make_std_conv_factory(norm_layer=None, affine=False,
                          std_activation="relu",
                          std_bias_when_not_affine=False, generator=None,
                          device=None) -> Callable:
    """fn(in_planes, out_planes, kernel_size, stride=1, padding=None,
    groups=1, dilation=1, activation=...) building the standard
    Conv -> Norm -> Act block of ``conv_type="conv"`` (the JAX factory's
    ``std_conv``): padding None is 'same', ``std_activation`` unless the
    call's ``activation`` says otherwise (None: no activation, MobileNetV2's
    linear projection), ``norm_layer`` with ``affine``, and with
    ``std_bias_when_not_affine`` MobileNetV2's conv bias whenever the norm
    is missing or not affine (kan_mobilenetv2.py:47,294)."""
    norm = resolve_norm(norm_layer)

    def std_conv(in_planes, out_planes, kernel_size, stride=1, padding=None,
                 groups=1, dilation=1, activation="__factory__"):
        return StdConvBlock(
            in_planes, out_planes, kernel_size, stride=stride,
            padding=same_padding(kernel_size, dilation) if padding is None
            else padding, dilation=dilation, groups=groups,
            base_activation=(std_activation if activation == "__factory__"
                             else activation),
            norm_layer=norm, norm_kwargs={"affine": affine},
            use_bias=(norm is None or not affine) if std_bias_when_not_affine
            else None, generator=generator, device=device)

    return std_conv


def make_mlp_classifier_factory(kan_classifier: Optional[str], *,
                                dropout=0.0, spline_order=3, grid_size=5,
                                base_activation=None, grid_range=(-1, 1),
                                l1_decay=0.0, degree=3, first_dropout=False,
                                **extra) -> Callable:
    """The ``MLP_KAN_FACTORY`` builder of ``kan_classifier`` (an unknown key
    or None: "KAN") with these keyword arguments, those that are None
    dropped (kan_alexnet.py:151-167); ``extra`` (generator, device, dtype)
    passes through."""
    from ..factory.mlp_factory import MLP_KAN_FACTORY

    fn = MLP_KAN_FACTORY[kan_classifier if kan_classifier in
                         MLP_KAN_FACTORY else "KAN"]
    args = {"dropout": dropout, "spline_order": spline_order,
            "grid_size": grid_size, "base_activation": base_activation,
            "grid_range": grid_range, "l1_decay": l1_decay,
            "degree": degree, "first_dropout": first_dropout, **extra}
    return partial(fn, **{k: v for k, v in args.items() if v is not None})


def resolve_classifier_overrides(prefix_args: Mapping[str, Any],
                                 **defaults) -> dict:
    """The ``classifier_*`` override rule: each ``classifier_X`` that is
    not None replaces X (kan_alexnet.py:143-149)."""
    out = {}
    for k, default in defaults.items():
        v = prefix_args.get(f"classifier_{k}")
        out[k] = v if v is not None else default
    return out


def pop_classifier_overrides(kwargs: dict) -> dict:
    """Take the ``classifier_*`` keys but ``classifier_type`` out of a
    builder's keyword arguments."""
    return {k: kwargs.pop(k) for k in list(kwargs)
            if k.startswith("classifier_") and k != "classifier_type"}


class _Scoped(nn.Module):
    """Names each submodule as flax names an unnamed child: its class name
    and the count of that class so far (``KanConvND_0``, ...)."""

    def _scoped(self, module: nn.Module) -> str:
        counts = self.__dict__.setdefault("_scope_counts", {})
        cls = type(module).__name__
        name = f"{cls}_{counts.get(cls, 0)}"
        counts[cls] = counts.get(cls, 0) + 1
        self.add_module(name, module)
        return name
