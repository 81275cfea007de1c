"""Shared builder plumbing for the model zoo, port of
``convkan_tpu/models/common.py``: the signature-filtered KAN conv factory
of ``conv_type="kanconv"``, and ``_Scoped``, which names submodules as
flax names them.  The models build the standard Conv->Norm->Act
blocks of ``conv_type="conv"`` themselves (``ops/std_conv.py``).  The KAN
classifier heads (and the ``classifier_*`` overrides that shape them) need
``nn/kan_linear.py``, which is not ported yet."""

from __future__ import annotations

from functools import partial
from inspect import signature
from typing import Callable

from torch import nn

from ..factory.conv_factory import CONV_KAN_FACTORY
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
