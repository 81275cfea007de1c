"""Stacked KAN MLPs, port of ``convkan_tpu/nn/mlp.py`` (the 17
``<Basis>KAN`` classes of the reference's models/kans.py:32-478).

Every stack has one pattern (models/kans.py:44-51): an optional first
dropout, a family layer per (in, out) pair, a dropout after every layer
but the last.  The layers are named as flax names them (``KANLinear_0``,
``_EinsumOnlyKanLinear_1``, ...).  The reference's L1 wrap (``l1_decay``
> 0, utils/regularization.py of the JAX package) is not ported: it
raises.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from ..models.common import _Scoped
from ..ops.dropout import dropout
from . import kan_linear as kl


def _build_layer(family: str, in_f: int, out_f: int, cfg: Mapping[str, Any],
                 **kw):
    """The layer of ``family`` from the factory's ``cfg``, with the JAX
    builder's defaults; ``kw``: generator, device, dtype."""
    c = dict(cfg)
    if family == "KAN":
        return kl.KANLinear(
            in_f, out_f, grid_size=c.get("grid_size", 5),
            spline_order=c.get("spline_order", 3),
            base_activation=c.get("base_activation", "__default__"),
            grid_range=tuple(c.get("grid_range", (-1.0, 1.0))),
            p_deactivate=c.get("p_deactivate", 0.0), **kw)
    if family == "FastKAN":
        gr = c.get("grid_range", (-2.0, 2.0))
        return kl.FastKANLinear(
            in_f, out_f, grid_min=gr[0], grid_max=gr[1],
            num_grids=c.get("grid_size", 8),
            use_base_update=c.get("use_base_update", True),
            base_activation=c.get("base_activation", "__default__"),
            spline_weight_init_scale=c.get("spline_weight_init_scale", 0.1),
            **kw)
    degree = c.get("degree", 3)
    act = c.get("base_activation", "__default__")
    if family == "ChebyKAN":
        return kl.ChebyKANLinear(in_f, out_f, degree=degree, **kw)
    if family == "LegendreKAN":
        return kl.LegendreKANLinear(in_f, out_f, degree=degree,
                                    base_activation=act, **kw)
    if family == "GRAMKAN":
        return kl.GRAMKANLinear(in_f, out_f, degree=degree,
                                base_activation=act, **kw)
    if family == "JacobiKAN":
        return kl.JacobiKANLinear(in_f, out_f, degree=degree,
                                  a=c.get("a", 1.0), b=c.get("b", 1.0),
                                  base_activation=act, **kw)
    if family == "BersnsteinKAN":
        return kl.BersnsteinKANLinear(in_f, out_f, degree=degree,
                                      base_activation=act, **kw)
    if family == "BesselKAN":
        return kl.BesselKANLinear(in_f, out_f, degree=degree, **kw)
    if family == "FibonacciKAN":
        return kl.FibonacciKANLinear(in_f, out_f, degree=degree, **kw)
    if family == "FourierKAN":
        return kl.FourierKANLinear(
            in_f, out_f, grid_size=c.get("grid_size", 3),
            add_bias=c.get("add_bias", True),
            smooth_initialization=c.get("smooth_initialization", False), **kw)
    if family == "GegenbauerKAN":
        return kl.GegenbauerKANLinear(in_f, out_f, degree=degree,
                                      alpha_param=c.get("alpha_param", 0.0),
                                      **kw)
    if family == "HermiteKAN":
        return kl.HermiteKANLinear(in_f, out_f, degree=degree, **kw)
    if family == "LaguerreKAN":
        return kl.LaguerreKANLinear(in_f, out_f, degree=degree,
                                    alpha=c.get("alpha", 0.0), **kw)
    if family == "LucasKAN":
        return kl.LucasKANLinear(in_f, out_f, degree=degree, **kw)
    if family == "ReLUKAN":
        return kl.ReLUKANLinear(in_f, out_f, g=c.get("g", 1),
                                k=c.get("k", 1),
                                train_ab=c.get("train_ab", True), **kw)
    if family == "TaylorKAN":
        return kl.TaylorKANLinear(in_f, out_f, degree=degree,
                                  add_bias=c.get("add_bias", False), **kw)
    if family == "WavKAN":
        return kl.WavKANLinear(
            in_f, out_f, wavelet_type=c.get("wavelet_type", "mexican_hat"),
            **kw)
    raise KeyError(family)


class KanMLP(_Scoped):
    """A stack of ``family`` layers over ``layers_hidden`` with the
    reference's dropout placement: before the first layer when
    ``first_dropout``, and after every layer but the last (train mode, the
    masks from the forward's generator in that order).  Inputs of more
    than two axes are flattened per sample."""

    def __init__(self, family: str, layers_hidden: Sequence[int],
                 dropout: float = 0.0, l1_decay: float = 0.0,
                 first_dropout: bool = True,
                 cfg: Mapping[str, Any] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if l1_decay > 0:
            raise NotImplementedError(
                "l1_decay > 0 (the reference's L1 wrap, "
                "utils/regularization.py) is not ported yet")
        self.family = family
        self.layers_hidden = tuple(int(v) for v in layers_hidden)
        self.dropout, self.first_dropout = dropout, first_dropout
        self.cfg = dict(cfg or {})
        self._plan = [self._scoped(_build_layer(
            family, i, o, self.cfg, generator=generator, device=device,
            dtype=dtype)) for i, o in zip(self.layers_hidden[:-1],
                                          self.layers_hidden[1:])]

    def forward(self, x, generator: torch.Generator = None):
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        drop = self.training and self.dropout > 0
        if drop and self.first_dropout:
            x = dropout(x, self.dropout, generator)
        for i, name in enumerate(self._plan):
            x = getattr(self, name)(x, generator)
            if drop and i != len(self._plan) - 1:
                x = dropout(x, self.dropout, generator)
        return x
