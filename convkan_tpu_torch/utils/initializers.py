"""PyTorch-parity initializers for the port's HWIO / (in, out) layouts,
port of the parts of ``convkan_tpu/utils/initializers.py`` that serving
with fresh weights needs (and the ``ku_5d`` and ``normal_full`` rules of
its KanConvND).  Every initializer draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _fans(shape: Sequence[int], layout: str):
    if layout == "conv_hwio":
        receptive = math.prod(int(s) for s in shape[:-2])
        return int(shape[-2]) * receptive, int(shape[-1]) * receptive
    if layout == "linear_io":
        return int(shape[0]), int(shape[1])
    if layout == "torch":        # (out, in, *kernel)
        receptive = math.prod(int(s) for s in shape[2:])
        return int(shape[1]) * receptive, int(shape[0]) * receptive
    raise ValueError(f"unknown layout {layout!r}")


def _gain(nonlinearity: str, a=None) -> float:
    if nonlinearity == "linear":
        return 1.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        neg = 0.01 if a is None else a
        return math.sqrt(2.0 / (1.0 + neg ** 2))
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill ``t`` in place with U(-bound, bound) drawn from ``generator``."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def kaiming_uniform(nonlinearity: str = "linear", a=None,
                    layout: str = "conv_hwio"):
    """torch.nn.init.kaiming_uniform_ (fan_in): U(±sqrt(3)·gain/sqrt(fan))."""
    g = _gain(nonlinearity, a)

    def init(t: torch.Tensor, generator: torch.Generator):
        fan_in, _ = _fans(t.shape, layout)
        return uniform_(t, math.sqrt(3.0) * g / math.sqrt(fan_in), generator)

    return init


def kaiming_normal(nonlinearity: str = "relu", a=None,
                   layout: str = "conv_hwio"):
    """torch.nn.init.kaiming_normal_ (fan_in): N(0, gain/sqrt(fan))."""
    g = _gain(nonlinearity, a)

    def init(t: torch.Tensor, generator: torch.Generator):
        fan_in, _ = _fans(t.shape, layout)
        with torch.no_grad():
            return t.normal_(0.0, g / math.sqrt(fan_in), generator=generator)

    return init


def uniform(minval: float, maxval: float):
    """U(minval, maxval) (the JAX ``uniform``)."""
    def init(t: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            return t.uniform_(minval, maxval, generator=generator)

    return init


def normal(mean: float = 0.0, std: float = 1.0):
    """N(mean, std) (the JAX ``normal``)."""
    def init(t: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            return t.normal_(mean, std, generator=generator)

    return init


def xavier_uniform(gain: float = 1.0, layout: str = "conv_hwio"):
    """torch.nn.init.xavier_uniform_: U(±gain·sqrt(6/(fan_in + fan_out)))."""
    def init(t: torch.Tensor, generator: torch.Generator):
        fan_in, fan_out = _fans(t.shape, layout)
        return uniform_(t, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                        generator)

    return init


def trunc_normal(mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
    """torch.nn.init.trunc_normal_: N(mean, std) truncated at the absolute
    bounds [a, b]."""
    def init(t: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            return torch.nn.init.trunc_normal_(t, mean, std, a, b,
                                               generator=generator)

    return init


def ku_5d(fan_in: int):
    """The JAX KanConvND's "ku_5d" poly_w init: kaiming_uniform over the
    reference's one 5-D tensor (groups, out_g, in_g*K, *kernel), whose
    fan_in is out_g * in_g*K * prod(kernel): U(+-sqrt(3 / fan_in))
    (legendre_kan_layers.py:99-108)."""
    bound = math.sqrt(3.0 / fan_in)
    return uniform(-bound, bound)


def normal_full(input_dim: int, degree: int, kprod: int):
    """The JAX KanConvND's "normal_full" poly_w init (Jacobi): N(0, std)
    with std = 1 / (input_dim * (degree + 1) * prod(kernel)) over the FULL
    input_dim, whatever the groups (jacobi_kan_layers.py:115)."""
    return normal(0.0, 1.0 / (input_dim * (degree + 1) * kprod))


def zeros(t: torch.Tensor, generator: torch.Generator = None):
    """Fill ``t`` with 0 (draws nothing)."""
    with torch.no_grad():
        return t.zero_()


def ones(t: torch.Tensor, generator: torch.Generator = None):
    """Fill ``t`` with 1 (draws nothing)."""
    with torch.no_grad():
        return t.fill_(1.0)


def torch_linear_bias(fan_in: int):
    """torch Linear/Conv default bias init: U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def init(t: torch.Tensor, generator: torch.Generator):
        return uniform_(t, bound, generator)

    return init
