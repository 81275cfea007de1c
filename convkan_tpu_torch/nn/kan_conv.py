"""KAN convolution, port of ``convkan_tpu/nn/kan_conv.py`` for the families
``kan`` (B-spline), ``cheby`` (Chebyshev) and ``gram`` (Gram), 2-D,
groups 1.

    kan:    y = ChannelDropout(PReLU(Norm(kan_conv2d(x))))
    cheby:  y = ChannelDropout(Norm(kan_conv2d(x)))   (dropout: train)
    gram:   y = SiLU(Norm(kan_conv2d(x)))  (E = [SiLU(p_n(tanh x)),
            SiLU(x)]; in train mode channel dropout of tanh x before the
            basis, as in JAX: the plain version only)

Norm is InstanceNorm by default, or BatchNorm (``norm_layer``), whose
running statistics move in train mode and normalize in eval mode.

``kan_conv2d`` (kernels/kan_conv2d.py) is the conv itself: the basis of
every input channel (plus act(x) where the family has a base path),
contracted with the weights over the k*k taps.  On CUDA its forward and
backward are the hand-written kernels; on the CPU its plain version under
autograd.  Parameters keep the JAX names and shapes: ``base_w`` (k,k,C,O)
HWIO (only with a base path), ``poly_w`` (k,k,C*K,O) with channel-major
rows c*K + kk (degree-major rows kk*C + c for ``gram``), ``prelu``
(groups,) (only where PReLU follows the norm), ``beta_weights``
(degree+1,) (``gram`` only: the recurrence's learnable operand).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ..basis.bspline import make_bspline_grid
from ..basis.poly import gram_basis_cols
from ..device import resolve_device
from ..kernels.kan_conv2d import (_conv_w_all, bspline_basis, cheby_basis,
                                  gram_basis, kan_conv2d, pack_w_all)
from ..ops.dropout import channel_dropout
from ..utils import initializers as init_lib
from ..utils.activations import ACTIVATIONS
from ..utils.norms import InstanceNorm, make_norm


@dataclasses.dataclass(frozen=True)
class ConvFamily:
    """The port's copy of the JAX ``ConvFamily`` fields that the ported
    families read: a base path or not, what follows the norm, where
    dropout acts, and the poly_w init (poly_w's row layout is the basis
    descriptor's ``degree_major``)."""

    name: str
    has_base: bool = True
    post: str = "prelu"             # 'prelu' | 'act' | 'none' after the norm
    dropout_site: str = "output"    # 'output' | 'basis_input' (tanh x)
    poly_init: str = "ku_linear"    # 'ku_linear' | 'kn_relu' | 'ku_5d'


# the ported entries of convkan_tpu/nn/kan_conv.py FAMILIES (layers/
# kan_layers.py:116-258, layers/cheby_kan_layers.py:39-111,
# layers/gram_kan_layers.py:85-199)
FAMILIES: dict[str, ConvFamily] = {
    "kan": ConvFamily("kan"),
    "cheby": ConvFamily("cheby", has_base=False, post="none",
                        poly_init="kn_relu"),
    "gram": ConvFamily("gram", post="act", dropout_site="basis_input",
                       poly_init="ku_5d"),
}


def _single(v, what: str) -> int:
    """A square/uniform int from an int or a tuple of equal ints."""
    if isinstance(v, (tuple, list)):
        if len(set(v)) != 1:
            raise NotImplementedError(f"non-uniform {what} {v} is not ported")
        v = v[0]
    return int(v)


def _act_name(act) -> str:
    """The registry name of a base activation given by name or function."""
    if isinstance(act, str):
        return act
    for name, fn in ACTIVATIONS.items():
        if fn is act:
            return name
    raise NotImplementedError(f"base activation {act!r} is not ported")


class KanConvND(nn.Module):
    """KAN convolution (channel-last), families ``kan``, ``cheby`` and
    ``gram``.

    Args mirror the JAX module: input_dim/output_dim, kernel_size, padding
    (stride, dilation and groups must stay 1), norm_layer, base_activation
    (read by ``kan`` and ``gram``; "__default__" is the family's: GELU for
    ``kan``, SiLU for ``gram``), the spline hyperparameters (``kan``; a
    ``grid_override`` knot vector replaces the uniform grid), ``degree``
    (``cheby``, ``gram``) and ``epsilon`` (``cheby``).
    Parameters are drawn on the CPU from ``generator`` (so one seed gives
    the same weights on every device) and then moved to ``device``: None
    means the GPU, and raises without one."""

    def __init__(self, family: str, input_dim: int, output_dim: int,
                 kernel_size, ndim: int = 2, groups: int = 1, padding=0,
                 stride=1, dilation=1, dropout: float = 0.0,
                 norm_layer: Any = InstanceNorm,
                 norm_kwargs: Optional[Mapping[str, Any]] = None,
                 base_activation: Any = "__default__", grid_size: int = 5,
                 spline_order: int = 3,
                 grid_range: Tuple[float, float] = (-1.0, 1.0),
                 degree: int = 3, epsilon: float = 1e-7,
                 grid_override: Optional[Tuple[float, ...]] = None, *,
                 generator: torch.Generator = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        config = (f"KanConvND(family={family!r}, ndim={ndim}, groups={groups},"
                  f" stride={stride}, dilation={dilation})")
        if family not in FAMILIES or ndim != 2 or groups != 1 or \
                _single(stride, "stride") != 1 or \
                _single(dilation, "dilation") != 1:
            raise NotImplementedError(f"{config} is not ported")
        self.family = family
        self.spec = FAMILIES[family]
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.kernel_size = _single(kernel_size, "kernel_size")
        self.padding = _single(padding, "padding")
        self.dropout = dropout  # channel dropout (spec.dropout_site), train
        if base_activation == "__default__":
            base_activation = "silu" if family == "gram" else "gelu"
        if family == "kan":
            knots = make_bspline_grid(grid_size, spline_order, grid_range) \
                if grid_override is None else grid_override
            self.basis = bspline_basis(knots, spline_order,
                                       _act_name(base_activation))
        elif family == "gram":
            self.basis = gram_basis(degree, _act_name(base_activation))
        else:
            self.basis = cheby_basis(degree, epsilon)
        K = self.basis.K
        self.num_basis = K
        k = self.kernel_size
        if self.spec.has_base:
            self.base_w = nn.Parameter(torch.zeros(k, k, input_dim,
                                                   output_dim, dtype=dtype))
        else:
            self.base_w = None
        self.poly_w = nn.Parameter(torch.zeros(k, k, input_dim * K, output_dim,
                                               dtype=dtype))
        if self.spec.post == "prelu":
            self.prelu = nn.Parameter(torch.full((groups,), 0.25,
                                                 dtype=dtype))
        if self.basis.n_extra:
            self.beta_weights = nn.Parameter(torch.zeros(
                self.basis.n_extra, dtype=dtype))
        else:
            self.beta_weights = None
        self.norm = make_norm(norm_layer, output_dim, **dict(norm_kwargs or {}))
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        """JAX init distributions over HWIO fans: kaiming_uniform('linear')
        for base_w and (``kan``) poly_w, kaiming_normal('relu') for
        (``cheby``) poly_w, ku_5d for (``gram``) poly_w (fan_in = O*C*K*k^2)
        and N(0, 1/(k^2*C*(degree+1))) for beta_weights; PReLU slope
        0.25."""
        ku = init_lib.kaiming_uniform("linear", layout="conv_hwio")
        k, C, K = self.kernel_size, self.input_dim, self.num_basis
        if self.base_w is not None:
            ku(self.base_w, generator)
        if self.spec.poly_init == "kn_relu":
            init_lib.kaiming_normal("relu", layout="conv_hwio")(self.poly_w,
                                                                generator)
        elif self.spec.poly_init == "ku_5d":
            init_lib.ku_5d(self.output_dim * C * K * k * k)(self.poly_w,
                                                             generator)
        else:
            ku(self.poly_w, generator)
        if self.beta_weights is not None:
            init_lib.normal(0.0, 1.0 / (k * k * C * (self.basis.order + 1.0)))(
                self.beta_weights, generator)
        if self.spec.post == "prelu":
            with torch.no_grad():
                self.prelu.fill_(0.25)

    def forward(self, x, generator: torch.Generator = None):
        """``generator`` draws the channel-dropout mask in train mode (None:
        the device's default generator); eval mode ignores it."""
        if x.shape[-1] != self.input_dim:
            raise ValueError(f"expected {self.input_dim} channels (NHWC), "
                             f"got {tuple(x.shape)}")
        drop = self.training and self.dropout > 0
        if drop and self.spec.dropout_site == "basis_input":
            y = self._basis_input_dropout_conv(x, generator)
        else:
            y = kan_conv2d(x.contiguous(), self.base_w, self.poly_w,
                           self.basis, self.kernel_size, self.padding,
                           self.beta_weights)
        y = self._post_combine(y)
        if drop and self.spec.dropout_site == "output":
            y = channel_dropout(y, self.dropout, generator)
        return y

    def _basis_input_dropout_conv(self, x, generator):
        """The conv with channel dropout of t = tanh x before the basis
        (the base path keeps x), as the JAX module's "basis_input" site.
        The kernels expand x itself, so this runs the plain version only:
        CUDA tensors raise (the JAX module leaves its Pallas kernels for
        XLA there)."""
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"{self.family} conv: channel dropout before the basis "
                f"(train mode, dropout {self.dropout}) is not carried by the "
                "kernels")
        act = ACTIVATIONS[self.basis.act]
        t = channel_dropout(torch.tanh(x), self.dropout, generator)
        cols = [act(p) for p in gram_basis_cols(t, self.basis.order,
                                                self.beta_weights)]
        E = torch.cat(cols + [act(x)], dim=-1)
        C, O, k = self.input_dim, self.output_dim, self.kernel_size
        w_all = pack_w_all(self.base_w, self.poly_w, C=C, K=self.num_basis,
                           k=k, O=O, degree_major=self.basis.degree_major)
        return _conv_w_all(E, w_all, k, self.padding)

    def _post_combine(self, y):
        """Norm, then (``spec.post``) PReLU with the per-group slope
        repeated per out_g, or the base activation."""
        y = self.norm(y)
        if self.spec.post == "none":
            return y
        if self.spec.post == "act":
            return ACTIVATIONS[self.basis.act](y)
        slope = self.prelu.repeat_interleave(self.output_dim // self.prelu.numel())
        return torch.where(y >= 0, y, slope * y)
