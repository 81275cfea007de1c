"""KAN dense layers, port of ``convkan_tpu/nn/kan_linear.py``: the 17
families of the reference's MLPs (models/kans.py imports them from
layers/*.py).

Every family is a matmul or an einsum over an expanded basis, outside any
Pallas kernel in the JAX package, so here too: ``torch.matmul`` and
``torch.einsum`` (cuBLAS on the card).  Parameters keep the JAX names,
shapes and layouts: linear weights (in, out) (``y = x @ w``), einsum
coefficients (in, out, K), Fourier's (2, out, in, G), Taylor's
(out, in, degree), WavKAN's (out, in); a layer's norm (flax's
``LayerNorm_0`` or ``BatchNorm_0``) is ``norm``, as ``utils/from_jax.py``
maps it.  Parameters are drawn on the CPU from ``generator`` (none: zeros,
for a caller that loads a state_dict next) and moved to ``device`` (None:
the GPU, raising without one).  ``forward(x, generator=None)``: the
generator draws ``KANLinear``'s segment-deactivation mask in train mode.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import nn

from ..basis.bspline import bspline_basis_unrolled_list, make_bspline_grid
from ..basis.poly import (bernstein_basis_list, bessel_basis_list,
                          chebyshev_basis, fibonacci_basis_list,
                          gegenbauer_basis_list, gram_basis,
                          hermite_basis_list, jacobi_basis_list,
                          laguerre_basis_list, legendre_basis_list,
                          lucas_basis_list)
from ..basis.rbf import make_rbf_grid, rbf_cols
from ..basis.relukan import default_phases, relukan_basis
from ..basis.wavelet import wavelet
from ..device import resolve_device
from ..ops.dropout import uniform
from ..utils import initializers as init_lib
from ..utils.activations import ACTIVATIONS, prelu, resolve_activation, silu
from ..utils.norms import BatchNorm, LayerNorm


def _resolve(act, default: str) -> Callable:
    """The layer's base activation: "__default__" is the family's, None
    (or "None") the identity."""
    if act == "__default__":
        return ACTIVATIONS[default]
    fn = resolve_activation(act)
    return fn if fn is not None else ACTIVATIONS["identity"]


def _stack(cols):
    return torch.stack(cols, dim=-1)


class _Dense(nn.Module):
    """Parameters registered with their init, drawn by ``reset_parameters``
    in registration order."""

    def __init__(self, dtype):
        super().__init__()
        self._inits = []
        self._dtype = dtype

    def _param(self, name: str, shape, init) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.zeros(shape, dtype=self._dtype)))
        self._inits.append((name, init))

    def _finish(self, generator, device):
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device=resolve_device(device), dtype=self._dtype)

    def reset_parameters(self, generator: torch.Generator):
        for name, init in self._inits:
            init(getattr(self, name), generator)


class KANLinear(_Dense):
    """B-spline dense layer (layers/kan_layers.py:8-114): base = act(x) @
    base_w, spline = flat bases @ spline_w, out = PReLU(LayerNorm(base +
    spline)).  With ``p_deactivate`` > 0, in train mode each (out, in)
    spline edge is replaced, with probability p, by the chord through the
    spline's values at the grid's ends (segment deactivation; the mask is
    U[0, 1) < p over (out, in), from the forward's generator)."""

    def __init__(self, input_dim: int, output_dim: int, grid_size: int = 5,
                 spline_order: int = 3, base_activation: Any = "__default__",
                 grid_range: Tuple[float, float] = (-1.0, 1.0),
                 grid_override=None, p_deactivate: float = 0.0, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.spline_order, self.p_deactivate = spline_order, p_deactivate
        self.act = _resolve(base_activation, "gelu")
        self.knots = np.asarray(
            make_bspline_grid(grid_size, spline_order, grid_range)
            if grid_override is None else grid_override, np.float32)
        K = len(self.knots) - spline_order - 1
        bound = math.sqrt(3.0 / (input_dim * K))
        self._param("base_w", (input_dim, output_dim),
                    init_lib.kaiming_uniform("linear", layout="linear_io"))
        self._param("spline_w", (input_dim * K, output_dim),
                    init_lib.uniform(-bound, bound))
        self._param("prelu", (), lambda t, g: t.data.fill_(0.25))
        self.norm = LayerNorm(output_dim)
        self._finish(generator, device)

    def _bases(self, x):
        return _stack(bspline_basis_unrolled_list(x, self.knots,
                                                  self.spline_order))

    def forward(self, x, generator: torch.Generator = None):
        bases = self._bases(x)                               # (B, in, K)
        if self.training and self.p_deactivate > 0:
            spline = self._segment_deactivated_spline(x, bases, generator)
        else:
            spline = bases.reshape(x.shape[0], -1) @ self.spline_w
        y = self.norm(self.act(x) @ self.base_w + spline)
        return prelu(y, self.prelu)

    def _segment_deactivated_spline(self, x, bases, generator):
        """Masked (out, in) edges add the chord a x + b through the
        spline's values at knots[order] and knots[-order-1]
        (utils/regularization.py:253-305 of the reference, vectorized)."""
        w = self.spline_w.reshape(self.input_dim, -1, self.output_dim)
        contrib = torch.einsum("bik,iko->bio", bases, w)
        xs = self.knots[self.spline_order]
        xe = self.knots[-self.spline_order - 1]
        ends = torch.tensor([float(xs), float(xe)], dtype=x.dtype,
                            device=x.device)[:, None].expand(
                                2, self.input_dim)
        y_ends = torch.einsum("eik,iko->eio", self._bases(ends), w)
        dx = float(xe - xs)      # the float32 knots' difference
        a = torch.zeros_like(y_ends[0]) if abs(dx) < 1e-8 else \
            (y_ends[1] - y_ends[0]) / dx
        b = y_ends[0] - a * float(xs)
        linear = a[None] * x[..., None] + b[None]
        mask = uniform((self.output_dim, self.input_dim), x.device,
                       generator) < self.p_deactivate
        return torch.where(mask.T[None], linear, contrib).sum(dim=1)


class FastKANLinear(_Dense):
    """RBF dense layer (layers/fast_kan_layers.py:5-33): the Gaussian
    RBFs of LayerNorm(x) @ spline_w, plus act(x) @ base_w + base_b with
    ``use_base_update``; ``time_benchmark`` skips the input norm."""

    def __init__(self, input_dim: int, output_dim: int,
                 grid_min: float = -2.0, grid_max: float = 2.0,
                 num_grids: int = 8, use_base_update: bool = True,
                 base_activation: Any = "__default__",
                 spline_weight_init_scale: float = 0.1, grid_override=None,
                 *, generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.use_base_update = use_base_update
        self.act = _resolve(base_activation, "silu")
        self.grid = np.asarray(make_rbf_grid(grid_min, grid_max, num_grids)
                               if grid_override is None else grid_override)
        self.denominator = (grid_max - grid_min) / (num_grids - 1)
        self.norm = LayerNorm(input_dim)
        self._param("spline_w", (input_dim * num_grids, output_dim),
                    init_lib.trunc_normal(0.0, spline_weight_init_scale))
        if use_base_update:
            self._param("base_w", (input_dim, output_dim),
                        init_lib.kaiming_uniform("leaky_relu",
                                                 a=math.sqrt(5.0),
                                                 layout="linear_io"))
            self._param("base_b", (output_dim,),
                        init_lib.torch_linear_bias(input_dim))
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None,
                time_benchmark: bool = False):
        xn = x if time_benchmark else self.norm(x)
        basis = _stack(rbf_cols(xn, self.grid, self.denominator))
        y = basis.reshape(x.shape[0], -1) @ self.spline_w
        if self.use_base_update:
            y = y + self.act(x) @ self.base_w + self.base_b
        return y


class ChebyKANLinear(_Dense):
    """Chebyshev dense layer (layers/cheby_kan_layers.py:5-38): the trig
    form of T_n(clamp(tanh x)) contracted with coeffs, no base path, no
    norm."""

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 epsilon: float = 1e-7, *, generator: torch.Generator = None,
                 device=None, dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.degree, self.epsilon = input_dim, degree, epsilon
        self._param("coeffs", (input_dim, output_dim, degree + 1),
                    init_lib.normal(0.0, 1.0 / (input_dim * (degree + 1))))
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        x = x.reshape(-1, self.input_dim)
        basis = chebyshev_basis(x, self.degree, self.epsilon)
        return torch.einsum("bid,iod->bo", basis, self.coeffs)


class LegendreKANLinear(_Dense):
    """Legendre dense layer (layers/legendre_kan_layers.py:8-51): the
    batch's min-max squash to [-1, 1], base + polynomial path,
    act(LayerNorm(.))."""

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 base_activation: Any = "__default__", *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.degree = degree
        self.act = _resolve(base_activation, "silu")
        bound = math.sqrt(3.0 / (input_dim * (degree + 1)))
        self._param("base_w", (input_dim, output_dim),
                    init_lib.kaiming_uniform("linear", layout="linear_io"))
        self._param("poly_w", (input_dim * (degree + 1), output_dim),
                    init_lib.uniform(-bound, bound))
        self.norm = LayerNorm(output_dim)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        base = self.act(x) @ self.base_w
        xn = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
        basis = _stack(legendre_basis_list(xn, self.degree))
        poly = basis.reshape(x.shape[0], -1) @ self.poly_w
        return self.act(self.norm(base + poly))


class GRAMKANLinear(_Dense):
    """Gram dense layer (layers/gram_kan_layers.py:9-84): act of the Gram
    polynomials of tanh x (learnable ``beta_weights``) contracted with
    coeffs, plus act(x) @ base_w, then act(LayerNorm(.))."""

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 base_activation: Any = "__default__", *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.degree = degree
        self.act = _resolve(base_activation, "silu")
        fan_in, fan_out = output_dim * (degree + 1), input_dim * (degree + 1)
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self._param("base_w", (input_dim, output_dim),
                    init_lib.xavier_uniform(layout="linear_io"))
        self._param("coeffs", (input_dim, output_dim, degree + 1),
                    init_lib.uniform(-bound, bound))
        self._param("beta_weights", (degree + 1,),
                    init_lib.normal(0.0, 1.0 / (input_dim * (degree + 1.0))))
        self.norm = LayerNorm(output_dim)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        base = self.act(x) @ self.base_w
        gb = self.act(gram_basis(torch.tanh(x), self.degree,
                                 self.beta_weights))
        y = torch.einsum("bld,lod->bo", gb, self.coeffs)
        return self.act(self.norm(y + base))


class _SquashedKanLinear(_Dense):
    """Jacobi (layers/jacobi_kan_layers.py:10-56) and Bernstein
    (layers/bersnstein_kan_layers.py:8-62): the basis of a squashed x
    contracted with coeffs, plus act(x) @ base_w, then act(LayerNorm(.))."""

    default_act = "silu"

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 base_activation: Any = "__default__", *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.degree = input_dim, degree
        self.act = _resolve(base_activation, self.default_act)
        self._param("base_w", (input_dim, output_dim),
                    init_lib.xavier_uniform(layout="linear_io"))
        self._param("coeffs", (input_dim, output_dim, degree + 1),
                    init_lib.normal(0.0, 1.0 / (input_dim * (degree + 1))))
        self.norm = LayerNorm(output_dim)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        x = x.reshape(-1, self.input_dim)
        base = self.act(x) @ self.base_w
        y = torch.einsum("bid,iod->bo", self.basis(x), self.coeffs)
        return self.act(self.norm(y + base))


class JacobiKANLinear(_SquashedKanLinear):
    default_act = "gelu"

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 a: float = 1.0, b: float = 1.0,
                 base_activation: Any = "__default__", **kw):
        super().__init__(input_dim, output_dim, degree, base_activation,
                         **kw)
        self.a, self.b = a, b

    def basis(self, x):
        return _stack(jacobi_basis_list(torch.tanh(x), self.degree, self.a,
                                        self.b))


class BersnsteinKANLinear(_SquashedKanLinear):
    def basis(self, x):
        return _stack(bernstein_basis_list(torch.sigmoid(x), self.degree))


_EINSUM_BASES = {
    "bessel": lambda t, d, alpha: bessel_basis_list(t, d),
    "fibonacci": lambda t, d, alpha: fibonacci_basis_list(t, d),
    "gegenbauer": gegenbauer_basis_list,
    "hermite": lambda t, d, alpha: hermite_basis_list(t, d),
    "laguerre": laguerre_basis_list,
    "lucas": lambda t, d, alpha: lucas_basis_list(t, d),
}


class _EinsumOnlyKanLinear(_Dense):
    """The einsum-only dense families: tanh squash, a recurrence basis,
    einsum('bid,iod->bo'), coeffs N(0, 1/(in*(d+1))).  Bessel (:8-37),
    Fibonacci (:8-39), Gegenbauer (:7-33, ``alpha`` its alpha_param),
    Hermite (:7-29), Laguerre (:7-37, ``alpha``), Lucas (:8-39)."""

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 family: str = "", alpha: float = 0.0, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        if family not in _EINSUM_BASES:
            raise ValueError(family)
        self.input_dim, self.degree = input_dim, degree
        self.family, self.alpha = family, alpha
        self._param("coeffs", (input_dim, output_dim, degree + 1),
                    init_lib.normal(0.0, 1.0 / (input_dim * (degree + 1))))
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        x = x.reshape(-1, self.input_dim)
        basis = _stack(_EINSUM_BASES[self.family](torch.tanh(x), self.degree,
                                                  self.alpha))
        return torch.einsum("bid,iod->bo", basis, self.coeffs)


def BesselKANLinear(input_dim, output_dim, degree=3, **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "bessel",
                                **kw)


def FibonacciKANLinear(input_dim, output_dim, degree=3, **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "fibonacci",
                                **kw)


def GegenbauerKANLinear(input_dim, output_dim, degree=3, alpha_param=0.0,
                        **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "gegenbauer",
                                alpha=alpha_param, **kw)


def HermiteKANLinear(input_dim, output_dim, degree=3, **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "hermite",
                                **kw)


def LaguerreKANLinear(input_dim, output_dim, degree=3, alpha=0.0, **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "laguerre",
                                alpha=alpha, **kw)


def LucasKANLinear(input_dim, output_dim, degree=3, **kw):
    return _EinsumOnlyKanLinear(input_dim, output_dim, degree, "lucas",
                                **kw)


class FourierKANLinear(_Dense):
    """Fourier dense layer (layers/fourier_kan_layers.py:7-66): cos and
    sin of k x, k = 1..G, contracted with coeffs (2, out, in, G), plus a
    bias (1, out) with ``add_bias``."""

    def __init__(self, input_dim: int, output_dim: int, grid_size: int = 3,
                 add_bias: bool = True, smooth_initialization: bool = False,
                 *, generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.grid_size, self.add_bias = grid_size, add_bias
        G = grid_size
        norm = (torch.arange(G, dtype=torch.float64) + 1.0) ** 2 \
            if smooth_initialization else torch.tensor(math.sqrt(G))

        def coeff_init(t, generator):
            with torch.no_grad():
                t.normal_(generator=generator)
                return t.div_((math.sqrt(input_dim) * norm).to(t.dtype))

        self._param("coeffs", (2, output_dim, input_dim, G), coeff_init)
        if add_bias:
            self._param("bias", (1, output_dim), init_lib.zeros)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        shape_in = x.shape
        x = x.reshape(-1, self.input_dim)
        k = torch.arange(1, self.grid_size + 1, dtype=x.dtype,
                         device=x.device)
        kx = x[..., None] * k                                 # (B, in, G)
        y = torch.einsum("big,oig->bo", torch.cos(kx), self.coeffs[0]) + \
            torch.einsum("big,oig->bo", torch.sin(kx), self.coeffs[1])
        if self.add_bias:
            y = y + self.bias
        return y.reshape(shape_in[:-1] + (self.output_dim,))


class TaylorKANLinear(_Dense):
    """Taylor dense layer (layers/taylor_kan_layers.py:7-38): the
    monomials x^0 .. x^(degree-1) of the raw input, coeffs
    (out, in, degree) N(0, 0.01), a bias (1, out) with ``add_bias``."""

    def __init__(self, input_dim: int, output_dim: int, degree: int = 3,
                 add_bias: bool = True, *, generator: torch.Generator = None,
                 device=None, dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.degree, self.add_bias = degree, add_bias
        self._param("coeffs", (output_dim, input_dim, degree),
                    init_lib.normal(0.0, 0.01))
        if add_bias:
            self._param("bias", (1, output_dim), init_lib.zeros)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        shape_in = x.shape
        x = x.reshape(-1, self.input_dim)
        y = torch.zeros(x.shape[0], self.output_dim, dtype=x.dtype,
                        device=x.device)
        xp = torch.ones_like(x)
        for i in range(self.degree):
            if i > 0:
                xp = xp * x
            y = y + xp @ self.coeffs[:, :, i].T
        if self.add_bias:
            y = y + self.bias
        return y.reshape(shape_in[:-1] + (self.output_dim,))


class ReLUKANLinear(_Dense):
    """ReLU-KAN dense layer (layers/relu_kan_layers.py:9-40): the squared
    ReLU windows of ``basis/relukan.py`` over g+k phases per input channel
    (learnable ``phase_low``/``phase_high`` with ``train_ab``, else the
    defaults as constants), then the reference's full-size Conv2d, which is
    a linear map of the flattened (in, g+k) basis: ``conv_w`` (in*(g+k),
    out), ``conv_b``, both U(+-1/sqrt(in*(g+k)))."""

    def __init__(self, input_dim: int, output_dim: int, g: int = 5,
                 k: int = 3, train_ab: bool = True, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.g, self.k = input_dim, g, k
        gk = g + k
        low0, high0 = default_phases(g, k)
        shape = (input_dim, gk)
        for name, v in (("phase_low", low0), ("phase_high", high0)):
            v = torch.from_numpy(v).expand(shape)
            if train_ab:
                self._param(name, shape,
                            lambda t, gen, v=v: t.data.copy_(v))
            else:
                self.register_buffer(name, v.to(dtype), persistent=False)
        bound = 1.0 / math.sqrt(gk * input_dim)
        self._param("conv_w", (input_dim * gk, output_dim),
                    init_lib.uniform(-bound, bound))
        self._param("conv_b", (output_dim,), init_lib.uniform(-bound, bound))
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        basis = relukan_basis(x, self.phase_low, self.phase_high, self.g,
                              self.k)
        return basis.reshape(x.shape[0], -1) @ self.conv_w + self.conv_b


class WavKANLinear(_Dense):
    """Wavelet dense layer (layers/wav_kan_layers.py:18-111): per (out, in)
    scale and translation, the weighted sum of psi((x - t) / s) over in,
    plus silu(x) @ base_w.T, then BatchNorm (running statistics in
    ``norm``)."""

    def __init__(self, input_dim: int, output_dim: int,
                 wavelet_type: str = "mexican_hat", *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__(dtype)
        self.input_dim, self.wavelet_type = input_dim, wavelet_type
        ku = init_lib.kaiming_uniform("leaky_relu", a=math.sqrt(5.0),
                                      layout="torch")
        shape = (output_dim, input_dim)
        self._param("scale", shape, init_lib.ones)
        self._param("translation", shape, init_lib.zeros)
        self._param("wavelet_w", shape, ku)
        self._param("base_w", shape, ku)
        self.norm = BatchNorm(output_dim)
        self._finish(generator, device)

    def forward(self, x, generator: torch.Generator = None):
        x2 = x.reshape(-1, self.input_dim)
        xs = (x2[:, None, :] - self.translation) / self.scale  # (B, out, in)
        psi = wavelet(xs, self.wavelet_type, channel_axis=2)
        y = (psi * self.wavelet_w).sum(dim=2) + silu(x2) @ self.base_w.T
        return self.norm(y)
