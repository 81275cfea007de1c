"""KAN convolution, port of ``convkan_tpu/nn/kan_conv.py`` for every
family but ReLU-KAN: ``kan`` (B-spline), ``fastkan`` (Gaussian RBF),
``cheby`` (Chebyshev), ``gram`` (Gram), the static polynomial bases
``jacobi``, ``bernstein``, ``bessel``, ``fibonacci``, ``gegenbauer``,
``hermite``, ``laguerre``, ``lucas``, ``taylor``, the Fourier features
(``fourier``) and ``legendre``, 2-D, with groups, stride and dilation.

    y = Drop_out(Post(Norm(conv(base_in) + conv(E(Drop_b(squash(x)))))))

squash: tanh (gram, the recurrences, taylor inside its basis), sigmoid
(bernstein), the batch min-max per group (legendre), none (kan, cheby,
whose clamp of tanh is its basis's, fourier); E: the family's basis (Gram
and its activation on every row); base_in: act(x), or x itself for
``base_input`` "raw" (jacobi, bernstein, legendre), none for cheby;
Post: PReLU (kan, fourier, and the recurrences but jacobi), the base
activation (gram, jacobi, bernstein, legendre) or nothing (cheby,
fastkan); channel dropout (train mode) at the output, before the basis
(``basis_input``: gram, bernstein, legendre; fastkan's ``rbf_input``) or
over the expanded rows (``basis``: jacobi).  FastKAN: y = conv(act(x)) +
conv(RBF(InputNorm_g(Drop(x)))), no output norm.

Norm is InstanceNorm by default, or any norm of ``utils/norms.py``
(``norm_layer``); BatchNorm's running statistics move in train mode and
normalize in eval mode.  FastKAN has no output norm: one norm of in_g
channels per group (``input_norm_{g}``) acts on its input.

Two routes compute the conv, chosen as the JAX package's Pallas gate
(``_maybe_fused``) chooses between its kernels and XLA
(``kernel_eligible``): a family the kernels carry (``FUSABLE``), 2-D,
stride 1, dilation 1, groups 1, a square kernel of at most 7, float32 and
no channel dropout before the output in train mode.  Such a conv runs
``kan_conv2d`` (kernels/kan_conv2d.py): on a CUDA tensor the hand-written
kernels, forward and backward, or a raise; on a CPU tensor their plain
version.  Every other conv takes the plain route (``_plain_conv``), the
counterpart of the JAX module's XLA path: the basis materialized per
group, a grouped ``conv_nd`` (cuDNN on the card) for the basis path and
one for the base path.  Each plain-route call adds one to
``kernels/kan_conv2d.py::plain_calls``.  Nothing falls back from one route
to the other.

Parameters keep the JAX names and shapes: ``base_w`` (k,k,in_g,O) HWIO
(only with a base path), ``poly_w`` (k,k,in_g*K,O) with rows per group
channel-major c*K + kk (degree-major kk*in_g + c for ``gram``, ``jacobi``
and ``legendre``), ``prelu`` (groups,) (only where PReLU follows the
norm), ``beta_weights`` (degree+1,) (``gram`` only: the recurrence's
learnable operand).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ..basis.bspline import make_bspline_grid
from ..basis.poly import RECUR3_FAMILIES, chebyshev_basis
from ..basis.rbf import make_rbf_grid, rbf_cols
from ..device import resolve_device
from ..kernels.kan_conv2d import (bernstein_basis, bspline_basis, cheby_basis,
                                  count_plain, fourier_basis, gram_basis,
                                  kan_conv2d, legendre_basis, recur3_basis)
from ..ops.conv import conv_nd
from ..ops.dropout import channel_dropout
from ..utils import initializers as init_lib
from ..utils.activations import ACTIVATIONS
from ..utils.norms import (InstanceNorm, LayerNorm, RMSNorm, make_norm,
                           resolve_norm)


@dataclasses.dataclass(frozen=True)
class ConvFamily:
    """The port's copy of the JAX ``ConvFamily`` fields: a base path or
    not, what the base path takes, the squash before the basis, what
    follows the norm, where the norm acts, where dropout acts, the poly_w
    init and poly_w's row layout within a group, and the default base
    activation."""

    name: str
    has_base: bool = True
    base_input: str = "act"         # 'act' (conv(act(x))) | 'raw' (conv(x))
    squash: str = "tanh"            # 'tanh'|'sigmoid'|'batch_minmax'|
    #                                 'intrinsic' (the basis's own, or none)
    post: str = "prelu"             # 'prelu' | 'act' | 'none' after the norm
    norm_on: str = "output"         # 'output' | 'input' (FastKAN)
    dropout_site: str = "output"    # 'output'|'basis_input'|'basis'|
    #                                 'rbf_input'
    poly_init: str = "ku_linear"    # 'ku_linear'|'kn_relu'|'ku_5d'|
    #                                 'normal_full'
    degree_major: bool = False      # rows kk*in_g + c instead of c*K + kk
    default_act: str = "gelu"


# the entries of convkan_tpu/nn/kan_conv.py FAMILIES but ReLU-KAN's, with
# their reference layers
FAMILIES: dict[str, ConvFamily] = {
    # layers/kan_layers.py:116-258
    "kan": ConvFamily("kan", squash="intrinsic"),
    # layers/fast_kan_layers.py:34-120
    "fastkan": ConvFamily("fastkan", squash="intrinsic", post="none",
                          norm_on="input", dropout_site="rbf_input",
                          default_act="silu"),
    # layers/cheby_kan_layers.py:39-111
    "cheby": ConvFamily("cheby", has_base=False, squash="intrinsic",
                        post="none", poly_init="kn_relu"),
    # layers/legendre_kan_layers.py:52-163
    "legendre": ConvFamily("legendre", base_input="raw",
                           squash="batch_minmax", post="act",
                           dropout_site="basis_input", poly_init="ku_5d",
                           degree_major=True, default_act="silu"),
    # layers/gram_kan_layers.py:85-199
    "gram": ConvFamily("gram", post="act", dropout_site="basis_input",
                       poly_init="ku_5d", degree_major=True,
                       default_act="silu"),
    # layers/jacobi_kan_layers.py:57-177 (the 2-D layer's GELU default)
    "jacobi": ConvFamily("jacobi", base_input="raw", post="act",
                         dropout_site="basis", poly_init="normal_full",
                         degree_major=True),
    # layers/bersnstein_kan_layers.py:63-179
    "bernstein": ConvFamily("bernstein", base_input="raw", squash="sigmoid",
                            post="act", dropout_site="basis_input",
                            poly_init="ku_5d", default_act="silu"),
    # layers/{bessel,fibonacci,gegenbauer,hermite,laguerre,lucas}_kan_layers
    **{f: ConvFamily(f) for f in ("bessel", "fibonacci", "gegenbauer",
                                  "hermite", "laguerre", "lucas")},
    # layers/fourier_kan_layers.py:67-212
    "fourier": ConvFamily("fourier", squash="intrinsic"),
    # layers/taylor_kan_layers.py:40-176: tanh inside the basis
    "taylor": ConvFamily("taylor", squash="intrinsic"),
}

# the families of the JAX module's _FUSABLE that the port has: the kernels
# carry their bases (FastKAN is not fusable: its input norm's statistics
# must leave out the zero pad; nor is Legendre: its squash is a min-max
# over the whole batch)
FUSABLE = frozenset({"kan", "cheby", "gram", "jacobi", "bernstein", "bessel",
                     "fibonacci", "fourier", "gegenbauer", "hermite",
                     "laguerre", "lucas", "taylor"})
MAX_KERNEL = 7


def _single(v, what: str) -> int:
    """A square/uniform int from an int or a tuple of equal ints."""
    if isinstance(v, (tuple, list)):
        if len(set(v)) != 1:
            raise NotImplementedError(f"non-uniform {what} {v} is not ported")
        v = v[0]
    return int(v)


def _act_name(act) -> str:
    """The registry name of a base activation given by name or function;
    None (and the CLI's "None") is "identity", the JAX module's ``lambda x:
    x`` base path."""
    if act is None or act == "None":
        return "identity"
    if isinstance(act, str):
        if act not in ACTIVATIONS:
            raise NotImplementedError(f"base activation {act!r} is not "
                                      "ported")
        return act
    for name, fn in ACTIVATIONS.items():
        if fn is act:
            return name
    raise NotImplementedError(f"base activation {act!r} is not ported")


def kernel_eligible(family: str, stride: int, dilation: int, groups: int,
                    k: int, pad: int, H: int, W: int, dtype=torch.float32,
                    pre_basis_dropout: bool = False) -> bool:
    """The JAX module's gate between its Pallas kernels and XLA
    (``_maybe_fused`` with ``supported`` / ``wide_supported``) for a 2-D
    conv of a k x k kernel, without the TPU's VMEM budget: a family in
    ``FUSABLE``, stride 1, dilation 1, groups 1, k <= ``MAX_KERNEL``, pad
    >= 0 and a non-empty output, float32, and no channel dropout at a site
    other than the output (train mode: before the basis or over its
    rows).  True: the conv runs ``kan_conv2d``; False:
    the plain route."""
    return (family in FUSABLE and groups == 1 and stride == 1
            and dilation == 1 and 0 < k <= MAX_KERNEL and pad >= 0
            and H + 2 * pad - k + 1 > 0 and W + 2 * pad - k + 1 > 0
            and dtype == torch.float32 and not pre_basis_dropout)


class KanConvND(nn.Module):
    """KAN convolution (channel-last), every family of ``FAMILIES``.

    Args mirror the JAX module: input_dim/output_dim, kernel_size, groups,
    padding, stride, dilation (each an int or a tuple of equal ints),
    dropout, norm_layer, base_activation (read by every family but
    ``cheby``; "__default__" is the family's: SiLU for ``fastkan``,
    ``gram``, ``bernstein`` and ``legendre``, GELU for the others; None the
    identity), grid_size / grid_range (``kan``, ``fastkan``: the RBF
    centres and their spacing; ``fourier``: its frequencies 1..grid_size),
    spline_order (``kan``), a ``grid_override`` knot or centre vector
    replacing the uniform grid, ``degree`` (the polynomial families),
    ``epsilon`` (``cheby``), ``alpha_param`` (``gegenbauer``), ``alpha``
    (``laguerre``) and ``a``, ``b`` (``jacobi``).
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
                 alpha_param: float = 0.0, alpha: float = 1.0,
                 a: float = 1.0, b: float = 1.0,
                 grid_override: Optional[Tuple[float, ...]] = None, *,
                 generator: torch.Generator = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if family not in FAMILIES or ndim != 2:
            raise NotImplementedError(
                f"KanConvND(family={family!r}, ndim={ndim}) is not ported")
        if groups <= 0 or input_dim % groups or output_dim % groups:
            raise ValueError(f"input_dim {input_dim} and output_dim "
                             f"{output_dim} must split into {groups} groups")
        self.family = family
        self.spec = FAMILIES[family]
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.groups = groups
        self.in_g, self.out_g = input_dim // groups, output_dim // groups
        self.kernel_size = _single(kernel_size, "kernel_size")
        self.padding = _single(padding, "padding")
        self.stride = _single(stride, "stride")
        self.dilation = _single(dilation, "dilation")
        self.dropout = dropout  # channel dropout (spec.dropout_site), train
        self.degree = degree
        # the base activation, where the family reads one
        self.act = None if family == "cheby" else _act_name(
            self.spec.default_act if base_activation == "__default__"
            else base_activation)
        # the base path's: x itself where it takes the raw input
        base_act = "identity" if self.spec.base_input == "raw" else self.act
        # the basis descriptor (the kernels', for FUSABLE families)
        if family == "kan":
            knots = make_bspline_grid(grid_size, spline_order, grid_range) \
                if grid_override is None else grid_override
            self.basis = bspline_basis(knots, spline_order, self.act)
        elif family == "gram":
            self.basis = gram_basis(degree, self.act)
        elif family == "cheby":
            self.basis = cheby_basis(degree, epsilon)
        elif family in RECUR3_FAMILIES:
            self.basis = recur3_basis(
                family, degree, base_act, a, b,
                alpha_param if family == "gegenbauer" else alpha)
        elif family == "bernstein":
            self.basis = bernstein_basis(degree)
        elif family == "fourier":
            self.basis = fourier_basis(grid_size, self.act)
        elif family == "legendre":
            self.basis = legendre_basis(degree)
        else:
            self.basis = None
            self.centers = tuple(float(v) for v in (
                make_rbf_grid(grid_range[0], grid_range[1], grid_size)
                if grid_override is None else grid_override))
            self.denominator = (grid_range[1] - grid_range[0]) / \
                (grid_size - 1)
        K = grid_size if family == "fastkan" else self.basis.K
        self.num_basis = K
        k = self.kernel_size
        if self.spec.has_base:
            self.base_w = nn.Parameter(torch.zeros(k, k, self.in_g,
                                                   output_dim, dtype=dtype))
        else:
            self.base_w = None
        self.poly_w = nn.Parameter(torch.zeros(k, k, self.in_g * K,
                                               output_dim, dtype=dtype))
        if self.spec.post == "prelu":
            self.prelu = nn.Parameter(torch.full((groups,), 0.25,
                                                 dtype=dtype))
        if family == "gram":
            self.beta_weights = nn.Parameter(torch.zeros(
                self.basis.n_extra, dtype=dtype))
        else:
            self.beta_weights = None
        norm_kwargs = dict(norm_kwargs or {})
        if self.spec.norm_on == "input":
            self.norm = None
            self.input_norm_cls = resolve_norm(norm_layer)
            for g in range(groups):
                self.add_module(f"input_norm_{g}", make_norm(
                    norm_layer, self.in_g, **norm_kwargs))
        else:
            self.norm = make_norm(norm_layer, output_dim, **norm_kwargs)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        """JAX init distributions over HWIO fans: kaiming_uniform('linear')
        for base_w and (``ku_linear``) poly_w, kaiming_normal('relu') for
        (``cheby``) poly_w, ku_5d for (``gram``, ``bernstein``,
        ``legendre``) poly_w (fan_in = out_g*in_g*K*k^2), normal_full for
        (``jacobi``) poly_w and N(0, 1/(k^2*C*(degree+1))) for beta_weights;
        PReLU slope 0.25."""
        ku = init_lib.kaiming_uniform("linear", layout="conv_hwio")
        k, C, K = self.kernel_size, self.input_dim, self.num_basis
        if self.base_w is not None:
            ku(self.base_w, generator)
        if self.spec.poly_init == "kn_relu":
            init_lib.kaiming_normal("relu", layout="conv_hwio")(self.poly_w,
                                                                generator)
        elif self.spec.poly_init == "ku_5d":
            init_lib.ku_5d(self.out_g * self.in_g * K * k * k)(self.poly_w,
                                                                generator)
        elif self.spec.poly_init == "normal_full":
            init_lib.normal_full(C, self.degree, k * k)(self.poly_w,
                                                         generator)
        else:
            ku(self.poly_w, generator)
        if self.beta_weights is not None:
            init_lib.normal(0.0, 1.0 / (k * k * C * (self.degree + 1.0)))(
                self.beta_weights, generator)
        if self.spec.post == "prelu":
            with torch.no_grad():
                self.prelu.fill_(0.25)

    def kernel_route(self, x) -> bool:
        """Whether this call runs ``kan_conv2d`` (``kernel_eligible``)."""
        return kernel_eligible(
            self.family, self.stride, self.dilation, self.groups,
            self.kernel_size, self.padding, x.shape[1], x.shape[2], x.dtype,
            self.training and self.dropout > 0 and
            self.spec.dropout_site != "output")

    def forward(self, x, generator: torch.Generator = None):
        """``generator`` draws the channel-dropout mask in train mode (None:
        the device's default generator); eval mode ignores it."""
        if x.shape[-1] != self.input_dim:
            raise ValueError(f"expected {self.input_dim} channels (NHWC), "
                             f"got {tuple(x.shape)}")
        if self.kernel_route(x):
            y = kan_conv2d(x.contiguous(), self.base_w, self.poly_w,
                              self.basis, self.kernel_size, self.padding,
                              self.beta_weights)
        else:
            y = self._plain_conv(x, generator)
        y = self._post_combine(y)
        if self.training and self.dropout > 0 and \
                self.spec.dropout_site == "output":
            y = channel_dropout(y, self.dropout, generator)
        return y

    def _conv(self, x, w):
        return conv_nd(x, w, stride=self.stride, padding=self.padding,
                       dilation=self.dilation, groups=self.groups)

    def _plain_conv(self, x, generator):
        """The plain route, the JAX module's XLA path: the base path's
        conv of act(x) (or x), plus the conv of the basis materialized per
        group (B, H, W, groups * in_g * K), each a grouped ``conv_nd``: the
        family's squash, its channel dropout before the basis or over the
        expanded rows (train mode), for FastKAN the input norms, then the
        basis (ChebyKAN's in the trig form of the JAX XLA path) and poly_w's
        row layout."""
        count_plain()
        drop = self.training and self.dropout > 0
        site = self.spec.dropout_site
        base = None
        if self.spec.has_base:
            base = self._conv(x if self.spec.base_input == "raw"
                              else ACTIVATIONS[self.act](x), self.base_w)
        if self.family == "fastkan":
            t = channel_dropout(x, self.dropout, generator) if drop else x
            cols = rbf_cols(self._input_norms(t), self.centers,
                            self.denominator)
        else:
            t = self._grouped_minmax(x) \
                if self.spec.squash == "batch_minmax" else x
            t = self.basis.squash(t)
            if drop and site == "basis_input":
                t = channel_dropout(t, self.dropout, generator)
            cols = list(chebyshev_basis(t, self.degree, self.basis.epsilon)
                        .unbind(-1)) if self.family == "cheby" else \
                self.basis.expansion(t, self.beta_weights)
        # (B, H, W, C, K): the rows channel-major c*K + kk
        basis = torch.stack(cols, dim=-1)
        if drop and site == "basis":
            basis = channel_dropout(basis.flatten(-2), self.dropout,
                                    generator).view(basis.shape)
        # (B, H, W, groups, in_g, K) -> rows per group c*K + kk, or kk*in_g
        # + c degree-major
        basis = basis.reshape(*x.shape[:-1], self.groups, self.in_g,
                              self.num_basis)
        if self.spec.degree_major:
            basis = basis.transpose(-1, -2)
        y = self._conv(basis.reshape(*x.shape[:-1], -1), self.poly_w)
        return y if base is None else base + y

    def _grouped_minmax(self, x):
        """Legendre's squash 2 (x - min) / (max - min) - 1, the min and max
        over each group's channels of the whole batch
        (legendre_kan_layers.py:130)."""
        xg = x.reshape(*x.shape[:-1], self.groups, self.in_g)
        dims = tuple(d for d in range(xg.dim()) if d != xg.dim() - 2)
        mn = xg.amin(dim=dims, keepdim=True)
        mx = xg.amax(dim=dims, keepdim=True)
        return (2.0 * (xg - mn) / (mx - mn) - 1.0).reshape(x.shape)

    def _input_norms(self, t):
        """FastKAN's input norm: ``input_norm_{g}`` on group g's channels.
        A LayerNorm or RMSNorm of in_g features normalizes the trailing
        spatial axis of the reference's NCHW input, which must then have
        in_g entries (fast_kan_layers.py:80): channel-last, the norm runs
        with the channel and trailing spatial axes swapped."""
        trailing = self.input_norm_cls in (LayerNorm, RMSNorm)
        if trailing and t.shape[-2] != self.in_g:
            raise ValueError(
                f"a {self.input_norm_cls.__name__}({self.in_g}) on a conv "
                "input normalizes the trailing spatial axis and needs it "
                f"to be {self.in_g}, got {t.shape[-2]} "
                "(fast_kan_layers.py:80)")
        parts = []
        for g in range(self.groups):
            norm = getattr(self, f"input_norm_{g}")
            tg = t[..., g * self.in_g:(g + 1) * self.in_g]
            parts.append(norm(tg.transpose(-1, -2)).transpose(-1, -2)
                         if trailing else norm(tg))
        return parts[0] if self.groups == 1 else torch.cat(parts, dim=-1)

    def _post_combine(self, y):
        """The output norm (none for FastKAN), then (``spec.post``) PReLU
        with the per-group slope repeated per out_g, or the base
        activation."""
        if self.norm is not None:
            y = self.norm(y)
        if self.spec.post == "none":
            return y
        if self.spec.post == "act":
            return ACTIVATIONS[self.act](y)
        slope = self.prelu.repeat_interleave(self.out_g)
        return torch.where(y >= 0, y, slope * y)
