"""KAN conv: the CUDA kernels' wrappers and their plain PyTorch versions,
forward and backward, over a per-channel basis (``Basis``): the B-spline
with its base path, the Chebyshev polynomials without one, the Gram
polynomials with a learnable operand (beta) and a base path, or one of the
static bases with a base path: a three-term recurrence on tanh x (Jacobi,
Bessel, Fibonacci, Gegenbauer, Hermite, Laguerre, Lucas, Taylor), the
reference's Bernstein sweep on sigmoid x, or the Fourier features.

``kan_conv2d`` computes the pre-norm output of a KAN conv (stride 1,
dilation 1, groups 1, NHWC):

    y[b,i,j,o] = sum_{di,dj} sum_r E[b,i+di,j+dj,r] * W_all[r, (di*k+dj)*O+o]
    E = [P_0(x) .. P_{K-1}(x)(, act(x))], zero on the pad AFTER expansion

(R = K rows per channel, or K + 1 with the base path's act(x)), which is
what ``convkan_tpu/kernels/wide_kan_conv.py`` (``fwd_kernel``) and
``convkan_tpu/kernels/fused_kan_conv.py`` (``fused_kan_conv2d``) compute on
the TPU.  On a CUDA tensor it launches ``csrc/kan_conv2d_fwd.cu`` or raises,
and its gradient (the counterpart of the custom_vjp around ``bwd_kernel``
in ``wide_kan_conv.py``) launches the three kernels of
``csrc/kan_conv2d_bwd.cu``: the data gradient, the weight gradient in
per-split partial sums, and their ordered reduction.  A basis with a
learnable operand (``extra``: Gram's beta, the Pallas kernels' ``extras``)
takes it as a device pointer in every kernel; the data-gradient kernel
also writes per-block partial sums of its gradient (``dextras``), which
the same ordered reduction sums.  On a CPU tensor it runs
``kan_conv2d_reference`` under plain autograd.  There is no fallback from
a kernel to a plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import threading
from typing import Optional

import numpy as np
import torch

from ..basis.bspline import bspline_basis_unrolled_list
from ..basis.poly import (RECUR3_FAMILIES, bernstein_basis_list,
                          chebyshev_basis_recurrence_list, fourier_basis_list,
                          gram_basis_cols, legendre_basis_list,
                          recur3_coefficients, recur3_cols)
from ..ops.conv import conv_nd
from ..utils.activations import ACTIVATIONS

SOURCE = "kan_conv2d_fwd.cu"
BWD_SOURCE = "kan_conv2d_bwd.cu"
# the bases the kernels are compiled for (Basis.key), by the integer code
# the C entries take: the B-spline of 12 knots at order 3 (grid 5) with a
# SiLU, GELU, hardswish, identity or ReLU (MobileNetV1's) base path, the
# Chebyshev polynomials of degree 3, the Gram polynomials of degree 3 with
# SiLU or the identity on every row, and the static bases of KAN-VGG16_small (base_activation
# "silu", degree 3, grid 5): six recurrences of 4 rows with a SiLU base path
# (one instantiation, their coefficients passed as parameters), Jacobi's
# with the identity (base_input "raw"), Taylor's 3 monomials, Bernstein of
# degree 3 (identity) and Fourier of grid 5
COMPILED = {("bspline", 12, 3, "silu"): 0, ("bspline", 12, 3, "gelu"): 1,
            ("cheby", 3): 2, ("gram", 3, "silu"): 3,
            ("bspline", 12, 3, "hardswish"): 4,
            ("bspline", 12, 3, "identity"): 5, ("gram", 3, "identity"): 6,
            **{(fam, 3, "silu"): 7 for fam in (
                "bessel", "fibonacci", "gegenbauer", "hermite", "laguerre",
                "lucas")},
            ("jacobi", 3, "identity"): 8, ("taylor", 3, "silu"): 9,
            ("bernstein", 3, "identity"): 10, ("fourier", 5, "silu"): 11,
            ("bspline", 12, 3, "relu"): 12}
THREADS, TM = 256, 8             # forward block: threads, pixels per thread
WARPS = THREADS // 32
MAX_CHUNK = 8                    # input channels expanded per pass
MAX_BN = 128                     # output channels per forward block
MAX_SPLITS = 16                  # channel splits of a tile: one cluster
SKIP_POSITIONS = 16              # pad taps skipped when Ho*Wo <= this
TARGET_BLOCKS = 4 * 132          # two waves of two blocks per SM (H100 SXM)
SMEM_LIMIT = 227 * 1024          # shared memory a block may use
SMEM_TWO_BLOCKS = 112 * 1024     # ... with two blocks on an SM
DX_SMEM_STATIC = 4 * 32          # the dx kernel's static knots (of the 227)
# data-gradient tile: 32 pixel slots x 8 pixels per thread x 8 channel lanes
# (CC <= 8 channels, a power of two), output channels staged DX_OC at a
# time, two chunks in flight; where the input plane has at most
# SKIP_POSITIONS pixels, a warp holds one position of DX_GROUP images and
# skips the pad taps
DX_SLOTS, DX_TM, DX_MAX_CC, DX_OC, DX_GROUP = 32, 8, 8, 8, 32
DX_PIXELS = DX_SLOTS * DX_TM
# weight-gradient tile: a thread sums one channel's R expanded rows x
# DW_TN columns, a block CC <= DW_MAX_CC channels x BN columns in at most
# DW_THREADS threads, over chunks of DW_P pixels; the batch is split so that
# the grid stays within DW_TARGET_BLOCKS (6 per SM: close to whole waves
# whether 2 or 3 blocks fit on an SM)
DW_THREADS, DW_TN, DW_MAX_CC, DW_P = 256, 8, 8, 64
DW_TARGET_BLOCKS = 6 * 132
# ordered reduction (csrc/ordered_sum.cuh): 128-thread blocks of at most 8
# rows, clusters of at most 8 ranks, leaves of at least one batch of the
# kernel's 8 loads in flight, and the splits spread until the grid has four
# blocks per SM.  A cluster costs about 1 us of barriers (the launch sweep
# of tools/ordered_sum_ab.py on the H100), so ranks are used only where 8
# rows leave fewer blocks than SMs and leaves of more than
# RED_CLUSTER_LEAF splits
RED_THREADS, RED_MAX_ROWS, RED_MAX_RANKS, RED_MIN_LEAF = 128, 8, 8, 8
RED_TARGET_BLOCKS, RED_CLUSTER_GRID, RED_CLUSTER_LEAF = 4 * 132, 132, 32

# the forward tile's entries of launch_config, in the C entry's order
FWD_TILE = ("BN", "skip", "TH", "TW", "NB", "NG", "CC", "S")
# ... and the data-gradient tile's of dx_launch_config
DX_TILE = ("skip", "TH", "NB", "NG", "CC", "OC", "stages", "table")

KERNELS = ("kan_conv2d_fwd", "kan_conv2d_bwd_dx", "kan_conv2d_bwd_dw",
           "kan_conv2d_bwd_dw_reduce")
_count_lock = threading.Lock()
launches = dict.fromkeys(KERNELS, 0)   # launches per kernel since the reset
# the same launches by (kernel, Basis.key of the basis launched) since the
# reset: one model runs several instantiations of a kernel
launches_by_basis: dict = {}
# KAN convs that took the plain route (nn/kan_conv.py: the convs that the
# JAX package hands to XLA) since the reset
PLAIN = "kan_conv_plain_route"
plain_calls = {PLAIN: 0}


def reset_launches() -> None:
    """Zero the kernels' launch counts and the plain-route count."""
    with _count_lock:
        for name in launches:
            launches[name] = 0
        launches_by_basis.clear()
        plain_calls[PLAIN] = 0


def count_plain() -> None:
    with _count_lock:
        plain_calls[PLAIN] += 1


def _count_launch(name: str, key) -> None:
    with _count_lock:
        launches[name] += 1
        launches_by_basis[(name, key)] = \
            launches_by_basis.get((name, key), 0) + 1


@dataclasses.dataclass(frozen=True)
class Basis:
    """The expansion of every input channel: ``kind`` "bspline" (``K`` =
    len(knots) - order - 1 bases of the Cox-de Boor recurrence, spline
    order ``order``), "cheby" (T_0 .. T_order of clamp(tanh x, -1 + eps,
    1 - eps), K = order + 1) or "gram" (act(p_0(t)) .. act(p_order(t)) of
    the Gram recurrence on t = tanh x with the learnable operand beta,
    K = order + 1), a family of ``RECUR3_FAMILIES`` (P_0(t) .. P_{K-1}(t)
    of t = tanh x by ``recur3_cols`` over its ``coefficients``; ``order``
    the degree), "bernstein" (the reference's sweep on sigmoid x, K =
    order + 1) or "fourier" (cos and sin of k x for k = 1..order, K =
    2 order); ``act`` names the base path's activation ("identity" for a
    conv built with base_activation=None or a family whose base path takes
    x itself), None for no base path (Gram's rows take it too);
    ``degree_major`` gives poly_w's rows kk*C + c (the family's layout)
    instead of c*K + kk.  Build it with ``bspline_basis``, ``cheby_basis``,
    ``gram_basis``, ``recur3_basis``, ``bernstein_basis`` or
    ``fourier_basis``; ``legendre_basis`` (the plain route's only: no
    kernel carries it) describes the Legendre polynomials of degree
    ``order`` of an input the module has squashed."""

    kind: str
    K: int
    order: int
    knots: tuple = ()
    epsilon: float = 0.0
    act: Optional[str] = None
    degree_major: bool = False
    coefficients: tuple = ()

    @property
    def R(self) -> int:
        """Rows of E per channel: the K bases and the base path's."""
        return self.K + (self.act is not None)

    @property
    def n_extra(self) -> int:
        """Length of the learnable operand (``extra``) the basis takes:
        Gram's beta (order + 1), or 0 for none."""
        return self.K if self.kind == "gram" else 0

    @property
    def key(self) -> tuple:
        if self.kind == "bspline":
            return (self.kind, len(self.knots), self.order, self.act)
        if self.kind == "cheby":
            return (self.kind, self.order)
        return (self.kind, self.order, self.act)

    @property
    def params(self) -> tuple:
        """The C entries' float32 parameters: the knots, the clamp bounds
        float32(-1 + eps), float32(1 - eps) as jnp.clip takes them, a
        recurrence's coefficients (c0, A_1, B_1, D_1, then A_n, B_n, C_n,
        D_n per row) rounded as torch rounds a Python scalar to float32, or
        none (Gram's beta is a device operand, not a parameter)."""
        if self.kind == "bspline":
            return self.knots
        if self.kind == "cheby":
            return (float(np.float32(-1.0 + self.epsilon)),
                    float(np.float32(1.0 - self.epsilon)))
        if self.kind in RECUR3_FAMILIES:
            c0, first, steps = self.coefficients
            return tuple(float(np.float32(v)) for v in
                         (c0, *first, *itertools.chain(*steps)))
        return ()

    def squash(self, x):
        """The input of the expansion: tanh x (Gram, the recurrences),
        sigmoid x (Bernstein), else x itself (the B-spline, Chebyshev,
        whose clamp of tanh is part of its expansion, Fourier, Legendre,
        whose batch min-max the module applies)."""
        if self.kind == "gram" or self.kind in RECUR3_FAMILIES:
            return torch.tanh(x)
        if self.kind == "bernstein":
            return torch.sigmoid(x)
        return x

    def expansion(self, t, extra=None) -> list:
        """[P_0(t) .. P_{K-1}(t)] of the squashed input t, each shaped like
        t, as the TPU kernels build them (the Chebyshev recurrence, not the
        trig form; Gram's rows after their activation).  ``extra``: Gram's
        beta, (K,) or one such row per element of t on a last axis."""
        if self.kind == "bspline":
            return bspline_basis_unrolled_list(t, self.knots, self.order)
        if self.kind == "gram":
            act = ACTIVATIONS[self.act]
            return [act(p) for p in gram_basis_cols(t, self.order, extra)]
        if self.kind in RECUR3_FAMILIES:
            return recur3_cols(t, self.coefficients)
        if self.kind == "bernstein":
            return bernstein_basis_list(t, self.order)
        if self.kind == "fourier":
            return fourier_basis_list(t, self.order)
        if self.kind == "legendre":
            return legendre_basis_list(t, self.order)
        return chebyshev_basis_recurrence_list(t, self.order, self.epsilon)

    def columns(self, x, extra=None) -> list:
        """[P_0(x) .. P_{K-1}(x)] of the raw input: ``expansion`` of
        ``squash``, the kernels' plain version."""
        return self.expansion(self.squash(x), extra)

    def __str__(self) -> str:
        if self.kind == "bspline":
            return (f"bspline knots={len(self.knots)} order={self.order} "
                    f"act={self.act!r}")
        if self.kind == "cheby":
            return f"cheby degree={self.order}"
        what = "grid" if self.kind == "fourier" else "degree"
        return f"{self.kind} {what}={self.order} act={self.act!r}"


def bspline_basis(knots, order: int, act: str) -> Basis:
    """The B-spline over ``knots`` at spline order ``order``, with the base
    path act(x)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown base activation {act!r}")
    knots = tuple(float(v) for v in knots)
    return Basis("bspline", len(knots) - order - 1, order, knots=knots,
                 act=act)


def cheby_basis(degree: int, epsilon: float = 1e-7) -> Basis:
    """The Chebyshev polynomials T_0 .. T_degree of clamp(tanh x), no base
    path."""
    return Basis("cheby", degree + 1, degree, epsilon=float(epsilon))


def gram_basis(degree: int, act: str = "silu") -> Basis:
    """The Gram polynomials p_0 .. p_degree of tanh x with the learnable
    recurrence operand beta (degree + 1,), act on every row, and the base
    path act(x); poly_w degree-major, as the JAX "gram" family keeps it."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown base activation {act!r}")
    return Basis("gram", degree + 1, degree, act=act, degree_major=True)


def recur3_basis(family: str, degree: int, act: str, a: float = 1.0,
                 b: float = 1.0, alpha: float = 1.0) -> Basis:
    """``family``'s three-term recurrence on tanh x (``RECUR3_FAMILIES``;
    ``a``, ``b``: Jacobi's; ``alpha``: Gegenbauer's alpha_param or
    Laguerre's alpha) with the base path act(x); poly_w degree-major for
    Jacobi, as the JAX "jacobi" family keeps it."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown base activation {act!r}")
    coefficients = recur3_coefficients(family, degree, a, b, alpha)
    return Basis(family, degree if family == "taylor" else degree + 1,
                 degree, act=act, degree_major=family == "jacobi",
                 coefficients=coefficients)


def legendre_basis(degree: int) -> Basis:
    """The Legendre polynomials P_0 .. P_degree (of the module's batch
    min-max squash of x), the base path x itself, poly_w degree-major."""
    return Basis("legendre", degree + 1, degree, act="identity",
                 degree_major=True)


def bernstein_basis(degree: int) -> Basis:
    """The reference's Bernstein sweep of degree ``degree`` on sigmoid x,
    with the base path x itself (base_input "raw")."""
    return Basis("bernstein", degree + 1, degree, act="identity")


def fourier_basis(grid_size: int, act: str) -> Basis:
    """cos(k x) and sin(k x) for k = 1..grid_size, with the base path
    act(x)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown base activation {act!r}")
    return Basis("fourier", 2 * grid_size, grid_size, act=act)


def pack_w_all(base_w, poly_w, *, C: int, K: int, k: int, O: int,
               degree_major: bool = False):
    """(D, k*k*O) combined weights, D = K*C, or (K+1)*C with a base path:
    rows kk*C + c hold basis kk of channel c, then C rows of the base path
    (``base_w`` None: none); columns (di*k+dj)*O + o.  ``poly_w`` is HWIO
    (k, k, C*K, O) with channel-major rows c*K + kk, or with
    ``degree_major`` rows kk*C + c."""
    if degree_major:
        pw = poly_w.reshape(k, k, K, C, O).permute(2, 3, 0, 1, 4)
    else:
        pw = poly_w.reshape(k, k, C, K, O).permute(3, 2, 0, 1, 4)
    pw = pw.reshape(K * C, k * k * O)
    if base_w is None:
        return pw.contiguous()
    bw = base_w.permute(2, 0, 1, 3).reshape(C, k * k * O)
    return torch.cat([pw, bw], dim=0).contiguous()


def expand(x, basis: Basis, extra=None):
    """E = [P_0(x) .. P_{K-1}(x)(, act(x))] concatenated on the channel axis
    (column kk*C + c), the rows of ``pack_w_all``'s layout; ``extra`` the
    basis's learnable operand (None without one)."""
    cols = basis.columns(x, extra)
    if basis.act is not None:
        cols = cols + [ACTIVATIONS[basis.act](x)]
    return torch.cat(cols, dim=-1)


def _conv_w_all(E, w_all, k: int, pad: int):
    D, O = w_all.shape[0], w_all.shape[1] // (k * k)
    w_hwio = w_all.reshape(D, k, k, O).permute(1, 2, 0, 3)
    return conv_nd(E, w_hwio, padding=pad).contiguous()


def kan_conv2d_reference(x, base_w, poly_w, basis: Basis, k: int,
                         pad: int, extra=None):
    """Plain PyTorch version: build the basis, concatenate the base path
    (if any), and convolve (the convolution's zero padding is the mask
    after expansion).  float32 or float64, any device, differentiable
    (``extra`` too)."""
    C, O = x.shape[-1], poly_w.shape[-1]
    w_all = pack_w_all(base_w, poly_w, C=C, K=basis.K, k=k, O=O,
                       degree_major=basis.degree_major)
    return _conv_w_all(expand(x, basis, extra), w_all, k, pad)


def _detach(t):
    return None if t is None else t.detach()


def input_grad_reference(x, w_all, g, basis: Basis, k: int, pad: int,
                         extra=None):
    """Plain version of the data-gradient kernel: dL/dx of the reference
    for the output gradient g, by autograd."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        y = _conv_w_all(expand(xr, basis, _detach(extra)), w_all.detach(), k,
                        pad)
        return torch.autograd.grad(y, xr, g)[0]


def extra_grad_reference(x, w_all, g, basis: Basis, k: int, pad: int,
                         extra):
    """Plain version of the data-gradient kernel's second result, reduced:
    dL/dextra (n_extra,) of the reference for the output gradient g, by
    autograd."""
    with torch.enable_grad():
        e = extra.detach().requires_grad_(True)
        y = _conv_w_all(expand(x.detach(), basis, e), w_all.detach(), k, pad)
        return torch.autograd.grad(y, e, g)[0]


def extra_terms_reference(x, w_all, g, basis: Basis, k: int, pad: int,
                          extra):
    """(B, H, W, C, n_extra): the term of dL/dextra that each (pixel,
    channel) adds, by autograd of the reference with one copy of extra per
    element of x (their sum is ``extra_grad_reference``)."""
    with torch.enable_grad():
        e = extra.detach().expand(*x.shape, extra.numel()).clone() \
            .requires_grad_(True)
        y = _conv_w_all(expand(x.detach(), basis, e), w_all.detach(), k, pad)
        return torch.autograd.grad(y, e, g)[0]


def extra_blocks(B: int, H: int, W: int, C: int, cfg) -> torch.Tensor:
    """(B, H, W, C) int64: the data-gradient block (its row of the extra
    partials, blockIdx.y * tiles + blockIdx.x) that sums each (pixel,
    channel) for the tile ``cfg`` of ``dx_launch_config`` (mirrors the
    kernel's pixel layout): dense, image group b // NB and row tile
    i // TH; skip, slot (b // DX_GROUP) * H*W + i*W + j over WARPS slots
    a block; channel block c // CC."""
    b = torch.arange(B).view(B, 1, 1, 1)
    i = torch.arange(H).view(1, H, 1, 1)
    j = torch.arange(W).view(1, 1, W, 1)
    c = torch.arange(C).view(1, 1, 1, C)
    if cfg["skip"]:
        bx = ((b // DX_GROUP) * (H * W) + i * W + j) // WARPS
    else:
        bx = (b // cfg["NB"]) * -(-H // cfg["TH"]) + i // cfg["TH"]
    return ((c // cfg["CC"]) * cfg["tiles"] + bx).expand(B, H, W, C)


def extra_partials_reference(x, w_all, g, basis: Basis, k: int, pad: int,
                             extra):
    """Plain version of the data-gradient kernel's extra partials: (S,
    n_extra), row s the terms (``extra_terms_reference``) of the (pixel,
    channel) pairs that block s of the kernel's tile sums (``extra_blocks``;
    S = tiles x channel blocks), added in another order than the kernel's."""
    B, H, W, C = x.shape
    O = g.shape[-1]
    cfg = dx_launch_config(B, H, W, C, O, k, pad, basis.R)
    terms = extra_terms_reference(x, w_all, g, basis, k, pad, extra)
    S = cfg["tiles"] * -(-C // cfg["CC"])
    out = torch.zeros(S, basis.n_extra, dtype=terms.dtype,
                      device=terms.device)
    idx = extra_blocks(B, H, W, C, cfg).reshape(-1).to(terms.device)
    return out.index_add_(0, idx, terms.reshape(-1, basis.n_extra))


def weight_grad_reference(x, g, basis: Basis, k: int, pad: int,
                          extra=None):
    """Plain version of the weight gradient: dL/dW_all (R*C, k*k*O) of the
    reference for the output gradient g, by autograd."""
    E = expand(x.detach(), basis, _detach(extra))
    O = g.shape[-1]
    with torch.enable_grad():
        w = torch.zeros(E.shape[-1], k * k * O, dtype=x.dtype,
                        device=x.device, requires_grad=True)
        return torch.autograd.grad(_conv_w_all(E, w, k, pad), w, g)[0]


def weight_partials_reference(x, g, basis: Basis, k: int, pad: int,
                              splits: int, ips: int, extra=None):
    """Plain version of the weight-gradient kernel: the (splits, R*C,
    k*k*O) partial sums, split s over images [s*ips, s*ips + ips)."""
    return torch.stack([
        weight_grad_reference(x[s * ips:(s + 1) * ips],
                              g[s * ips:(s + 1) * ips], basis, k, pad, extra)
        for s in range(splits)])


def reduce_launch_config(S: int, N: int) -> dict:
    """The ordered reduction's launch (csrc/ordered_sum.cuh) for (S, N)
    partials; it depends on (S, N) alone.  A block is RED_THREADS threads
    in ``Gw`` rows of T = RED_THREADS/Gw; a thread owns ``VW``
    consecutive columns (4 when N % 4 == 0: float4 loads), so a block
    covers ``cols`` = T*VW columns; ``Gc`` blocks of a cluster (along y)
    take further leaves.  S is cut into L = Gw*Gc contiguous ``leaves``,
    leaf l = [l*S//L, (l+1)*S//L); row w of rank r sums leaf r*Gw + w.
    Starting from one leaf, L doubles (thread rows first, up to
    RED_MAX_ROWS, then cluster ranks) while the grid has fewer than
    RED_TARGET_BLOCKS blocks and every leaf keeps at least RED_MIN_LEAF
    splits: the wide, small-S partials take one pass, the narrow ones with
    hundreds of splits spread over the card.  Ranks join only where 8 rows
    leave fewer than RED_CLUSTER_GRID blocks with leaves of more than
    RED_CLUSTER_LEAF splits, and then halve the leaves until they hold at
    most 2 * RED_MIN_LEAF.  Returns also ``grid`` (x, y) and
    ``blocks``."""
    if S < 1 or N < 1:
        raise ValueError(f"empty partials ({S}, {N})")
    VW = 4 if N % 4 == 0 else 1
    Gw = Gc = 1

    def grid_x(rows):
        return -(-(N // VW) // (RED_THREADS // rows))

    cluster = grid_x(RED_MAX_ROWS) < RED_CLUSTER_GRID and \
        S // RED_MAX_ROWS > RED_CLUSTER_LEAF
    while grid_x(Gw) * Gc < RED_TARGET_BLOCKS and \
            S // (2 * Gw * Gc) >= RED_MIN_LEAF:
        if Gw < RED_MAX_ROWS:
            Gw *= 2
        elif cluster and Gc < RED_MAX_RANKS and \
                S // (Gw * Gc) > 2 * RED_MIN_LEAF:
            Gc *= 2
        else:
            break
    L = Gw * Gc
    return {"VW": VW, "cols": RED_THREADS // Gw * VW, "Gw": Gw, "Gc": Gc,
            "leaves": [(i * S // L, (i + 1) * S // L) for i in range(L)],
            "grid": (grid_x(Gw), Gc), "blocks": grid_x(Gw) * Gc}


def reduce_reference(partial, cfg=None):
    """Plain version of the reduction kernel: the (S, ...) partials summed
    over S in exactly the kernel's order for ``cfg`` (by default
    ``reduce_launch_config(S, N)``): each leaf in split order, the leaves
    of a block in row order, then the blocks of a cluster in rank
    order.  Float adds in the kernel's order, so the two agree bit for
    bit; with one leaf it is the plain split-order sum."""
    if cfg is None:
        cfg = reduce_launch_config(partial.shape[0], partial[0].numel())
    total = None
    for rank in range(cfg["Gc"]):
        block = None
        for row in range(cfg["Gw"]):
            lo, hi = cfg["leaves"][rank * cfg["Gw"] + row]
            leaf = partial[lo].clone()
            for s in range(lo + 1, hi):
                leaf += partial[s]
            block = leaf if block is None else block.add_(leaf)
        total = block if total is None else total.add_(block)
    return total


def reduce_args(partial, out, cfg) -> tuple:
    """The reduction's C arguments after (partial, out): S N VW Gw Gc.
    float4 loads need 16-byte aligned pointers; for a misaligned one the
    kernel takes single floats (VW 1), which changes the grid but not the
    order of the adds."""
    aligned = partial.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return (partial.shape[0], partial[0].numel(),
            cfg["VW"] if aligned else 1, cfg["Gw"], cfg["Gc"])


def _describe(B, H, W, C, O, k, pad, basis: Basis) -> str:
    return (f"KAN conv x=({B},{H},{W},{C}) O={O} kernel={k} pad={pad} "
            f"{basis}")


def row_stride(R: int, CC: int) -> int:
    """Floats per pixel of the kernel's expanded tile: R*CC rounded up to
    whole float4s, made an odd number of float4s (mirrors the C entry)."""
    rs = -(-R * CC // 4) * 4
    return rs + 4 if (rs // 4) % 2 == 0 else rs


def thread_tile(BN: int):
    """(TN, TPW, BM, G) of the forward's BN-column block (mirrors Geo in the
    C source): TN channels and TM pixels per thread, BN/TN threads along N,
    TPW threads of a warp along M, BM pixels per block, and G = TPW*TM
    images per warp when pad taps are skipped."""
    TN = 4 if BN == 16 else 8
    tpw = 32 // (BN // TN)
    return TN, tpw, THREADS // (BN // TN) * TM, tpw * TM


def skip_groups(P: int, groups: int) -> int:
    """Image groups a block's WARPS warp slots reach at most, when slots
    enumerate (group, position) with P positions (mirrors the C entry)."""
    need = max((b * WARPS + WARPS - 1) // P - b * WARPS // P + 1
               for b in range(P))
    return min(need, groups)


def fwd_smem(tile: int, rs: int, BN: int, BM: int, S: int) -> int:
    """Dynamic shared memory of a forward block: the expanded tile, two
    weight slices, and with S > 1 room for the partial tile."""
    nbytes = 4 * (tile * rs + 2 * rs * BN)
    return max(nbytes, 4 * BM * BN) if S > 1 else nbytes


def launch_config(B, H, W, C, O, k, pad, R) -> dict:
    """The forward's tile.  BN output channels per block (O rounded up to a
    power of two in 16..128); either ``skip`` (Ho*Wo <= SKIP_POSITIONS:
    pixels ordered (position, image), NG image groups of G per block, pad
    taps skipped) or dense (NB images x TH rows x TW columns, TH and TW
    shrunk until the tile fits); CC input channels per pass; S channel
    splits summed inside one cluster, the largest power of two that keeps
    the grid within TARGET_BLOCKS.  CC minimizes the channels on one
    split's path (ties: the larger CC) within two blocks' shared memory per
    SM, else one's.  R: rows of E per channel (``Basis.R``).
    Returns the kernel's arguments and, for the tests, ``rs``, ``tile``
    (pixels), ``tiles`` (blocks along M), ``blocks`` and ``smem``.
    Raises NotImplementedError for a shape whose tile does not fit."""
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    BN = 16
    while BN < min(O, MAX_BN):
        BN *= 2
    _, _, BM, G = thread_tile(BN)
    tiles_n = -(-O // BN)
    geoms = []
    if Ho * Wo <= SKIP_POSITIONS:
        groups = -(-B // G)
        NG = skip_groups(Ho * Wo, groups)
        geoms.append({"skip": 1, "TH": 0, "TW": 0, "NB": 0, "NG": NG,
                      "tile": NG * G * H * W,
                      "tiles": -(-groups * Ho * Wo // WARPS)})
    TW = min(Wo, BM)
    TH = min(Ho, BM // TW)
    while True:
        NB = min(B, BM // (TH * TW)) if (TH, TW) == (Ho, Wo) else 1
        geoms.append({"skip": 0, "TH": TH, "TW": TW, "NB": NB, "NG": 0,
                      "tile": NB * (TH + k - 1) * (TW + k - 1),
                      "tiles": -(-B // NB) * -(-Ho // TH) * -(-Wo // TW)})
        if TH == TW == 1:
            break
        TH, TW = (TH // 2, TW) if TH > 1 else (1, TW // 2)
    for budget in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        for geo in geoms:
            S = 1
            while 2 * S <= min(MAX_SPLITS, C) and \
                    2 * S * geo["tiles"] * tiles_n <= TARGET_BLOCKS:
                S *= 2
            best = None
            for CC in range(min(C, MAX_CHUNK), 0, -1):
                rs, nch = row_stride(R, CC), -(-C // CC)
                s_cc = S
                while s_cc > nch:  # every split gets a chunk
                    s_cc //= 2
                smem = fwd_smem(geo["tile"], rs, BN, BM, s_cc)
                if smem > budget:
                    continue
                path = -(-nch // s_cc) * CC
                if best is None or path < best[0]:
                    best = (path, {"BN": BN, **geo, "CC": CC, "S": s_cc,
                                   "rs": rs, "smem": smem,
                                   "blocks": geo["tiles"] * tiles_n * s_cc})
            if best is not None:
                return best[1]
    raise NotImplementedError("tile does not fit in shared memory")


def dx_smem(tile: int, pitch: int, taps: int, R: int, CC: int, OC: int,
            stages: int, skip: int, table: int) -> int:
    """Dynamic shared memory of a data-gradient block (mirrors dx_smem in
    the C source): ``stages`` chunks of the g tile (``pitch`` pixels: the
    ``tile`` staged and what idle slots read past it) and the weight slices
    of all taps, OC/4 float4s per entry, with ``table`` the tile's table
    (one int per staged pixel) and, for the skip tile, each warp's valid
    taps (a bit per tap)."""
    return 16 * stages * (OC // 4) * (pitch + taps * R * CC) + \
        4 * tile * table + (4 * WARPS * -(-taps // 32) if skip else 0)


def dx_geometry(B, H, W, k, pad, skip: int, TH: int, NB: int,
                NG: int) -> dict:
    """The data-gradient block's pixel layout (mirrors the C entry): the g
    tile's radices ``tileR`` x ``tileC`` and ``tile`` (pixels staged),
    ``pitch``, ``planes`` (dense: image planes staged), ``tiles`` (blocks
    along the pixels) and ``dq``: the tile pixels from a thread's pixel
    q = 0 to its pixel q, the same for every thread (0 for a pixel past
    the layout's NB*TH*Wv slots, which stays idle)."""
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    if skip:
        groups, P = -(-B // DX_GROUP), H * W
        tile = Ho * Wo * NG * DX_GROUP
        return {"tileR": Wo, "tileC": NG * DX_GROUP, "tile": tile,
                "pitch": tile, "planes": 0, "tiles": -(-groups * P // WARPS),
                "dq": tuple(4 * q for q in range(DX_TM))}
    Wv = 1 << (W - 1).bit_length()
    P = TH * Wv
    planes = NB if P < DX_SLOTS else min(NB, B)
    rows = min(TH, H)
    tileR, tileC = rows + k - 1, W + k - 1
    tile = planes * tileR * tileC
    dq = []
    for q in range(DX_TM):
        m = DX_SLOTS * q
        dq.append((m // P * tileR + m % P // Wv) * tileC + m % Wv
                  if m // P < planes else 0)
    return {"tileR": tileR, "tileC": tileC, "tile": tile,
            "pitch": tile + (TH - rows) * tileC + Wv - W, "planes": planes,
            "tiles": -(-B // NB) * -(-H // TH), "dq": tuple(dq)}


def dx_launch_config(B, H, W, C, O, k, pad, R) -> dict:
    """Block tile for the data-gradient kernel: DX_PIXELS input pixels x CC
    channels (one channel lane per thread, CC <= DX_MAX_CC a power of two),
    OC output channels per staged chunk (8, or 4 for O <= 4), ``stages``
    chunks in flight.  Either ``skip`` (H*W <= SKIP_POSITIONS: a warp per
    (position, DX_GROUP images), NG image groups' g planes staged without a
    halo, pad taps skipped) or dense (NB image slots x TH rows x Wv
    columns, TH and Wv = W rounded up to powers of two, 256 slots; the
    haloed g tile of the block's rows), with the skip tile as the dense
    one's fallback and, at the edge of shared memory (large kernels),
    dense layouts of 128, 64 or 32 slots (fewer rows in the haloed tile;
    the block's other pixels idle), first with the tile's table of g
    offsets, then without it (``table`` 0: each staging thread counts its
    pixels' offsets again at every chunk).  Two blocks' shared memory per
    SM where it can, else one's; within a budget and a tile, OC is cut
    first, then stages, then CC.  Returns the kernel's arguments, the
    layout of ``dx_geometry``, ``blocks`` and ``smem`` (a new dict per
    call, from a cache of the shape's tile).  R: rows of E per channel.
    Raises NotImplementedError for a row wider than a block or a shape
    whose tile does not fit."""
    return dict(_dx_tile(B, H, W, C, O, k, pad, R))


@functools.lru_cache(maxsize=1024)
def _dx_tile(B, H, W, C, O, k, pad, R) -> dict:
    if W > DX_PIXELS:
        raise NotImplementedError(f"input width {W} > {DX_PIXELS} pixels per "
                                  "data-gradient block")
    T, P = k * k, H * W
    skip = {"skip": 1, "TH": 0, "NB": 0,
            "NG": skip_groups(P, -(-B // DX_GROUP)), "table": 1}
    Wv = 1 << (W - 1).bit_length()

    def dense(slots, table=1):
        TH = min(1 << (H - 1).bit_length(), slots // Wv)
        return {"skip": 0, "TH": TH, "NB": slots // (TH * Wv), "NG": 0,
                "table": table}

    # the skip tile where the plane is small, else the dense one and, for
    # large kernels, the skip tile, dense layouts of fewer slots and the
    # tiles without their table as fallbacks
    tiles = [skip] if P <= SKIP_POSITIONS else [dense(DX_PIXELS), skip]
    small = [] if P <= SKIP_POSITIONS else \
        [dense(n) for n in (DX_PIXELS // 2, DX_PIXELS // 4, DX_SLOTS)
         if Wv <= n]
    small += [{**t, "table": 0} for t in tiles + small]
    CC0 = 1
    while CC0 < min(C, DX_MAX_CC):
        CC0 *= 2
    ccs = [CC0 >> i for i in range(CC0.bit_length())]
    ocs = (DX_OC, 4) if O > 4 else (4,)
    for budget, cands in ((SMEM_TWO_BLOCKS, tiles),
                          (SMEM_LIMIT - DX_SMEM_STATIC, tiles + small)):
        for tile in cands:
            geo = dx_geometry(B, H, W, k, pad, tile["skip"], tile["TH"],
                              tile["NB"], tile["NG"])
            for CC, stages, OC in itertools.product(ccs, (2, 1), ocs):
                if R * CC * OC // 4 > THREADS:  # a thread per weight entry
                    continue
                smem = dx_smem(geo["tile"], geo["pitch"], T, R, CC, OC,
                               stages, tile["skip"], tile["table"])
                if smem <= budget:
                    return {**tile, "CC": CC, "OC": OC, "stages": stages,
                            **geo, "blocks": geo["tiles"] * -(-C // CC),
                            "smem": smem}
    raise NotImplementedError("data-gradient tile does not fit in shared "
                              "memory")


def dw_smem(R: int, CC: int, BN: int, PW: int) -> int:
    """Dynamic shared memory of a weight-gradient block (mirrors dw_smem in
    the C source): the staged chunk (CC channels' R values rounded up to
    float4s, BN gathered columns and a 3-int pixel table per pixel), or the
    PW - 1 slices' tiles handed to slice 0, whichever is larger."""
    staged = 4 * DW_P * (-(-R // 4) * 4 * CC + BN) + 12 * DW_P
    return max(staged, 4 * (PW - 1) * R * CC * BN)


def dw_launch_config(B, H, W, C, O, k, pad, R) -> dict:
    """Block tile and batch split for the weight-gradient kernel: CC whole
    channels (the R*CC rows, C cut into near-equal chunks of at most
    DW_MAX_CC), BN of the k*k*O columns, PW pixel slices, P pixels per
    chunk, S splits of ``ips`` images.  BN is a multiple of DW_TN, as wide
    as DW_THREADS threads cover (every column tile recomputes the basis),
    cut so that it divides k*k*O when that costs at most one more tile (no
    padded column); PW copies of the CC x BN/DW_TN thread tile fill the
    block.  Shared memory stays within two blocks per SM where it can.  S
    is the largest split count whose grid stays within DW_TARGET_BLOCKS; it
    depends on the shape only, so a shape always gets the same partial
    sums and the same reduction order.  Returns the kernel's arguments and,
    for the tests, ``threads``, ``tiles`` (blocks per split), ``blocks``
    and ``smem``."""
    TO = k * k * O
    chunks = -(-C // DW_MAX_CC)
    CC = -(-C // chunks)
    vw = 4 if O % 4 == 0 else 1      # columns per gathered load
    for budget in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        # column groups that the threads and the staged chunk allow: a
        # staged pixel takes 3 ints of pixel table, CC channels' values and
        # BN gathered columns
        groups = min(DW_THREADS // CC,
                     (budget // (4 * DW_P) - 3 - -(-R // 4) * 4 * CC)
                     // DW_TN)
        if groups < 1:
            continue
        # t column tiles, from the fewest those groups cover
        for t in range(-(-TO // (DW_TN * groups)), -(-TO // DW_TN) + 1):
            exact = [u for u in (t, t + 1) if TO % (DW_TN * u) == 0]
            BN = TO // exact[0] if exact else DW_TN * -(-TO // (DW_TN * t))
            PW = DW_THREADS // (CC * (BN // DW_TN))
            while PW > 1 and dw_smem(R, CC, BN, PW) > budget:
                PW -= 1
            threads = 32 * -(-PW * CC * (BN // DW_TN) // 32)
            smem = dw_smem(R, CC, BN, PW)
            if smem <= budget and BN // vw <= threads:
                tiles = chunks * -(-TO // BN)
                S = min(B, max(1, DW_TARGET_BLOCKS // tiles))
                ips = -(-B // S)
                S = -(-B // ips)
                return {"CC": CC, "BN": BN, "P": DW_P, "S": S, "ips": ips,
                        "PW": PW, "threads": threads, "tiles": tiles,
                        "blocks": tiles * S, "smem": smem}
    raise NotImplementedError("weight-gradient tile does not fit in shared "
                              "memory")


def check_inputs(x, base_w, poly_w, basis: Basis, k, pad, *,
                 for_kernel: bool, extra=None):
    """Validate what the caller passes (NHWC x, HWIO weights of matching
    shapes, ``base_w`` None exactly when the basis has no base path,
    ``extra`` (n_extra,) exactly when the basis takes one, contiguous, one
    device, float32 or float64); ``for_kernel`` adds the kernel's own
    requirements (float32 CUDA tensors, a basis the build carries, a tile
    that fits) and returns its launch_config."""
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    K = basis.K
    O = poly_w.shape[-1] if poly_w.ndim == 4 else -1
    has_base = basis.act is not None
    if (base_w is None) == has_base or tuple(poly_w.shape) != \
            (k, k, C * K, O) or \
            (has_base and tuple(base_w.shape) != (k, k, C, O)):
        want = f"base_w ({k},{k},{C},O) and " if has_base else "no base_w, "
        got = "none" if base_w is None else str(tuple(base_w.shape))
        raise ValueError(
            f"weights must be {want}poly_w ({k},{k},{C * K},O) for {basis}; "
            f"got base_w {got} and poly_w {tuple(poly_w.shape)}")
    if (extra is None) != (basis.n_extra == 0) or (
            extra is not None and tuple(extra.shape) != (basis.n_extra,)):
        got = "none" if extra is None else str(tuple(extra.shape))
        raise ValueError(f"{basis} takes an operand of shape "
                         f"({basis.n_extra},) (none for 0), got {got}")
    if H + 2 * pad - k + 1 <= 0 or W + 2 * pad - k + 1 <= 0 or pad < 0:
        raise ValueError(f"empty output for {H}x{W}, kernel {k}, pad {pad}")
    weights = (("base_w", base_w),) if has_base else ()
    if extra is not None:
        weights += (("extra", extra),)
    for name, t in (("x", x), *weights, ("poly_w", poly_w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if for_kernel and t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if t.dtype not in (torch.float32, torch.float64) or \
                t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: both "
                            "float32 (or float64 on the CPU) expected")
    if for_kernel:
        desc = _describe(B, H, W, C, O, k, pad, basis)
        if x.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, got {x.device}")
        if basis.key not in COMPILED:
            raise NotImplementedError(f"{desc}: not carried by the kernel")
        if max(x.numel(), B * H * W * O, poly_w.numel()) >= 2 ** 31:
            raise NotImplementedError(f"{desc}: tensor too large")
        try:
            return launch_config(B, H, W, C, O, k, pad, basis.R)
        except NotImplementedError as e:
            raise NotImplementedError(f"{desc}: {e}") from None
    return None


_ARGTYPES = {
    # x, w_all, y; B H W C O k pad BN skip TH TW NB NG CC S; params;
    # n_params order basis; extra, stream
    "kan_conv2d_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    # x, w_all, g, dx; B H W C O k pad skip TH NB NG CC OC stages table;
    # params; n_params order basis; extra, dextra, stream
    "kan_conv2d_bwd_dx": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
    # x, g, partial; B H W C O k pad CC BN P S ips PW; params; n_params
    # order basis; extra, stream
    "kan_conv2d_bwd_dw": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    # partial, out; S N VW Gw Gc; stream
    "kan_conv2d_bwd_dw_reduce": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _fn(name: str):
    """The C entry ``name``, its library built on first use."""
    from . import build

    lib = build.load(SOURCE if name == "kan_conv2d_fwd" else BWD_SOURCE)
    fn = getattr(lib, name)
    if not fn.argtypes:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, args, desc: str, key) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} for "
                           f"{desc}")
    _count_launch(name, key)


def _basis_args(basis: Basis, extra=None):
    """The basis's C arguments: its float32 parameters (kept alive by the
    returned array), their pointer and count, its order, its code and the
    device pointer of its learnable operand (NULL without one: it is never
    read back to the host)."""
    p = np.ascontiguousarray(basis.params, dtype=np.float32)
    return p, (p.ctypes.data_as(ctypes.c_void_p), len(p), basis.order,
               COMPILED[basis.key],
               None if extra is None else extra.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(x, w_all, basis, k, pad, cfg, extra=None):
    B, H, W, C = x.shape
    O = w_all.shape[1] // (k * k)
    y = torch.empty((B, H + 2 * pad - k + 1, W + 2 * pad - k + 1, O),
                    dtype=torch.float32, device=x.device)
    keep, bargs = _basis_args(basis, extra)
    _launch("kan_conv2d_fwd",
            (x.data_ptr(), w_all.data_ptr(), y.data_ptr(), B, H, W, C, O, k,
             pad, *(cfg[key] for key in FWD_TILE), *bargs, _stream(x)),
            _describe(B, H, W, C, O, k, pad, basis), basis.key)
    return y


def _check_grad(x, g, k, pad, O):
    B, H, W, _ = x.shape
    want = (B, H + 2 * pad - k + 1, W + 2 * pad - k + 1, O)
    if tuple(g.shape) != want:
        raise ValueError(f"output gradient must be {want}, got "
                         f"{tuple(g.shape)}")
    if g.device != x.device or g.dtype != x.dtype:
        raise TypeError(f"output gradient is {g.dtype} on {g.device}, x is "
                        f"{x.dtype} on {x.device}")
    if not g.is_contiguous():
        raise ValueError("output gradient must be contiguous")


def _check_extra(x, basis, extra):
    """The learnable operand: (n_extra,) exactly when the basis takes one,
    on x's device and of its dtype, contiguous."""
    if (extra is None) != (basis.n_extra == 0):
        raise ValueError(f"{basis} takes {basis.n_extra or 'no'} operand "
                         f"values, got {'none' if extra is None else 'one'}")
    if extra is not None and (tuple(extra.shape) != (basis.n_extra,) or
                              extra.device != x.device or
                              extra.dtype != x.dtype or
                              not extra.is_contiguous()):
        raise ValueError(f"the operand of {basis} must be a contiguous "
                         f"({basis.n_extra},) {x.dtype} tensor on "
                         f"{x.device}, got {tuple(extra.shape)} "
                         f"{extra.dtype} on {extra.device}")


def _check_kernel_args(x, O, basis, k, pad):
    B, H, W, C = x.shape
    desc = _describe(B, H, W, C, O, k, pad, basis)
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {x.dtype}")
    if basis.key not in COMPILED:
        raise NotImplementedError(f"{desc}: not carried by the kernels")
    return desc


def input_grad(x, w_all, g, basis: Basis, k: int, pad: int, extra=None):
    """dL/dx (B, H, W, C) for the output gradient g.  CUDA tensors: the
    data-gradient kernel; CPU tensors: ``input_grad_reference``."""
    return _data_grad(x, w_all, g, basis, k, pad, extra, True, False)[0]


def input_extra_grad(x, w_all, g, basis: Basis, k: int, pad: int, extra,
                     need_dx: bool = True):
    """(dL/dx or None, the (S, n_extra) partial sums of dL/dextra) of one
    data-gradient launch: block s of the tile writes row s
    (``extra_blocks``), and ``reduce_partials`` sums them in a fixed order.
    ``need_dx`` False (the first conv, whose input is the image): dx is not
    stored, only the partials.  CUDA tensors: the data-gradient kernel;
    CPU tensors: ``input_grad_reference`` and
    ``extra_partials_reference``."""
    if basis.n_extra == 0:
        raise ValueError(f"{basis} takes no operand")
    return _data_grad(x, w_all, g, basis, k, pad, extra, need_dx, True)


def _data_grad(x, w_all, g, basis, k, pad, extra, need_dx, need_extra):
    """(dx or None, extra partials or None) for the output gradient g; a
    basis with an operand always has its partials computed on CUDA (the
    kernel writes them; None is returned unless ``need_extra``)."""
    O = w_all.shape[1] // (k * k)
    _check_grad(x, g, k, pad, O)
    _check_extra(x, basis, extra)
    if x.device.type == "cpu":
        return (input_grad_reference(x, w_all, g, basis, k, pad, extra)
                if need_dx else None,
                extra_partials_reference(x, w_all, g, basis, k, pad, extra)
                if need_extra else None)
    desc = _check_kernel_args(x, O, basis, k, pad)
    B, H, W, C = x.shape
    try:
        cfg = dx_launch_config(B, H, W, C, O, k, pad, basis.R)
    except NotImplementedError as e:
        raise NotImplementedError(f"{desc}: {e}") from None
    # the kernel stages g and W_all as float4s of output channels: O is
    # padded with zero columns to a multiple of 4, and both are 16-byte
    # aligned
    O4 = -(-O // 4) * 4
    if O4 != O:
        g = torch.nn.functional.pad(g, (0, O4 - O))
        w_all = torch.nn.functional.pad(
            w_all.reshape(-1, k * k, O), (0, O4 - O)).reshape(-1, k * k * O4)
    if max(x.numel(), g.numel(), w_all.numel()) >= 2 ** 31:
        raise NotImplementedError(f"{desc}: tensor too large")
    if g.data_ptr() % 16:
        g = g.clone()
    if w_all.data_ptr() % 16 or not w_all.is_contiguous():
        w_all = w_all.clone(memory_format=torch.contiguous_format)
    dx = torch.empty_like(x) if need_dx else None
    part = torch.empty((cfg["tiles"] * -(-C // cfg["CC"]), basis.n_extra),
                       dtype=torch.float32, device=x.device) \
        if basis.n_extra else None
    keep, bargs = _basis_args(basis, extra)
    _launch("kan_conv2d_bwd_dx",
            (x.data_ptr(), w_all.data_ptr(), g.data_ptr(),
             None if dx is None else dx.data_ptr(), B, H, W, C, O4, k, pad,
             *(cfg[key] for key in DX_TILE), *bargs,
             None if part is None else part.data_ptr(), _stream(x)), desc,
            basis.key)
    return dx, part if need_extra else None


def weight_partials(x, g, basis: Basis, k: int, pad: int, extra=None):
    """The weight gradient's per-split partial sums (S, R*C, k*k*O) with
    the split of ``dw_launch_config``.  CUDA tensors: the weight-gradient
    kernel; CPU tensors: ``weight_partials_reference``."""
    O = g.shape[-1]
    _check_grad(x, g, k, pad, O)
    _check_extra(x, basis, extra)
    B, H, W, C = x.shape
    R = basis.R
    desc = _describe(B, H, W, C, O, k, pad, basis)
    try:
        cfg = dw_launch_config(B, H, W, C, O, k, pad, R)
    except NotImplementedError as e:
        raise NotImplementedError(f"{desc}: {e}") from None
    if x.device.type == "cpu":
        return weight_partials_reference(x, g, basis, k, pad, cfg["S"],
                                         cfg["ips"], extra)
    _check_kernel_args(x, O, basis, k, pad)
    if cfg["S"] * R * C * k * k * O >= 2 ** 31:
        raise NotImplementedError(f"{desc}: partial sums too large")
    partial = torch.empty((cfg["S"], R * C, k * k * O),
                          dtype=torch.float32, device=x.device)
    if g.data_ptr() % 16:   # the kernel loads g as float4s
        g = g.clone()
    keep, bargs = _basis_args(basis, extra)
    _launch("kan_conv2d_bwd_dw",
            (x.data_ptr(), g.data_ptr(), partial.data_ptr(), B, H, W, C, O, k,
             pad, cfg["CC"], cfg["BN"], cfg["P"], cfg["S"], cfg["ips"],
             cfg["PW"], *bargs, _stream(x)), desc, basis.key)
    return partial


def reduce_partials(partial, basis: Basis = None):
    """Sum (S, ...) partials over S in the order of
    ``reduce_launch_config``; ``basis``, the basis whose partials they are,
    only names the launch in ``launches_by_basis``.  CUDA tensors: the
    reduction kernel; CPU tensors: ``reduce_reference``."""
    if partial.device.type == "cpu":
        return reduce_reference(partial)
    if partial.dtype != torch.float32 or not partial.is_contiguous():
        raise TypeError("the reduction takes contiguous float32 partials")
    if partial.numel() >= 2 ** 31:
        raise NotImplementedError(f"partials {tuple(partial.shape)} too "
                                  "large")
    cfg = reduce_launch_config(partial.shape[0], partial[0].numel())
    out = torch.empty(partial.shape[1:], dtype=torch.float32,
                      device=partial.device)
    _launch("kan_conv2d_bwd_dw_reduce",
            (partial.data_ptr(), out.data_ptr(),
             *reduce_args(partial, out, cfg), _stream(partial)),
            f"partials {tuple(partial.shape)}",
            None if basis is None else basis.key)
    return out


def weight_grad(x, g, basis: Basis, k: int, pad: int, extra=None):
    """dL/dW_all (R*C, k*k*O) for the output gradient g.  CUDA tensors: the
    weight-gradient kernel and the ordered reduction (deterministic); CPU
    tensors: ``weight_grad_reference``."""
    if x.device.type == "cpu":
        _check_grad(x, g, k, pad, g.shape[-1])
        return weight_grad_reference(x, g, basis, k, pad, extra)
    return reduce_partials(weight_partials(x, g, basis, k, pad, extra),
                           basis)


class _KanConv2dFunction(torch.autograd.Function):
    """The CUDA KAN conv with its backward in the CUDA kernels.  Saves x,
    W_all and the basis's operand (E is recomputed, never kept); launches
    the data gradient when x or the operand needs it: for the first conv,
    whose input is the image, only where the operand needs it, with dx
    not stored.  W_all holds the base path's rows only where the basis has
    one, so no base gradient is formed without it."""

    @staticmethod
    def forward(ctx, x, w_all, extra, basis, k, pad, cfg):
        ctx.save_for_backward(x, w_all, extra)
        ctx.spec = (basis, k, pad)
        return _fwd(x, w_all, basis, k, pad, cfg, extra)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w_all, extra = ctx.saved_tensors
        g = g.contiguous()
        need_dx, need_dw, need_de = ctx.needs_input_grad[:3]
        dx = dw = de = None
        if need_de:
            dx, part = input_extra_grad(x, w_all, g, *ctx.spec, extra,
                                        need_dx=need_dx)
            de = reduce_partials(part, ctx.spec[0])
        elif need_dx:
            dx = input_grad(x, w_all, g, *ctx.spec, extra)
        if need_dw:
            dw = weight_grad(x, g, *ctx.spec, extra)
        return dx, dw, de, None, None, None, None


def kan_conv2d(x, base_w, poly_w, basis: Basis, k: int, pad: int,
               extra=None):
    """KAN conv pre-norm output (B, Ho, Wo, O) for x (B, H, W, C) NHWC;
    ``base_w`` None for a basis without a base path; ``extra`` the basis's
    learnable operand (Gram's beta), None for a basis without one.  CUDA
    tensors: the hand-written kernels (float32 only), forward and, when an
    input requires grad, backward.  CPU tensors: ``kan_conv2d_reference``
    under plain autograd."""
    cfg = check_inputs(x, base_w, poly_w, basis, k, pad,
                       for_kernel=x.device.type != "cpu", extra=extra)
    if x.device.type == "cpu":
        return kan_conv2d_reference(x, base_w, poly_w, basis, k, pad, extra)
    C, O = x.shape[-1], poly_w.shape[-1]
    # autograd carries dW_all back to base_w and poly_w through the packing
    w_all = pack_w_all(base_w, poly_w, C=C, K=basis.K, k=k, O=O,
                       degree_major=basis.degree_major)
    if torch.is_grad_enabled() and (
            x.requires_grad or w_all.requires_grad or
            (extra is not None and extra.requires_grad)):
        return _KanConv2dFunction.apply(x, w_all, extra, basis, k, pad, cfg)
    return _fwd(x, w_all, basis, k, pad, cfg, extra)
