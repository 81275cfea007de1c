"""WavKAN psi-conv: the CUDA kernels' wrappers and their plain PyTorch
versions, forward and backward.

``wav_conv2d`` computes the wavelet path of a WavKAN conv before its 1x1
mix (stride 1, dilation 1, groups 1, NHWC):

    y[b,i,j,o] = sum_{c,di,dj} w[di,dj,c,o] * psi((x_pad[b,i+di,j+dj,c] - t[o,c]) / s[o,c])

with psi := 0 on the pad (the conv pads the psi map, not x), which is what
``convkan_tpu/kernels/fused_wav_conv.py`` (``_fwd_kernel``, and
``_bwd_kernel`` for its custom_vjp) computes on the TPU.  On a CUDA tensor
it launches ``csrc/wav_conv2d_fwd.cu`` or raises, and its gradient launches
the three kernels of ``csrc/wav_conv2d_bwd.cu``: the data gradient, the
parameter gradients (w, t, s) in per-split partial sums, and their ordered
reduction.  On a CPU tensor it runs ``wav_conv2d_reference`` under plain
autograd.  There is no fallback from a kernel to a plain version.

Shannon's Hamming window runs over the input channels, so psi_shannon =
ham[c] * sinc(z): the kernels see sin(z)/z and weights already multiplied
by the window, and autograd carries dw back through that product.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ..basis.wavelet import WAVELET_TYPES, hamming_window, wavelet
from ..ops.conv import conv_nd
from .kan_conv2d import (  # the same ordered sum
    reduce_args, reduce_launch_config, reduce_reference)

SOURCE = "wav_conv2d_fwd.cu"
BWD_SOURCE = "wav_conv2d_bwd.cu"
WAVELETS = {name: code for code, name in enumerate(WAVELET_TYPES)}
KERNEL_SIZES = {3}               # square kernels the compiled code carries
# forward (csrc/wav_conv2d_fwd.cu): blocks of FWD_THREADS threads, OG output
# channels (lanes, at most FWD_THREADS / FWD_CC) x tile slots; a thread
# keeps one output channel of a strip (the whole row of the compiled widths
# FWD_WIDTHS at pad 1, with their pad taps left out; else FWD_TW columns with
# a halo) over a band of rows, and stages x, the weights, -t/s and 1/s in
# chunks of FWD_CC input channels (FWD_QUAD floats per o and channel quad,
# an o's FWD_WSTRIDE).  fwd_launch_config owns this layout: the C entry takes
# its strides, grid and shared memory and only checks them
FWD_THREADS = 128
FWD_CC = 16
FWD_TW = 8
FWD_WIDTHS = (2, 4, 8)
FWD_QUAD = 4 * (9 + 2)
FWD_WSTRIDE = FWD_CC // 4 * FWD_QUAD + 4
# data gradient (csrc/wav_conv2d_bwd.cu): blocks of DX_THREADS threads; a
# thread keeps DX_CT input channels of a tile of pixels (a row segment of 8;
# rows of DX_WIDTHS compiled with their pad taps left out at pad 1: a row of
# 8 or 4, two rows of 2) and walks O in chunks of DX_OCH output channels,
# staged with the weights, 1/s, -t/s and psi''s factor (DX_GROUP floats per
# channel group and o)
DX_THREADS = 128
DX_CT = 4
DX_OCH = 8
DX_GROUP = 4 * (9 + 4)
DX_WIDTHS = (2, 4, 8)
# parameter kernel (csrc/wav_conv2d_bwd.cu): a thread keeps PARAM_CT input
# channels' sums (9 dw, dt, ds each) of one output channel; a step gives a
# thread at least PARAM_PIXELS pixels; rows of the widths PARAM_WIDTHS are
# compiled (pad 1)
PARAM_CT = 4
PARAM_VALS = PARAM_CT * 11
PARAM_THREADS = 128              # threads of a block, at most
PARAM_PIXELS = 64
PARAM_WIDTHS = (2, 4, 8, 16, 32)
# the H100 SXM: SMs, shared memory per SM and per block (bytes, 1 KB of the
# SM's kept per block), registers per SM; the kernel's __launch_bounds__
# (PARAM_THREADS threads, 3 blocks) caps a thread at PARAM_REGS registers
SMS = 132
SM_SMEM = 228 * 1024
BLOCK_SMEM_MAX = 227 * 1024
SM_REGS = 65536
PARAM_REGS = 168
DX_REGS = 168                    # __launch_bounds__(DX_THREADS, 3)
FWD_REGS = 128                   # __launch_bounds__(FWD_THREADS, 4)
# shared memory a parameter block aims at: 3 of them fit on an SM
PARAM_SMEM = SM_SMEM // 3 - 1024
# a split with fewer partials is taken when its cost (_param_split) is
# within this share of the least
PARAM_SPLIT_SLACK = 0.05

KERNELS = ("wav_conv2d_fwd", "wav_conv2d_bwd_dx", "wav_conv2d_bwd_param",
           "wav_conv2d_bwd_reduce")
_count_lock = threading.Lock()
launches = dict.fromkeys(KERNELS, 0)   # launches per kernel since the reset


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count_launch(name: str) -> None:
    with _count_lock:
        launches[name] += 1


# ------------------------------------------------------- psi and psi'
# The closed forms of convkan_tpu/kernels/fused_wav_conv.py (PSI), term for
# term; csrc/wav_conv2d_*.cu evaluate the same expressions in float32.
_MH_C = 2.0 / (math.sqrt(3.0) * math.pi**0.25)


def _psi_mexican_hat(z):
    e = torch.exp(-0.5 * z * z)
    return _MH_C * (z * z - 1.0) * e


def _dpsi_mexican_hat(z):
    e = torch.exp(-0.5 * z * z)
    return _MH_C * z * e * (3.0 - z * z)


def _psi_morlet(z):
    return torch.exp(-0.5 * z * z) * torch.cos(5.0 * z)


def _dpsi_morlet(z):
    e = torch.exp(-0.5 * z * z)
    return -e * (z * torch.cos(5.0 * z) + 5.0 * torch.sin(5.0 * z))


def _psi_dog(z):
    return -z * torch.exp(-0.5 * z * z)


def _dpsi_dog(z):
    return (z * z - 1.0) * torch.exp(-0.5 * z * z)


def _nu(t):
    return t**4 * (35.0 - 84.0 * t + 70.0 * t * t - 20.0 * t**3)


def _dnu(t):
    # 140 t^3 (1 - t)^3
    u = 1.0 - t
    return 140.0 * t**3 * u * u * u


def _meyer_aux(v):
    one, zero = torch.ones_like(v), torch.zeros_like(v)
    return torch.where(v <= 0.5, one, torch.where(
        v >= 1.0, zero, torch.cos(math.pi / 2.0 * _nu(2.0 * v - 1.0))))


def _psi_meyer(z):
    v = torch.abs(z)
    return torch.sin(math.pi * v) * _meyer_aux(v)


def _dpsi_meyer(z):
    pi = math.pi
    v = torch.abs(z)
    aux = _meyer_aux(v)
    band = torch.logical_and(v > 0.5, v < 1.0)
    daux = torch.where(
        band,
        -pi * torch.sin(pi / 2.0 * _nu(2.0 * v - 1.0)) * _dnu(2.0 * v - 1.0),
        torch.zeros_like(v))
    dv = pi * torch.cos(pi * v) * aux + torch.sin(pi * v) * daux
    return torch.sign(z) * dv


def _psi_shannon(z):
    # sinc(z/pi) = sin(z)/z; the Hamming window is folded into the weights
    zero = z == 0.0
    zs = torch.where(zero, torch.ones_like(z), z)
    return torch.where(zero, torch.ones_like(z), torch.sin(zs) / zs)


def _dpsi_shannon(z):
    small = torch.abs(z) < 1e-4
    zs = torch.where(small, torch.ones_like(z), z)
    exact = (zs * torch.cos(zs) - torch.sin(zs)) / (zs * zs)
    series = -z / 3.0 + (z**3) / 30.0
    return torch.where(small, series, exact)


PSI = {
    "mexican_hat": (_psi_mexican_hat, _dpsi_mexican_hat),
    "morlet": (_psi_morlet, _dpsi_morlet),
    "dog": (_psi_dog, _dpsi_dog),
    "meyer": (_psi_meyer, _dpsi_meyer),
    "shannon": (_psi_shannon, _dpsi_shannon),
}


# ------------------------------------------------------ plain versions
def _z(x, t, s):
    """(B, H, W, O, C): (x - t) / s for every output channel."""
    return (x[..., None, :] - t) / s


def _grouped_conv(psi, w, pad: int):
    """psi (B, H, W, O, C) flattened to channel o*C + c, convolved with
    groups=O (group o reads its C channels); the conv's zero padding is the
    psi := 0 on the pad."""
    B, H, W, O, C = psi.shape
    return conv_nd(psi.reshape(B, H, W, O * C), w, padding=pad,
                   groups=O).contiguous()


def wav_conv2d_reference(x, wav_w, translation, scale, *, wavelet_type: str,
                         padding: int):
    """Plain PyTorch version of ``wav_conv2d``, the XLA path of the JAX
    module: materialize psi (Shannon windowed over the input channels),
    then a grouped conv.  float32 or float64, any device, differentiable."""
    psi = wavelet(_z(x, translation, scale), wavelet_type, channel_axis=-1)
    return _grouped_conv(psi, wav_w, padding)


def psi_conv_reference(x, w, t, s, wavelet_type: str, pad: int):
    """The kernels' function in plain PyTorch: psi from the PSI table (for
    Shannon without its window, which the caller folds into w)."""
    return _grouped_conv(PSI[wavelet_type][0](_z(x, t, s)), w, pad)


def input_grad_reference(x, w, t, s, g, wavelet_type: str, pad: int):
    """Plain version of the data-gradient kernel: dL/dx of
    ``psi_conv_reference`` for the output gradient g, by autograd."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        y = psi_conv_reference(xr, w.detach(), t.detach(), s.detach(),
                               wavelet_type, pad)
        return torch.autograd.grad(y, xr, g)[0]


def param_grads_reference(x, w, t, s, g, wavelet_type: str, pad: int):
    """Plain version of the parameter gradients: [dw (k,k,C,O), dt (O,C),
    ds (O,C)] of ``psi_conv_reference`` for g, flattened and concatenated
    (the kernel's partial layout), by autograd."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in (w, t, s)]
        y = psi_conv_reference(x.detach(), *leaves, wavelet_type, pad)
        grads = torch.autograd.grad(y, leaves, g)
    return torch.cat([d.reshape(-1) for d in grads])


def param_partials_reference(x, w, t, s, g, wavelet_type: str, pad: int,
                             splits: int, ips: int):
    """Plain version of the parameter kernel: the (splits, N) partial sums,
    split q over images [q*ips, q*ips + ips)."""
    return torch.stack([
        param_grads_reference(x[q * ips:(q + 1) * ips], w, t, s,
                              g[q * ips:(q + 1) * ips], wavelet_type, pad)
        for q in range(splits)])


def split_param_grads(flat, k: int, C: int, O: int):
    """(dw (k,k,C,O), dt (O,C), ds (O,C)) from the flat layout."""
    n = k * k * C * O
    return (flat[:n].reshape(k, k, C, O), flat[n:n + O * C].reshape(O, C),
            flat[n + O * C:].reshape(O, C))


# ---------------------------------------------------------- launch configs
def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _describe(B, H, W, C, O, k, pad, wavelet_type) -> str:
    return (f"WavKAN conv x=({B},{H},{W},{C}) O={O} kernel={k} pad={pad} "
            f"wavelet={wavelet_type!r}")


def fwd_launch_config(B, H, W, C, O, k, pad) -> dict:
    """Forward block (csrc/wav_conv2d_fwd.cu): FWD_THREADS threads, ``OG``
    output channels (lanes) x ``NT`` tile slots, a slot a (strip, image); a
    thread walks the input rows of a band of ``RB`` output rows.  ``WT``: a
    compiled width (pad 1, W in FWD_WIDTHS: the whole row, ``TW`` = W, its
    pad taps left out), else 0 (strips of ``TW`` = FWD_TW with a halo of
    k - 1 columns; ``TWH`` columns staged).  OG balances a chunk's staged x
    (NT slots' columns) against its weights.  RB is the band that costs
    least: the busiest SM's blocks (at least the ``blocks_per_sm`` that run
    at once) x the input rows a band reads, the tallest band on a tie.
    The config owns the staging layout, which the C entry takes as given
    (checking only that it holds what the kernel reads): ``slotStride``
    floats of a slot's staged x (TWH columns of FWD_CC channels, + 4
    against bank conflicts), ``wStride`` of an o's weights (FWD_WSTRIDE),
    ``smem`` bytes for two buffers of the slots' x and the weights, and the
    ``grid``.  Raises NotImplementedError where the launch does not fit."""
    return dict(_fwd_config(B, H, W, C, O, k, pad))


@functools.lru_cache(maxsize=None)
def _fwd_config(B, H, W, C, O, k, pad) -> dict:
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    compiled = pad == 1 and W in FWD_WIDTHS
    WT = W if compiled else 0
    TW = WT or FWD_TW
    TWH = TW if compiled else TW + k - 1
    # the power of two at most sqrt(FWD_THREADS * TWH / (k * k)) keeps the
    # staged x plus weights near their least (4 o at 4 and 2 staged
    # columns, 8 at 8 and 10)
    OG = 1
    while 2 * OG <= FWD_THREADS // FWD_CC and \
            (2 * OG) ** 2 * k * k <= FWD_THREADS * TWH:
        OG *= 2
    OG = min(OG, _pow2_at_least(O))
    NT = FWD_THREADS // OG
    tiles = B * -(-Wo // TW)
    slot_stride = TWH * FWD_CC + 4
    smem = 4 * 2 * (NT * slot_stride + OG * FWD_WSTRIDE)
    fit = min(SM_REGS // (FWD_THREADS * FWD_REGS), SM_SMEM // (smem + 1024),
              2048 // FWD_THREADS, 32)
    o_tiles, tile_blocks = -(-O // OG), -(-tiles // NT)

    def cost(RB):
        blocks = tile_blocks * -(-Ho // RB) * o_tiles
        return max(-(-blocks // SMS), fit) * min(RB + k - 1, H)

    # Ho, then the powers of two below it, tallest first
    RB = min([Ho] + [1 << e for e in reversed(range((Ho - 1).bit_length()))],
             key=cost)
    bands = -(-Ho // RB)
    grid = (tile_blocks * bands, o_tiles)
    if tiles >= 2 ** 31 or grid[0] >= 2 ** 31 or grid[1] > 65535 or \
            smem > BLOCK_SMEM_MAX:
        raise NotImplementedError("forward launch does not fit")
    blocks = grid[0] * grid[1]
    return {"WT": WT, "compiled": compiled, "TW": TW, "TWH": TWH, "OG": OG,
            "NT": NT, "RB": RB, "bands": bands, "CC": FWD_CC,
            "slotStride": slot_stride, "wStride": FWD_WSTRIDE,
            "threads": FWD_THREADS, "smem": smem, "grid": grid,
            "blocks": blocks, "blocks_per_sm": fit,
            "waves": blocks / (SMS * fit)}


def dx_launch_config(B, H, W, C, O, k, pad) -> dict:
    """Data-gradient block (csrc/wav_conv2d_bwd.cu): DX_THREADS threads,
    lanes of CG channel groups (DX_CT channels each) x 32 / CG images, the
    warps at NPB tile positions (row groups of RT rows) x 4 / NPB image
    groups (NIB images a block); a thread's tile is RT rows x P pixels.
    ``WT``: a compiled width (pad 1: 8 or 4 with H >= 2, 2 with H even;
    its pad taps left out), else 0 (segments of 8, every tap).  ``smem``:
    one buffer (two when O takes more than one chunk of DX_OCH) of the
    block's g rect (NGR rows x P + 2 columns x DX_OCH per image, stride
    ``img_stride``) and the chunk's weights and factors.  Raises
    NotImplementedError where the grid or the buffers do not fit."""
    return dict(_dx_config(B, H, W, C, O, k, pad))


@functools.lru_cache(maxsize=None)
def _dx_config(B, H, W, C, O, k, pad) -> dict:
    compiled = pad == 1 and W in DX_WIDTHS and (
        H % 2 == 0 if W == 2 else H >= 2)
    WT = W if compiled else 0
    P = WT or 8
    RT = 2 if WT == 2 else 1
    CG = 4 if C <= 16 else 8
    nseg, nrg = -(-W // P), -(-H // RT)
    NPB = min(4, _pow2_at_least(nrg))
    NIB = 32 // CG * (4 // NPB)
    NGR = NPB * RT + k - 1
    img_stride = NGR * (P + k - 1) * DX_OCH + 4
    buf = NIB * img_stride + DX_OCH * CG * DX_GROUP
    nbuf = 2 if O > DX_OCH else 1
    smem = 4 * nbuf * buf
    grid = (-(-B // NIB) * nseg * -(-nrg // NPB), -(-C // (DX_CT * CG)))
    if smem > BLOCK_SMEM_MAX or grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise NotImplementedError("data-gradient grid or buffers too large")
    fit = min(SM_REGS // (DX_THREADS * DX_REGS), SM_SMEM // (smem + 1024),
              2048 // DX_THREADS, 32)
    blocks = grid[0] * grid[1]
    return {"WT": WT, "compiled": compiled, "P": P, "RT": RT, "CG": CG,
            "CT": DX_CT, "NPB": NPB, "NIB": NIB, "NGR": NGR,
            "img_stride": img_stride, "threads": DX_THREADS, "smem": smem,
            "grid": grid, "blocks": blocks, "blocks_per_sm": fit,
            "waves": blocks / (SMS * fit)}


def _param_smem(W, OC, gcols, threads, cg, rs, rb, pipe) -> int:
    """Bytes of shared memory of a parameter block: the ring of g rows
    (2*rb + 2 with pipe, else rb + 2; rounded to 16 bytes) and the x
    buffers, or the row slots' sums at the end where larger."""
    ring = ((2 * rb + 2 if pipe else rb + 2) * gcols * OC + 3) // 4 * 4
    floats = ring + (2 if pipe else 1) * rb * W * PARAM_CT * cg
    return 4 * max(floats, PARAM_VALS * threads if rs > 1 else 0)


def _param_tile(W, C, O, k, pad):
    """The parameter block: the first that fits of whole-warp blocks of
    OC lanes (output channels) x CG channel groups x RS row slots,
    PARAM_THREADS threads first, RB = RS x rows per slot (at least
    PARAM_PIXELS pixels a slot, halved down to one row) within PARAM_SMEM,
    then within the block's maximum; last, one warp of one row without the
    pipeline."""
    OC = min(32, _pow2_at_least(O))
    CG = min(PARAM_THREADS // OC, _pow2_at_least(-(-C // PARAM_CT)))
    compiled = pad == 1 and W in PARAM_WIDTHS
    for budget in (PARAM_SMEM, BLOCK_SMEM_MAX):
        for threads in (PARAM_THREADS, PARAM_THREADS // 2,
                        PARAM_THREADS // 4):
            cg = min(CG, threads // OC)
            rs = threads // (OC * cg)
            tr = _pow2_at_least(-(-PARAM_PIXELS // W))
            while tr >= 1:
                rb = rs * tr
                gcols = W if compiled else W + k - 1
                smem = _param_smem(W, OC, gcols, threads, cg, rs, rb, True)
                if smem <= budget:
                    return (OC, cg, rs, rb, threads, True, compiled, smem)
                tr //= 2
    smem = _param_smem(W, OC, W + k - 1, 32, 1, 1, 1, False)
    if smem <= BLOCK_SMEM_MAX:
        return (OC, 1, 1, 1, 32, False, False, smem)
    raise NotImplementedError(f"input width {W} too wide for the parameter "
                              "kernel")


def _param_split(B, tiles, fit) -> int:
    """Images per split.  The blocks share the SMs' issue slots, so a
    split costs about the blocks of the busiest SM (at least the ``fit``
    that are resident at once) x images per block; the fewest splits
    within PARAM_SPLIT_SLACK of the least cost are taken (more splits
    write and reduce more partials)."""
    cands = {}
    for S in range(1, min(B, 65535) + 1):
        ips = -(-B // S)
        cands[-(-B // ips)] = ips
    cost = {S: max(-(-tiles * S // SMS), fit) * ips
            for S, ips in cands.items()}
    least = min(cost.values())
    return cands[min(S for S in cands
                     if cost[S] <= least * (1 + PARAM_SPLIT_SLACK))]


def param_launch_config(B, H, W, C, O, k, pad) -> dict:
    """Parameter-gradient block (csrc/wav_conv2d_bwd.cu): ``threads`` =
    OC output channels (lanes) x CG groups of PARAM_CT input channels x RS
    row slots, stepping through RB rows; ``pipe``: cp.async into a
    double-buffered ring; ``compiled``: a compiled row width with its pad
    taps left out.  S batch splits of ``ips`` images, chosen from the
    blocks that fit on an SM (``blocks_per_sm``: shared memory, registers
    at PARAM_REGS, threads) so that the busiest SM's share of the blocks
    is least (``_param_split``; ``waves``: blocks over the slots).  S
    depends on the shape only, so a shape always gets the same partial
    sums and the same reduction order.  Raises NotImplementedError where
    no block fits."""
    return dict(_param_config(B, H, W, C, O, k, pad))


@functools.lru_cache(maxsize=None)
def _param_config(B, H, W, C, O, k, pad) -> dict:
    OC, CG, RS, RB, threads, pipe, compiled, smem = _param_tile(W, C, O, k,
                                                                pad)
    tiles = -(-O // OC) * -(-C // (PARAM_CT * CG))
    fit = min(SM_REGS // (threads * PARAM_REGS), SM_SMEM // (smem + 1024),
              2048 // threads, 32)
    ips = _param_split(B, tiles, fit)
    S = -(-B // ips)
    return {"OC": OC, "CG": CG, "CT": PARAM_CT, "RS": RS, "RB": RB,
            "threads": threads, "pipe": pipe, "compiled": compiled,
            "S": S, "ips": ips, "N": k * k * C * O + 2 * O * C,
            "smem": smem, "blocks_per_sm": fit, "tiles": tiles,
            "blocks": tiles * S, "waves": tiles * S / (SMS * fit)}


# ------------------------------------------------------------- checks
def check_inputs(x, w, t, s, wavelet_type, pad, *, for_kernel: bool):
    """Validate what the caller passes (NHWC x, (k,k,C,O) weights, (O,C)
    translation and scale, contiguous, one device, float32 or float64);
    ``for_kernel`` adds the kernels' own requirements (float32 CUDA
    tensors, a kernel size the build carries, a tile that fits) and returns
    the forward's launch config."""
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    k = w.shape[0] if w.ndim == 4 else -1
    O = w.shape[-1] if w.ndim == 4 else -1
    if w.ndim != 4 or tuple(w.shape[:3]) != (k, k, C):
        raise ValueError(f"wav_w must be ({k},{k},{C},O), got "
                         f"{tuple(w.shape)}")
    for name, a in (("translation", t), ("scale", s)):
        if tuple(a.shape) != (O, C):
            raise ValueError(f"{name} must be ({O},{C}), got "
                             f"{tuple(a.shape)}")
    if pad < 0 or H + 2 * pad - k + 1 <= 0 or W + 2 * pad - k + 1 <= 0:
        raise ValueError(f"empty output for {H}x{W}, kernel {k}, pad {pad}")
    for name, a in (("x", x), ("wav_w", w), ("translation", t),
                    ("scale", s)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if for_kernel and a.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {a.dtype}")
        if a.dtype not in (torch.float32, torch.float64) or \
                a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x is {x.dtype}: both "
                            "float32 (or float64 on the CPU) expected")
    if wavelet_type not in WAVELETS:
        raise ValueError(f"unknown wavelet type {wavelet_type!r}")
    if not for_kernel:
        return None
    desc = _describe(B, H, W, C, O, k, pad, wavelet_type)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {x.device}")
    if k not in KERNEL_SIZES:
        raise NotImplementedError(f"{desc}: not carried by the kernel")
    if max(x.numel(), B * H * W * O, w.numel()) >= 2 ** 31:
        raise NotImplementedError(f"{desc}: tensor too large")
    try:
        return fwd_launch_config(B, H, W, C, O, k, pad)
    except NotImplementedError as e:
        raise NotImplementedError(f"{desc}: {e}") from None


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


def _check_kernel_args(x, w, wavelet_type, pad) -> str:
    B, H, W, C = x.shape
    k, O = w.shape[0], w.shape[-1]
    desc = _describe(B, H, W, C, O, k, pad, wavelet_type)
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {x.dtype}")
    if k not in KERNEL_SIZES or wavelet_type not in WAVELETS:
        raise NotImplementedError(f"{desc}: not carried by the kernels")
    return desc


# ---------------------------------------------------------- launching
_ARGTYPES = {
    # x, w, t, s, y; B H W C O k pad WT OG RB slotStride wStride grid smem
    # wavelet; stream
    "wav_conv2d_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
    + [ctypes.c_void_p],
    # x, w, t, s, g, dx; B H W C O k pad WT CG NPB wavelet; stream
    "wav_conv2d_bwd_dx": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    # x, w, t, s, g, partial; B H W C O k pad OC CG RS RB threads pipe S ips
    # wavelet; stream
    "wav_conv2d_bwd_param": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16
    + [ctypes.c_void_p],
    # partial, out; S N VW Gw Gc; stream
    "wav_conv2d_bwd_reduce": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _fn(name: str):
    """The C entry ``name``, its library built on first use."""
    from . import build

    lib = build.load(SOURCE if name == "wav_conv2d_fwd" else BWD_SOURCE)
    fn = getattr(lib, name)
    if not fn.argtypes:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, args, desc: str) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} for "
                           f"{desc}")
    _count_launch(name)


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def _ptrs(*tensors):
    return tuple(a.data_ptr() for a in tensors)


def _fwd(x, w, t, s, wavelet_type, pad, cfg):
    B, H, W, C = x.shape
    k, O = w.shape[0], w.shape[-1]
    y = torch.empty((B, H + 2 * pad - k + 1, W + 2 * pad - k + 1, O),
                    dtype=torch.float32, device=x.device)
    _launch("wav_conv2d_fwd",
            _ptrs(x, w, t, s, y) + (B, H, W, C, O, k, pad) +
            tuple(cfg[key] for key in ("WT", "OG", "RB", "slotStride",
                                       "wStride")) +
            tuple(cfg["grid"]) + (cfg["smem"], WAVELETS[wavelet_type],
                                  _stream(x)),
            _describe(B, H, W, C, O, k, pad, wavelet_type))
    return y


def input_grad(x, w, t, s, g, wavelet_type: str, pad: int):
    """dL/dx (B, H, W, C) for the output gradient g (w already windowed for
    Shannon).  CUDA tensors: the data-gradient kernel; CPU tensors:
    ``input_grad_reference``."""
    k, O = w.shape[0], w.shape[-1]
    _check_grad(x, g, k, pad, O)
    if x.device.type == "cpu":
        return input_grad_reference(x, w, t, s, g, wavelet_type, pad)
    desc = _check_kernel_args(x, w, wavelet_type, pad)
    B, H, W, C = x.shape
    try:
        cfg = dx_launch_config(B, H, W, C, O, k, pad)
    except NotImplementedError as e:
        raise NotImplementedError(f"{desc}: {e}") from None
    dx = torch.empty_like(x)
    _launch("wav_conv2d_bwd_dx",
            _ptrs(x, w, t, s, g, dx) + (B, H, W, C, O, k, pad, cfg["WT"],
                                        cfg["CG"], cfg["NPB"],
                                        WAVELETS[wavelet_type], _stream(x)),
            desc)
    return dx


def param_partials(x, w, t, s, g, wavelet_type: str, pad: int):
    """The parameter gradients' per-split partial sums (S, N), N = k*k*C*O
    + 2*O*C ([dw, dt, ds] flattened), with the split of
    ``param_launch_config``.  CUDA tensors: the parameter kernel; CPU
    tensors: ``param_partials_reference``."""
    k, O = w.shape[0], w.shape[-1]
    _check_grad(x, g, k, pad, O)
    B, H, W, C = x.shape
    desc = _describe(B, H, W, C, O, k, pad, wavelet_type)
    try:
        cfg = param_launch_config(B, H, W, C, O, k, pad)
    except NotImplementedError as e:
        raise NotImplementedError(f"{desc}: {e}") from None
    if x.device.type == "cpu":
        return param_partials_reference(x, w, t, s, g, wavelet_type, pad,
                                        cfg["S"], cfg["ips"])
    _check_kernel_args(x, w, wavelet_type, pad)
    if cfg["S"] * cfg["N"] >= 2 ** 31:
        raise NotImplementedError(f"{desc}: partial sums too large")
    partial = torch.empty((cfg["S"], cfg["N"]), dtype=torch.float32,
                          device=x.device)
    _launch("wav_conv2d_bwd_param",
            _ptrs(x, w, t, s, g, partial) + (
                B, H, W, C, O, k, pad, cfg["OC"], cfg["CG"], cfg["RS"],
                cfg["RB"], cfg["threads"], int(cfg["pipe"]), cfg["S"],
                cfg["ips"], WAVELETS[wavelet_type], _stream(x)),
            desc)
    return partial


def reduce_partials(partial):
    """Sum (S, N) partials over S in the order of ``reduce_launch_config``
    (the kernel the KAN weight gradient shares).  CUDA tensors: the
    reduction kernel; CPU tensors: ``reduce_reference``."""
    if partial.device.type == "cpu":
        return reduce_reference(partial)
    if partial.dtype != torch.float32 or not partial.is_contiguous() or \
            partial.ndim != 2:
        raise TypeError("the reduction takes contiguous float32 (S, N) "
                        "partials")
    if partial.numel() >= 2 ** 31:
        raise NotImplementedError(f"partials {tuple(partial.shape)} too "
                                  "large")
    S, N = partial.shape
    cfg = reduce_launch_config(S, N)
    out = torch.empty(N, dtype=torch.float32, device=partial.device)
    _launch("wav_conv2d_bwd_reduce",
            _ptrs(partial, out) + (*reduce_args(partial, out, cfg),
                                   _stream(partial)),
            f"partials {tuple(partial.shape)}")
    return out


def param_grads(x, w, t, s, g, wavelet_type: str, pad: int):
    """(dw, dt, ds) for the output gradient g.  CUDA tensors: the parameter
    kernel and the ordered reduction (deterministic); CPU tensors:
    ``param_grads_reference``."""
    k, C, O = w.shape[0], x.shape[-1], w.shape[-1]
    if x.device.type == "cpu":
        _check_grad(x, g, k, pad, O)
        flat = param_grads_reference(x, w, t, s, g, wavelet_type, pad)
    else:
        flat = reduce_partials(param_partials(x, w, t, s, g, wavelet_type,
                                              pad))
    return split_param_grads(flat, k, C, O)


class _WavConv2dFunction(torch.autograd.Function):
    """The CUDA psi-conv with its backward in the CUDA kernels.  Saves x, w,
    t and s (psi is recomputed, never kept); launches the data gradient only
    when x needs it (never for the first conv, whose input is the image),
    and the parameter kernel when w, t or s needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, t, s, wavelet_type, pad, cfg):
        ctx.save_for_backward(x, w, t, s)
        ctx.spec = (wavelet_type, pad)
        return _fwd(x, w, t, s, wavelet_type, pad, cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, t, s = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = dt = ds = None
        if ctx.needs_input_grad[0]:
            dx = input_grad(x, w, t, s, g, *ctx.spec)
        if any(ctx.needs_input_grad[1:4]):
            dw, dt, ds = param_grads(x, w, t, s, g, *ctx.spec)
        return dx, dw, dt, ds, None, None, None


def wav_conv2d(x, wav_w, translation, scale, *, wavelet_type: str,
               padding: int):
    """WavKAN psi-conv (B, Ho, Wo, O) for x (B, H, W, C) NHWC, wav_w
    (k, k, C, O), translation and scale (O, C).  CUDA tensors: the
    hand-written kernels (float32 only), forward and, when an input
    requires grad, backward.  CPU tensors: ``wav_conv2d_reference`` under
    plain autograd."""
    cfg = check_inputs(x, wav_w, translation, scale, wavelet_type, padding,
                       for_kernel=x.device.type != "cpu")
    if x.device.type == "cpu":
        return wav_conv2d_reference(x, wav_w, translation, scale,
                                    wavelet_type=wavelet_type,
                                    padding=padding)
    w = wav_w
    if wavelet_type == "shannon":
        # psi_shannon = ham[c] * sinc(z): fold the window into the weights;
        # autograd restores dw through the product
        ham = torch.from_numpy(hamming_window(x.shape[-1])).to(w)
        w = (w * ham[None, None, :, None]).contiguous()
    args = (x, w, translation, scale, wavelet_type, padding, cfg)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, w, translation, scale)):
        return _WavConv2dFunction.apply(*args)
    return _fwd(*args)
