"""B-spline KAN conv forward: the CUDA kernel's wrapper and its plain
PyTorch version.

``kan_conv2d`` computes the pre-norm output of a KAN conv (stride 1,
dilation 1, groups 1, NHWC):

    y[b,i,j,o] = sum_{di,dj} sum_r E[b,i+di,j+dj,r] * W_all[r, (di*k+dj)*O+o]
    E = [B_0(x) .. B_{K-1}(x), act(x)], zero on the pad AFTER expansion

which is what ``convkan_tpu/kernels/wide_kan_conv.py`` (``fwd_kernel``) and
``convkan_tpu/kernels/fused_kan_conv.py`` (``fused_kan_conv2d``) compute on
the TPU.  On a CUDA tensor it launches ``csrc/kan_conv2d_fwd.cu`` or raises;
on a CPU tensor it runs ``kan_conv2d_reference``.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..basis.bspline import bspline_basis_unrolled_list
from ..ops.conv import conv_nd
from ..utils.activations import ACTIVATIONS

SOURCE = "kan_conv2d_fwd.cu"
# what the compiled kernel carries: (number of knots, spline order) pairs
# and base activations, by the integer code the C entry takes
SPLINES = {(12, 3)}
ACTS = {"silu": 0, "gelu": 1}
THREADS, TM, TN = 256, 4, 4
MAX_CHUNK = 8                    # input channels expanded per pass
SMEM_LIMIT = 227 * 1024          # dynamic shared memory a block may use

_count_lock = threading.Lock()
launches = 0                     # kernel launches since the last reset


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def pack_w_all(base_w, poly_w, *, C: int, K: int, k: int, O: int):
    """(D, k*k*O) combined weights, D = (K+1)*C: rows kk*C + c hold basis kk
    of channel c, then C rows of the base path; columns (di*k+dj)*O + o.
    ``poly_w`` is HWIO (k, k, C*K, O) with channel-major rows c*K + kk."""
    pw = poly_w.reshape(k, k, C, K, O).permute(3, 2, 0, 1, 4)
    pw = pw.reshape(K * C, k * k * O)
    bw = base_w.permute(2, 0, 1, 3).reshape(C, k * k * O)
    return torch.cat([pw, bw], dim=0).contiguous()


def kan_conv2d_reference(x, base_w, poly_w, knots, order: int, k: int,
                         pad: int, act: str):
    """Plain PyTorch version: build the basis, concatenate the base path,
    and convolve (the convolution's zero padding is the mask after
    expansion).  float32 or float64, any device."""
    B, H, W, C = x.shape
    O = poly_w.shape[-1]
    K = len(knots) - order - 1
    cols = bspline_basis_unrolled_list(x, knots, order)
    E = torch.cat(cols + [ACTIVATIONS[act](x)], dim=-1)
    w = pack_w_all(base_w, poly_w, C=C, K=K, k=k, O=O)
    w_hwio = w.reshape((K + 1) * C, k, k, O).permute(1, 2, 0, 3)
    return conv_nd(E, w_hwio, padding=pad).contiguous()


def _describe(B, H, W, C, O, k, pad, n_knots, order, act) -> str:
    return (f"KAN conv x=({B},{H},{W},{C}) O={O} kernel={k} pad={pad} "
            f"knots={n_knots} order={order} act={act!r}")


def row_stride(K: int, CC: int) -> int:
    """Floats per pixel of the kernel's expanded tile: (K+1)*CC rounded up
    to whole float4s, made an odd number of float4s (mirrors the C entry)."""
    rs = -(-(K + 1) * CC // 4) * 4
    return rs + 4 if (rs // 4) % 2 == 0 else rs


def launch_config(B, H, W, C, O, k, pad, K) -> dict:
    """Block tile for the kernel: BN output channels, TH output rows, NB
    images and CC input channels per pass.  Raises NotImplementedError for
    a shape whose tile does not fit."""
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    BN = 4
    while BN < min(O, 64):
        BN *= 2
    M = THREADS // (BN // TN) * TM          # output pixels per block
    if Wo > M:
        raise NotImplementedError(f"output width {Wo} > {M} pixels per block")
    if Ho * Wo >= M:
        TH, NB = min(Ho, M // Wo), 1
    else:
        TH, NB = Ho, min(B, M // (Ho * Wo))
    tile = NB * (TH + k - 1) * (W + 2 * pad)
    for CC in range(min(C, MAX_CHUNK), 0, -1):
        # expanded tile, two weight slices, two int row tables
        if 4 * row_stride(K, CC) * (tile + 2 * BN + 2) <= SMEM_LIMIT:
            return {"BN": BN, "TH": TH, "NB": NB, "CC": CC}
    raise NotImplementedError("tile does not fit in shared memory")


def check_inputs(x, base_w, poly_w, knots, order, k, pad, act, *,
                 for_kernel: bool):
    """Validate what the caller passes (NHWC x, HWIO weights of matching
    shapes, contiguous, one device, float32 or float64); ``for_kernel``
    adds the kernel's own requirements (float32 CUDA tensors, a spline and
    activation the build carries, a tile that fits) and returns its
    launch_config."""
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    K = len(knots) - order - 1
    O = poly_w.shape[-1] if poly_w.ndim == 4 else -1
    if tuple(base_w.shape) != (k, k, C, O) or \
            tuple(poly_w.shape) != (k, k, C * K, O):
        raise ValueError(
            f"weights must be base_w ({k},{k},{C},O) and poly_w "
            f"({k},{k},{C * K},O); got {tuple(base_w.shape)} and "
            f"{tuple(poly_w.shape)}")
    if H + 2 * pad - k + 1 <= 0 or W + 2 * pad - k + 1 <= 0 or pad < 0:
        raise ValueError(f"empty output for {H}x{W}, kernel {k}, pad {pad}")
    for name, t in (("x", x), ("base_w", base_w), ("poly_w", poly_w)):
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
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown base activation {act!r}")
    if for_kernel:
        desc = _describe(B, H, W, C, O, k, pad, len(knots), order, act)
        if x.device.type != "cuda":
            raise ValueError(f"the kernel needs CUDA tensors, got {x.device}")
        if (len(knots), order) not in SPLINES or act not in ACTS:
            raise NotImplementedError(f"{desc}: not carried by the kernel")
        if max(x.numel(), B * H * W * O, poly_w.numel()) >= 2 ** 31:
            raise NotImplementedError(f"{desc}: tensor too large")
        try:
            return launch_config(B, H, W, C, O, k, pad, K)
        except NotImplementedError as e:
            raise NotImplementedError(f"{desc}: {e}") from None
    return None


def _lib():
    from . import build

    lib = build.load(SOURCE)
    fn = lib.kan_conv2d_fwd
    if not fn.argtypes:
        # x, w_all, y; B H W C O k pad BN TH NB CC; knots; n_knots order
        # act; stream
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kan_conv2d(x, base_w, poly_w, knots, order: int, k: int, pad: int,
               act: str):
    """KAN conv pre-norm output (B, Ho, Wo, O) for x (B, H, W, C) NHWC.
    CUDA tensors: the hand-written kernel (float32 only).  CPU tensors:
    ``kan_conv2d_reference``."""
    cfg = check_inputs(x, base_w, poly_w, knots, order, k, pad, act,
                       for_kernel=x.device.type != "cpu")
    if x.device.type == "cpu":
        return kan_conv2d_reference(x, base_w, poly_w, knots, order, k, pad,
                                    act)
    B, H, W, C = x.shape
    O = poly_w.shape[-1]
    K = len(knots) - order - 1
    fn = _lib()
    w_all = pack_w_all(base_w, poly_w, C=C, K=K, k=k, O=O)
    y = torch.empty((B, H + 2 * pad - k + 1, W + 2 * pad - k + 1, O),
                    dtype=torch.float32, device=x.device)
    kn = np.ascontiguousarray(knots, dtype=np.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_all.data_ptr(), y.data_ptr(), B, H, W, C, O, k,
             pad, cfg["BN"], cfg["TH"], cfg["NB"], cfg["CC"],
             kn.ctypes.data_as(ctypes.c_void_p), len(kn), order, ACTS[act],
             stream)
    if err != 0:
        raise RuntimeError(f"kan_conv2d_fwd launch failed with CUDA error "
                           f"{err} for "
                           + _describe(B, H, W, C, O, k, pad, len(kn), order,
                                       act))
    _count_launch()
    return y
