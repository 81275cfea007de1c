"""Mother wavelets for WavKAN, port of ``convkan_tpu/basis/wavelet.py``.

mexican_hat, morlet (omega0 = 5), DoG, Meyer (nu-polynomial auxiliary) and
Shannon (sinc times a Hamming window over the *input-channel* axis, a
reference quirk kept as it is).
"""

from __future__ import annotations

import math

import numpy as np
import torch

WAVELET_TYPES = ("mexican_hat", "morlet", "dog", "meyer", "shannon")


def _mexican_hat(x):
    term1 = torch.square(x) - 1.0
    term2 = torch.exp(-0.5 * torch.square(x))
    return (2.0 / (math.sqrt(3.0) * math.pi**0.25)) * term1 * term2


def _morlet(x):
    omega0 = 5.0
    return torch.exp(-0.5 * torch.square(x)) * torch.cos(omega0 * x)


def _dog(x):
    return -x * torch.exp(-0.5 * torch.square(x))


def _nu(t):
    return t**4 * (35 - 84 * t + 70 * t**2 - 20 * t**3)


def _meyer(x):
    v = torch.abs(x)
    pi = math.pi
    aux = torch.where(
        v <= 0.5,
        torch.ones_like(v),
        torch.where(v >= 1.0, torch.zeros_like(v),
                    torch.cos(pi / 2 * _nu(2 * v - 1))),
    )
    return torch.sin(pi * v) * aux


def _sinc(x):
    # torch.sinc(x) = sin(pi x)/(pi x); the reference calls torch.sinc(x/pi),
    # which equals sin(x)/x
    return torch.sinc(x)


def hamming_window(n: int):
    """torch.hamming_window(n, periodic=False), computed in float64 numpy
    (torch computes in the runtime dtype: equal to 1 ulp in float32)."""
    if n == 1:
        return np.ones(1, dtype=np.float64)
    i = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * math.pi * i / (n - 1))


def shannon(x, channel_axis: int):
    """Shannon wavelet: sinc(x/pi) windowed by a Hamming window laid out
    along ``channel_axis``."""
    n = x.shape[channel_axis]
    w = torch.from_numpy(hamming_window(n)).to(dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[channel_axis] = n
    return _sinc(x / math.pi) * w.reshape(shape)


def wavelet(x, wavelet_type: str, channel_axis: int = None):
    if wavelet_type == "mexican_hat":
        return _mexican_hat(x)
    if wavelet_type == "morlet":
        return _morlet(x)
    if wavelet_type == "dog":
        return _dog(x)
    if wavelet_type == "meyer":
        return _meyer(x)
    if wavelet_type == "shannon":
        if channel_axis is None:
            raise ValueError("the Shannon wavelet needs channel_axis")
        return shannon(x, channel_axis)
    raise ValueError(f"Unsupported wavelet type: {wavelet_type}")
