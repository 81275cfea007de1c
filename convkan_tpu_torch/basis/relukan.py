"""ReLU-KAN squared-window basis, port of ``convkan_tpu/basis/relukan.py``
(layers/relu_kan_layers.py:125-129):

    b_j(x) = [relu(x - lo_j) * relu(hi_j - x) * r]^2,  r = 4 g^2/(k+1)^2

over g+k phase windows per input channel, with the default phases
lo_j = (j - k)/g for j = 0..g+k-1 and hi_j = lo_j + (k+1)/g.
"""

from __future__ import annotations

import numpy as np
import torch


def default_phases(g: int, k: int):
    """The default (phase_low, phase_high) float32 vectors of length g+k
    (relu_kan_layers.py:96-97)."""
    low = np.arange(-k, g, dtype=np.float32) / g
    high = low + (k + 1) / g
    return low, high


def relukan_basis(x, phase_low, phase_high, g: int, k: int):
    """x: (...,); phase_low/high broadcast against x[..., None] (per-channel
    windows of g+k).  Returns (..., g+k)."""
    r = 4.0 * g * g / ((k + 1.0) * (k + 1.0))
    xe = x[..., None]
    y = torch.clamp_min(xe - phase_low, 0.0) * \
        torch.clamp_min(phase_high - xe, 0.0) * r
    return y * y
