"""KAN-EfficientNet (V1), port of ``convkan_tpu/models/efficientnet.py``: the
all-MBConv tables (B0 and the reduced-depth CIFAR table) with SE and
block-index-scaled stochastic depth on the EfficientNet engine of
``models/efficientnetv2.py``; ``b0``, ``b1``, ``b2`` and the
``b0_small`` .. ``b2_small`` CIFAR variants (kan_efficientnet.py:447-463,
543-558, 596-611).  The JAX package builds the reference's intended V1
on that engine (its kanconv path crashes as written); so does the port.
"""

from __future__ import annotations

from typing import List

from .efficientnetv2 import MBConfig, _build, _cfg
from .mobilenet import _make_divisible


def efficientnet_conf(width_mult: float, depth_mult: float,
                      se_ratio: float = 0.25) -> List[MBConfig]:
    """kan_efficientnet.py:447-459 (B0 table)."""
    table = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
             (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3),
             (6, 5, 2, 112, 192, 4), (6, 3, 1, 192, 320, 1)]
    return [_cfg("mbconv", t, k, s, ci, co, n, width_mult, depth_mult,
                 se_ratio) for t, k, s, ci, co, n in table]


def efficientnet_small_conf(width_mult=0.5, depth_mult=0.5, se_ratio=0.25
                            ) -> List[MBConfig]:
    """kan_efficientnet.py:543-558 (reduced-depth CIFAR table)."""
    table = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 1), (6, 5, 2, 24, 40, 2),
             (6, 3, 1, 40, 80, 2), (6, 5, 2, 80, 112, 2),
             (6, 5, 1, 112, 192, 3), (6, 3, 1, 192, 320, 1)]
    return [_cfg("mbconv", t, k, s, ci, co, n, width_mult, depth_mult,
                 se_ratio) for t, k, s, ci, co, n in table]


# arch: (width, depth, dropout)
_V1_ARCHES = {"b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2),
              "b2": (1.1, 1.2, 0.3)}

# arch: (width, depth, dropout, sd_prob, se_ratio)
_V1_SMALL_ARCHES = {
    "b0_small": (0.35, 0.35, 0.05, 0.05, 0.1),
    "b1_small": (0.5, 0.6, 0.1, 0.1, 0.15),
    "b2_small": (0.6, 0.65, 0.15, 0.15, 0.2),
}


def efficientnet_kan(arch: str = "b0", num_classes: int = 1000,
                     stem_stride: int = 2,
                     stochastic_depth_prob: float = 0.2, **kwargs):
    """kan_efficientnet.py:464-559 builder parity."""
    width_mult, depth_mult, dropout = _V1_ARCHES.get(arch, (1.0, 1.0, 0.2))
    settings = efficientnet_conf(width_mult, depth_mult)
    last_channel = (_make_divisible(1280 * width_mult, 8)
                    if width_mult > 1.0 else 1280)
    kwargs.setdefault("width_scale", width_mult)
    return _build(settings, arch, "EfficientNet", num_classes, last_channel,
                  stem_stride, dropout, stochastic_depth_prob, kwargs)


def efficientnet_kan_small(arch: str = "b0_small", num_classes: int = 10,
                           stem_stride: int = 1, last_channel_mult: int = 4,
                           **kwargs):
    """kan_efficientnet.py:561-657 builder parity."""
    width_mult, depth_mult, dropout, sd_prob, se_ratio = _V1_SMALL_ARCHES.get(
        arch, (0.5, 0.6, 0.1, 0.1, 0.15))
    settings = efficientnet_small_conf(width_mult, depth_mult, se_ratio)
    last_channel = _make_divisible(
        settings[-1].out_channels * last_channel_mult, 8)
    kwargs.setdefault("width_scale", width_mult)
    return _build(settings, f"{arch}_w{width_mult}_d{depth_mult}_cifar",
                  "EfficientNetSmall", num_classes, last_channel,
                  stem_stride, dropout, sd_prob, kwargs)
