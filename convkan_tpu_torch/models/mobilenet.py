"""The port's copy of ``_make_divisible`` of ``convkan_tpu/models/mobilenet.py``
(the KAN-MobileNetV1 model itself is not ported yet)."""

from __future__ import annotations

from typing import Optional


def _make_divisible(v: float, divisor: int,
                    min_value: Optional[int] = None) -> int:
    """The torchvision recipe (models/kan_mobilenet.py:13-19): v rounded to
    a multiple of ``divisor``, at least ``min_value``, never below 90% of
    v."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
