"""Dropout with flax ``nn.Dropout`` semantics, port of the dropout the JAX
package applies in ``models/vgg.py`` (head) and ``nn/kan_conv.py``
(``_channel_dropout``, whole channels per sample).

Masks come from an explicit ``torch.Generator``.  The draw happens on the
generator's device and the mask moves to the tensor's: a generator on the
model's device keeps the step free of host syncs, while a CPU generator
gives the same masks to a CPU and a GPU run (at the cost of a copy).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def uniform(shape, device, generator: Optional[torch.Generator] = None):
    """float32 U[0, 1) draws of ``shape`` from ``generator`` (None: the
    default generator of ``device``), returned on ``device``."""
    where = generator.device if generator is not None else device
    return torch.rand(tuple(shape), generator=generator,
                      device=where).to(device)


def apply_mask(x, keep, rate: float):
    """Kept entries scaled by 1/(1 - rate), the rest zero (flax's select)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x, rate: float, generator: Optional[torch.Generator] = None,
            broadcast_dims: Sequence[int] = ()):
    """Train-mode dropout: keep each entry with probability 1 - rate; the
    mask is shared along ``broadcast_dims`` (the spatial axes for channel
    dropout)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]
    keep = uniform(shape, x.device, generator) < 1.0 - rate
    return apply_mask(x, keep, rate)


def channel_dropout(x, rate: float,
                    generator: Optional[torch.Generator] = None):
    """torch DropoutNd: drop whole channels per sample of a channel-last
    tensor (the mask is shared over every spatial axis)."""
    return dropout(x, rate, generator, broadcast_dims=range(1, x.ndim - 1))
