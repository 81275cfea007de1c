"""Base activations of the slice, port of ``convkan_tpu/utils/activations.py``
(``silu``, ``gelu``, ``resolve_activation``).

GELU is the exact erf form (torch's ``nn.GELU`` default, which the JAX
package pins with ``approximate=False``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.nn.functional as F


def gelu(x):
    return F.gelu(x, approximate="none")


def silu(x):
    return F.silu(x)


# the reference CLI names (train.py:32-42) of the activations ported so far
ACTIVATIONS: dict[str, Callable] = {"gelu": gelu, "silu": silu}


def resolve_activation(act) -> Optional[Callable]:
    """Accept a callable, a registry name, or None."""
    if act is None or callable(act):
        return act
    if act not in ACTIVATIONS:
        raise NotImplementedError(f"activation {act!r} is not ported yet")
    return ACTIVATIONS[act]
