"""Activations, port of ``convkan_tpu/utils/activations.py`` (``silu``,
``gelu``, ``relu``, ``hardswish``, ``hardsigmoid``, ``sigmoid``,
``identity``, ``resolve_activation``).

GELU is the exact erf form (torch's ``nn.GELU`` default, which the JAX
package pins with ``approximate=False``).  Hardswish is x * relu6(x + 3) / 6
and hardsigmoid relu6(x + 3) / 6, as torch's modules and jax.nn compute
them; at the kinks torch's derivatives (0 at x <= -3, 1 at x >= 3 for
hardswish) are those of jax.nn.  ``identity`` is the base path of a KAN
conv built with ``base_activation=None`` (the JAX module's ``lambda x: x``),
registered as "identity" and as the reference CLI's "None".
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def gelu(x):
    return F.gelu(x, approximate="none")


def silu(x):
    return F.silu(x)


def relu(x):
    return F.relu(x)


def hardswish(x):
    return F.hardswish(x)


def hardsigmoid(x):
    # relu6(x + 3) / 6 as jax.nn.hard_sigmoid: the same values as
    # F.hardsigmoid, whose float64 backward multiplies by the float32 1/6
    return F.relu6(x + 3.0) / 6.0


def sigmoid(x):
    return torch.sigmoid(x)


def identity(x):
    return x


# the reference CLI names (train.py:32-42) of the activations ported so far;
# "identity" before "None", so that a lookup by function finds "identity"
ACTIVATIONS: dict[str, Callable] = {"gelu": gelu, "silu": silu, "relu": relu,
                                    "hardswish": hardswish,
                                    "hardsigmoid": hardsigmoid,
                                    "sigmoid": sigmoid, "identity": identity,
                                    "None": identity}


def resolve_activation(act) -> Optional[Callable]:
    """Accept a callable, a registry name, or None."""
    if act is None or callable(act):
        return act
    if act not in ACTIVATIONS:
        raise NotImplementedError(f"activation {act!r} is not ported yet")
    return ACTIVATIONS[act]
