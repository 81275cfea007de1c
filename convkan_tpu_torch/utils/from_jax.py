"""Carry JAX-package weights into the port.

The port keeps the JAX parameter names, shapes and layouts, so a flax
``params`` tree of numpy arrays maps onto a ``state_dict`` by joining the
path with dots: ``{"KanConvND_0": {"poly_w": a}}`` -> ``"KanConvND_0.poly_w"``.
One name differs: a conv's output norm, which flax names after its class
(``BatchNorm_0``, ``LayerNorm_0``, ``GroupNorm_0``, ``RMSNorm_0``; also a
``StdConvBlock``'s), is the port's ``norm``; FastKAN's named input norms
(``input_norm_{g}``) keep their names.  A block that flax rematerializes
(``nn.remat``) carries ``Checkpoint`` before its class's name
(``Checkpoint_EffBlock_3``, ``Checkpoint_MNV3Block_0``): the port names
it as without remat (``_EffBlock_3``), whatever its own ``remat``.  The
``batch_stats`` collection (a BatchNorm's running ``mean`` and ``var``)
maps onto the norm's buffers of the same names.  A JAX ``TrainState``
(anything with a ``params`` attribute, and ``batch_stats`` where it has
them) is read through those, so a JAX training run's weights continue in
the port's trainer.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

# flax's names of a conv's output norm -> the port's attribute
_NORM_SCOPES = {f"{cls}_0": "norm" for cls in ("BatchNorm", "LayerNorm",
                                               "GroupNorm", "RMSNorm")}


def _scope(key: str) -> str:
    """The port's name of the flax scope ``key``."""
    if key.startswith("Checkpoint_"):
        return key[len("Checkpoint"):]
    return _NORM_SCOPES.get(key, key)


def _flatten(tree: Mapping, prefix: str, out: dict):
    for key, val in tree.items():
        name = f"{prefix}{_scope(key)}"
        if isinstance(val, Mapping):
            _flatten(val, name + ".", out)
        else:
            out[name] = torch.from_numpy(np.array(val, copy=True))


def state_dict_from_jax(variables) -> "OrderedDict[str, torch.Tensor]":
    """JAX variables of a model or a single conv -> a state_dict that the
    port's module accepts with ``load_state_dict(strict=True)``.  Takes the
    ``params`` tree itself, ``{"params": tree}``, ``{"params": tree,
    "batch_stats": stats}`` or a ``TrainState``, with numpy-convertible
    leaves.  Dtypes are kept."""
    if not isinstance(variables, Mapping) and hasattr(variables, "params"):
        variables = {"params": variables.params,
                     "batch_stats": getattr(variables, "batch_stats", None)}
    if "params" not in variables:
        variables = {"params": variables}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection in ("params", "batch_stats"):
        _flatten(variables.get(collection) or {}, "", out)
    return out


# the name the VGG tests and tools have used since the first slice
vggkan_state_dict_from_jax = state_dict_from_jax
