"""Carry JAX-package weights into the port.

The port keeps the JAX parameter names, shapes and layouts, so a flax
``params`` tree of numpy arrays maps onto a ``state_dict`` by joining the
path with dots: ``{"KanConvND_0": {"poly_w": a}}`` -> ``"KanConvND_0.poly_w"``.
A JAX ``TrainState`` (anything with a ``params`` attribute) is read through
its ``params``, so a JAX training run's weights continue in the port's
trainer.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, out: dict):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            _flatten(val, name + ".", out)
        else:
            out[name] = torch.from_numpy(np.array(val, copy=True))


def vggkan_state_dict_from_jax(params) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``VGGKAN`` params (the tree itself, ``{"params": tree}`` or a
    ``TrainState``, with numpy-convertible leaves) -> a state_dict that
    ``VGGKAN.load_state_dict`` accepts with ``strict=True``.  Dtypes are
    kept."""
    if not isinstance(params, Mapping) and hasattr(params, "params"):
        params = params.params
    if set(params) == {"params"}:
        params = params["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _flatten(params, "", out)
    return out

