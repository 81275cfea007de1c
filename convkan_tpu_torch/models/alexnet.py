"""KAN-AlexNet, port of ``convkan_tpu/models/alexnet.py``
(kan_alexnet.py:11-313 of the reference), channel-last.

Two arches: ``default`` (an 11x11 stride-4 stem, a 4096-wide head, for
224 x 224 inputs) and ``small`` (a 5x5 stride-1 stem, a 1024-wide head,
for 32 x 32); five convs with 3x3 stride-2 max pools after the first,
the second and the fifth, AdaptiveAvgPool2d(6, 6) to 256 x 36 features,
then dropout, Linear, ReLU, dropout, Linear, ReLU and the last layer: a
``kan_classifier`` MLP for ``classifier_type="KAN"``, else a Linear (the
reference's quirk: ``"AlexNetKAN"`` names a KAN head in ``model_name`` but
builds the Linear one, kan_alexnet.py:151,195-199).

The convs are the ``kan_conv`` family of ``CONV_KAN_FACTORY`` with
``kan_norm_layer`` (or ``norm_layer``) as their norm (``KanConvND_0`` ..
``_4``), or Conv -> ``norm_layer`` -> ReLU blocks for ``conv_type="conv"``
(``StdConvBlock_0`` .. ``_4``); the head's layers are ``Linear_0``,
``Linear_1`` and ``KanMLP_0`` or ``Linear_2``, as flax names them.  In
train mode the convs' channel dropout and the head's dropouts draw their
masks from the forward's generator, in that order.

An input whose maps some max pool cannot cover (the ``default`` arch
below 63 x 63: train.py's default argv, MNIST at 28 x 28, is one) is
refused before the first conv runs (``feature_sizes``); in the JAX
package the same model fails inside ``reduce_window``.
"""

from __future__ import annotations

from inspect import signature
from typing import Any, Mapping, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.dropout import dropout as head_dropout
from ..ops.layers import Linear
from ..ops.pooling import adaptive_avg_pool, max_pool
from ..ops.std_conv import StdConvBlock
from ..utils.activations import relu
from ..utils.norms import BatchNorm, InstanceNorm, resolve_norm
from .common import (_Scoped, make_conv_factory,
                     make_mlp_classifier_factory, pop_classifier_overrides,
                     resolve_classifier_overrides)

# (in, out, kernel, stride, padding) per conv; "M" a 3x3 stride-2 max pool
# (kan_alexnet.py:119-137)
ARCHES = {
    "default": ([(None, 64, 11, 4, 2), "M", (64, 192, 5, 1, 2), "M",
                 (192, 384, 3, 1, 1), (384, 256, 3, 1, 1),
                 (256, 256, 3, 1, 1), "M"], 4096),
    "small": ([(None, 64, 5, 1, 2), "M", (64, 192, 5, 1, 2), "M",
               (192, 384, 3, 1, 1), (384, 256, 3, 1, 1),
               (256, 256, 3, 1, 1), "M"], 1024),
}


def _walk(arch: str, H: int, W: int):
    """(sizes, fault): the (H, W) of every conv's input and of the map the
    head pools, or where the walk stops: a conv's empty output or a 3x3
    max pool over a map smaller than its window."""
    sizes, pools = [], 0
    for step in ARCHES[arch][0]:
        if step == "M":
            pools += 1
            if min(H, W) < 3:
                return sizes, (f"its max pool {pools} (3x3, stride 2) "
                               f"gets a {H}x{W} map")
            H, W = (H - 3) // 2 + 1, (W - 3) // 2 + 1
            continue
        sizes.append((H, W))
        _, _, k, s, p = step
        H, W = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        if min(H, W) < 1:
            return sizes, f"its conv {len(sizes)} gives an empty map"
    return sizes + [(H, W)], None


def feature_sizes(arch: str, H: int, W: int) -> list:
    """The (H, W) of every conv's input and of the map the head pools, for
    an H x W input; ValueError, saying why and what the arch needs, where
    the maps do not reach the head."""
    if arch not in ARCHES:
        raise ValueError(f"Unknown arch: {arch}")
    sizes, fault = _walk(arch, H, W)
    if fault:
        need = next(n for n in range(1, 4096) if not _walk(arch, n, n)[1])
        raise ValueError(
            f"AlexNetKAN arch {arch!r} cannot take a {H}x{W} input: {fault} "
            f"(it needs at least {need}x{need}; the JAX model fails there "
            "too)")
    return sizes


class AlexNetKAN(_Scoped):
    """Channel-last KAN-AlexNet.  Weights are drawn on the CPU from
    ``generator`` and moved to ``device`` (None: the GPU, raising without
    one)."""

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5,
                 input_channels: int = 3, arch: str = "default",
                 conv_type: str = "kanconv", kan_conv: Optional[str] = "KAN",
                 kan_classifier: Optional[str] = "KAN",
                 classifier_type: str = "Linear", groups: int = 1,
                 spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = "silu",
                 grid_range: Tuple[float, float] = (-1, 1), degree: int = 3,
                 l1_decay: float = 0.0, affine: bool = True,
                 norm_layer: Any = BatchNorm,
                 kan_norm_layer: Any = InstanceNorm,
                 conv_dropout: float = 0.0,
                 classifier_overrides: Optional[Mapping[str, Any]] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if arch not in ARCHES:
            raise ValueError(f"Unknown arch: {arch}")
        self.arch, self.input_channels = arch, input_channels
        self.conv_type, self.kan_conv = conv_type, kan_conv
        self.classifier_type, self.kan_classifier = (classifier_type,
                                                     kan_classifier)
        make = {"generator": generator, "device": device}
        if conv_type == "kanconv":
            conv = make_conv_factory(
                kan_conv or "KAN", spline_order=spline_order,
                grid_size=grid_size, base_activation=base_activation,
                grid_range=grid_range, dropout=conv_dropout,
                l1_decay=l1_decay, degree=degree, norm_layer=norm_layer,
                kan_norm_layer=kan_norm_layer, affine=affine, **make)
        else:
            def conv(i, o, kernel_size, stride, padding, groups):
                return StdConvBlock(
                    i, o, kernel_size, stride=stride, padding=padding,
                    groups=groups, base_activation="relu",
                    norm_layer=resolve_norm(norm_layer),
                    norm_kwargs={"affine": affine}, **make)
        table, hidden = ARCHES[arch]
        self._plan = []
        for step in table:
            if step == "M":
                self._plan.append("M")
                continue
            i, o, k, s, p = step
            self._plan.append(self._scoped(conv(
                i or input_channels, o, kernel_size=k, stride=s, padding=p,
                groups=groups)))
        ov = resolve_classifier_overrides(
            classifier_overrides or {}, dropout=dropout,
            spline_order=spline_order, grid_size=grid_size,
            base_activation=None, grid_range=grid_range, l1_decay=l1_decay,
            degree=degree)
        self.head_dropout = ov["dropout"]
        self.Linear_0 = Linear(256 * 36, hidden, **make)
        self.Linear_1 = Linear(hidden, hidden, **make)
        if classifier_type == "KAN":
            head = make_mlp_classifier_factory(kan_classifier,
                                               first_dropout=False, **ov,
                                               **make)
            self.KanMLP_0 = head([hidden, num_classes])
        else:
            self.Linear_2 = Linear(hidden, num_classes, **make)
        self.to(dtype)

    @property
    def model_name(self) -> str:
        suffix = (f"_{(self.kan_conv or 'KAN').upper()}"
                  if self.conv_type == "kanconv" else "_CONV")
        head = self.classifier_type
        if head in ("KAN", "AlexNetKAN"):
            head += f"_{(self.kan_classifier or 'KAN').upper()}"
        return f"AlexNet_{head}{suffix}"

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x; ``generator`` draws the dropout masks in
        train mode (None: the device's default generator)."""
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"expected {self.input_channels} channels (NHWC),"
                             f" got {tuple(x.shape)}")
        feature_sizes(self.arch, x.shape[1], x.shape[2])
        for step in self._plan:
            x = max_pool(x, 3, 2) if step == "M" else \
                getattr(self, step)(x, generator)
        x = adaptive_avg_pool(x, (6, 6)).reshape(x.shape[0], -1)
        for lin in (self.Linear_0, self.Linear_1):
            if self.training:
                x = head_dropout(x, self.head_dropout, generator)
            x = relu(lin(x))
        if self.classifier_type == "KAN":
            return self.KanMLP_0(x, generator)
        return self.Linear_2(x)


def alexnet_kan(num_classes: int = 1000, input_channels: int = 3,
                **kwargs) -> AlexNetKAN:
    """Builder with the reference's flag vocabulary (kan_alexnet.py:259-313):
    the ``classifier_*`` keys (but ``classifier_type``) become
    ``classifier_overrides``, ``arch`` None is "default", keys the model
    does not take are dropped."""
    overrides = pop_classifier_overrides(kwargs)
    if kwargs.get("arch") is None:
        kwargs["arch"] = "default"
    names = set(signature(AlexNetKAN.__init__).parameters)
    return AlexNetKAN(num_classes=num_classes, input_channels=input_channels,
                      classifier_overrides=overrides,
                      **{k: v for k, v in kwargs.items() if k in names})
