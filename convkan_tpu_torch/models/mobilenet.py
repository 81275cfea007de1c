"""KAN-MobileNetV1, port of ``convkan_tpu/models/mobilenet.py``
(kan_mobilenet.py:13-410 of the reference), channel-last.

A stride-2 3x3 stem, then 13 depthwise-separable stages (``V1_SETTING``):
the 3x3 depthwise conv is a grouped standard Conv -> Norm -> Act block, or
with ``replace_depthwise`` a grouped KAN conv; the 1x1 pointwise conv is
always the factory's.  Widths follow ``width_mult`` through
``_make_divisible``.  Every KAN conv takes ``base_activation`` (ReLU by
default) and the model's ``norm_layer`` (the reference overrides the norm
at every call, so ``kan_norm_layer`` is dead); with ``conv_type="conv"``
every conv is a standard block with that activation.  Submodules are named
as flax's scopes (``KanConvND_0`` the stem, then per stage
``StdConvBlock_i`` (depthwise) and ``KanConvND_{i+1}``; ``StdConvBlock_i``
throughout for ``conv_type="conv"``; ``Linear_0`` or ``KanMLP_0``).

Heads: ``"Linear"`` (dropout, Linear), ``"KAN"`` (dropout, then a
``kan_classifier`` MLP built with ``first_dropout``: a second dropout of
the same rate inside it, as in the JAX model), any other name the
identity.  In train mode the masks come from the forward's generator in
module order.
"""

from __future__ import annotations

from inspect import signature
from typing import Any, Mapping, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.dropout import dropout as head_dropout
from ..ops.layers import Linear
from ..ops.pooling import adaptive_avg_pool
from ..ops.std_conv import StdConvBlock
from ..utils.norms import BatchNorm, resolve_norm
from .common import (_Scoped, make_conv_factory,
                     make_mlp_classifier_factory, make_std_conv_factory,
                     pop_classifier_overrides, resolve_classifier_overrides)


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


# (channels, stride) per stage (kan_mobilenet.py:235-245)
V1_SETTING = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
              (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
              (1024, 1)]


class MobileNetV1KAN(_Scoped):
    """Channel-last KAN-MobileNetV1.  Weights are drawn on the CPU from
    ``generator`` and moved to ``device`` (None: the GPU, raising without
    one)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dropout: float = 0.2, input_channels: int = 3,
                 conv_type: str = "kanconv", kan_conv: Optional[str] = "KAN",
                 kan_classifier: Optional[str] = "KAN",
                 classifier_type: str = "Linear", groups: int = 1,
                 spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = "relu",
                 grid_range: Tuple[float, float] = (-1, 1),
                 l1_decay: float = 0.0, degree: int = 3, affine: bool = True,
                 norm_layer: Any = BatchNorm, kan_norm_layer: Any = BatchNorm,
                 replace_depthwise: bool = False, conv_dropout: float = 0.0,
                 classifier_overrides: Optional[Mapping[str, Any]] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.width_mult, self.input_channels = width_mult, input_channels
        self.conv_type, self.kan_conv = conv_type, kan_conv
        self.classifier_type, self.kan_classifier = (classifier_type,
                                                     kan_classifier)
        self.replace_depthwise = replace_depthwise
        make = {"generator": generator, "device": device}
        act = base_activation or "relu"
        if conv_type == "kanconv":
            conv = make_conv_factory(
                kan_conv or "KAN", spline_order=spline_order,
                grid_size=grid_size, base_activation=act,
                grid_range=grid_range, dropout=conv_dropout,
                l1_decay=l1_decay, degree=degree, norm_layer=norm_layer,
                kan_norm_layer=norm_layer, affine=affine, **make)
        else:
            conv = make_std_conv_factory(norm_layer, affine, act, **make)
        norm = resolve_norm(norm_layer)
        c_in = _make_divisible(32 * width_mult, 8)
        self._plan = [self._scoped(conv(input_channels, c_in, kernel_size=3,
                                        stride=2))]
        for c, s in V1_SETTING:
            c_out = _make_divisible(c * width_mult, 8)
            self._plan.append(self._scoped(
                conv(c_in, c_in, kernel_size=3, stride=s, groups=c_in)
                if replace_depthwise else StdConvBlock(
                    c_in, c_in, 3, stride=s, padding=1, groups=c_in,
                    base_activation=act, norm_layer=norm,
                    norm_kwargs={"affine": affine}, **make)))
            self._plan.append(self._scoped(conv(c_in, c_out, kernel_size=1,
                                                stride=1)))
            c_in = c_out
        ov = resolve_classifier_overrides(
            classifier_overrides or {}, dropout=dropout,
            spline_order=spline_order, grid_size=grid_size,
            base_activation=None, grid_range=grid_range, l1_decay=l1_decay,
            degree=degree)
        self.head_dropout = ov["dropout"]
        if classifier_type == "KAN":
            self.KanMLP_0 = make_mlp_classifier_factory(
                kan_classifier, first_dropout=True, **ov, **make)(
                [c_in, num_classes])
        elif classifier_type == "Linear":
            self.Linear_0 = Linear(c_in, num_classes, **make)
        self.to(dtype)

    @property
    def model_name(self) -> str:
        head = (f"_{(self.kan_classifier or 'KAN').upper()}"
                if self.classifier_type == "KAN"
                else f"_{self.classifier_type}")
        convs = (f"_{(self.kan_conv or 'KAN').upper()}"
                 if self.conv_type == "kanconv" else "_CONV")
        rdw = ("_RDW" if self.replace_depthwise and
               self.conv_type == "kanconv" else "")
        return f"MobileNetV1KAN{head}{convs}{rdw}_w{self.width_mult}"

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x; ``generator`` draws the dropout masks in train
        mode (None: the device's default generator)."""
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"expected {self.input_channels} channels (NHWC),"
                             f" got {tuple(x.shape)}")
        for name in self._plan:
            x = getattr(self, name)(x, generator)
        x = adaptive_avg_pool(x, (1, 1)).reshape(x.shape[0], -1)
        if self.classifier_type not in ("KAN", "Linear"):
            return x
        if self.training:
            x = head_dropout(x, self.head_dropout, generator)
        if self.classifier_type == "KAN":
            return self.KanMLP_0(x, generator)
        return self.Linear_0(x)


def mobilenet_v1_kan(num_classes: int = 1000, **kwargs) -> MobileNetV1KAN:
    """Builder with the reference's flag vocabulary: the ``classifier_*``
    keys (but ``classifier_type``) become ``classifier_overrides``, keys
    the model does not take are dropped."""
    overrides = pop_classifier_overrides(kwargs)
    names = set(signature(MobileNetV1KAN.__init__).parameters)
    return MobileNetV1KAN(num_classes=num_classes,
                          classifier_overrides=overrides,
                          **{k: v for k, v in kwargs.items() if k in names})
