"""KAN-MobileNetV2, port of ``convkan_tpu/models/mobilenetv2.py``
(kan_mobilenetv2.py:11-495 of the reference), channel-last.

Inverted residuals: the 1x1 expansion (a KAN conv, where t != 1), the
3x3 depthwise conv (a grouped standard Conv -> Norm -> ReLU6 block, or
with ``replace_depthwise`` a grouped KAN conv), the 1x1 projection (a KAN
conv; on the ``conv_type="conv"`` path a block without activation, the
linear bottleneck), and the residual where the stride is 1 and the widths
agree; arches ``default`` (``V2_DEFAULT``, a stride-2 stem), ``small``
(the same table, stride 1) and ``kan_small`` (``V2_KAN_SMALL``, stride
1); the last 1x1 conv to 1280 x max(1, width_mult), the pooled features'
dropout, then a Linear or a ``kan_classifier`` MLP (``"KAN"``).

Every KAN conv takes ``base_activation`` (SiLU by default) and the
model's ``norm_layer`` (``kan_norm_layer`` is dead in the reference: every
call overrides the norm).  On the ``conv_type="conv"`` path the blocks use
ReLU6, and their conv has a bias whenever the norm is missing or not
affine (the reference's ConvNormActivation quirk,
``std_bias_when_not_affine``).  Submodules are flat, named as flax's
scopes: ``KanConvND_i`` and ``StdConvBlock_i`` in order of construction,
``Linear_0`` or ``KanMLP_0``.
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
from .mobilenet import _make_divisible

# t, c, n, s (kan_mobilenetv2.py:204-213)
V2_DEFAULT = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
              [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1]]
# :223-231
V2_KAN_SMALL = [[1, 16, 1, 1], [6, 24, 1, 2], [6, 32, 1, 2], [6, 48, 1, 2],
                [6, 64, 1, 1], [6, 96, 1, 2], [6, 160, 1, 1]]


class MobileNetV2KAN(_Scoped):
    """Channel-last KAN-MobileNetV2.  Weights are drawn on the CPU from
    ``generator`` and moved to ``device`` (None: the GPU, raising without
    one)."""

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 round_nearest: int = 8, dropout: float = 0.2,
                 input_channels: int = 3, arch: str = "default",
                 conv_type: str = "kanconv", kan_conv: Optional[str] = "KAN",
                 kan_classifier: Optional[str] = "KAN",
                 classifier_type: str = "Linear", groups: int = 1,
                 degree: int = 3, spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = "silu",
                 grid_range: Tuple[float, float] = (-1, 1),
                 l1_decay: float = 0.0, affine: bool = True,
                 norm_layer: Any = BatchNorm, kan_norm_layer: Any = BatchNorm,
                 replace_depthwise: bool = False, conv_dropout: float = 0.0,
                 classifier_overrides: Optional[Mapping[str, Any]] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if arch not in ("default", "small", "kan_small"):
            raise ValueError(f"Unknown MobileNetV2 arch: {arch!r} "
                             "(default | small | kan_small)")
        self.arch, self.width_mult = arch, width_mult
        self.input_channels = input_channels
        self.conv_type, self.kan_conv = conv_type, kan_conv
        self.classifier_type, self.kan_classifier = (classifier_type,
                                                     kan_classifier)
        self.replace_depthwise = replace_depthwise
        make = {"generator": generator, "device": device}
        if conv_type == "kanconv":
            conv = make_conv_factory(
                kan_conv or "KAN", spline_order=spline_order,
                grid_size=grid_size, base_activation=base_activation,
                grid_range=grid_range, dropout=conv_dropout,
                l1_decay=l1_decay, degree=degree, norm_layer=norm_layer,
                kan_norm_layer=norm_layer, affine=affine, **make)
        else:
            conv = make_std_conv_factory(norm_layer, affine, "relu6",
                                         std_bias_when_not_affine=True,
                                         **make)
        norm = resolve_norm(norm_layer)
        setting = V2_KAN_SMALL if arch == "kan_small" else V2_DEFAULT
        c_in = _make_divisible(32 * width_mult, round_nearest)
        self.last_channel = _make_divisible(1280 * max(1.0, width_mult),
                                            round_nearest)
        self._stem = self._scoped(conv(input_channels, c_in, kernel_size=3,
                                       stride=2 if arch == "default" else 1))
        # per block: (use_res, names of its convs)
        self._blocks = []
        for t, c, n, s in setting:
            c_out = _make_divisible(c * width_mult, round_nearest)
            for i in range(n):
                stride = s if i == 0 else 1
                hidden = int(round(c_in * t))
                names = []
                if t != 1:
                    names.append(self._scoped(conv(c_in, hidden,
                                                   kernel_size=1, stride=1)))
                names.append(self._scoped(
                    conv(hidden, hidden, kernel_size=3, stride=stride,
                         groups=hidden) if replace_depthwise else
                    StdConvBlock(hidden, hidden, 3, stride=stride, padding=1,
                                 groups=hidden, base_activation="relu6",
                                 norm_layer=norm,
                                 norm_kwargs={"affine": affine}, **make)))
                names.append(self._scoped(conv(hidden, c_out, kernel_size=1,
                                               stride=1, activation=None)))
                self._blocks.append((stride == 1 and c_in == c_out, names))
                c_in = c_out
        self._last = self._scoped(conv(c_in, self.last_channel,
                                       kernel_size=1))
        ov = resolve_classifier_overrides(
            classifier_overrides or {}, dropout=dropout,
            spline_order=spline_order, grid_size=grid_size,
            base_activation=None, grid_range=grid_range, l1_decay=l1_decay,
            degree=degree)
        self.head_dropout = ov["dropout"]
        if classifier_type == "KAN":
            self.KanMLP_0 = make_mlp_classifier_factory(
                kan_classifier, first_dropout=False, **ov, **make)(
                [self.last_channel, num_classes])
        else:
            self.Linear_0 = Linear(self.last_channel, num_classes, **make)
        self.to(dtype)

    @property
    def model_name(self) -> str:
        convs = (f"_{(self.kan_conv or 'KAN').upper()}"
                 if self.conv_type == "kanconv" else "_CONV")
        head = self.classifier_type
        if head == "KAN":
            head += f"_{(self.kan_classifier or 'KAN').upper()}"
        rdw = ("_RDW" if self.replace_depthwise and
               self.conv_type == "kanconv" else "")
        return f"MobileNetV2KAN_{head}{convs}{rdw}_{self.arch}"

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x; ``generator`` draws the dropout masks in train
        mode (None: the device's default generator)."""
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"expected {self.input_channels} channels (NHWC),"
                             f" got {tuple(x.shape)}")
        x = getattr(self, self._stem)(x, generator)
        for use_res, names in self._blocks:
            y = x
            for name in names:
                y = getattr(self, name)(y, generator)
            x = x + y if use_res else y
        x = getattr(self, self._last)(x, generator)
        x = adaptive_avg_pool(x, (1, 1)).reshape(x.shape[0], -1)
        if self.training:
            x = head_dropout(x, self.head_dropout, generator)
        if self.classifier_type == "KAN":
            return self.KanMLP_0(x, generator)
        return self.Linear_0(x)


def mobilenet_v2_kan(num_classes: int = 1000, **kwargs) -> MobileNetV2KAN:
    """Builder with the reference's flag vocabulary: the ``classifier_*``
    keys (but ``classifier_type``) become ``classifier_overrides``,
    ``arch`` None is "default", keys the model does not take are
    dropped."""
    overrides = pop_classifier_overrides(kwargs)
    if kwargs.get("arch") is None:
        kwargs["arch"] = "default"
    names = set(signature(MobileNetV2KAN.__init__).parameters)
    return MobileNetV2KAN(num_classes=num_classes,
                          classifier_overrides=overrides,
                          **{k: v for k, v in kwargs.items() if k in names})
