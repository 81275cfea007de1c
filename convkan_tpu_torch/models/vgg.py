"""KAN-VGG, port of ``convkan_tpu/models/vgg.py`` (``VGGKAN``, ``vggkan``,
all five ``cfgs``) with the convs of any ``CONV_KAN_FACTORY`` key (every
KAN family but ReLU-KAN, WavKAN, and the standard ``"conv"`` block) and
the ``"Linear"`` head.

Channel-last: NHWC images in, logits out.  Submodules are named like the
JAX parameter tree (``KanConvND_0`` .. ``KanConvND_{n-1}``, or
``WavKANConvND_0`` .. for ``kan_conv="WavKAN"`` and ``StdConvBlock_0`` ..
for ``"conv"``, and ``Linear_0``), so a JAX ``params`` tree maps onto
``state_dict`` keys by flattening (utils/from_jax.py); a conv has the
parameters of its family (no ``base_w`` and no ``prelu`` for ChebyKAN,
``beta_weights`` for GRAMKAN, ``prelu`` only where PReLU follows the
norm), as in JAX.  The factory's keyword arguments are filtered as JAX's
``_filtered`` filters them: only those the builder names (so Fourier takes
``grid_size``, the polynomial families ``degree``, every family
``base_activation``, default "silu").  In train mode the head applies
dropout (``dropout_linear``, default 0.5) before ``Linear_0`` and every
conv but the first applies channel dropout (``conv_dropout``, at the
family's site); in eval mode both are the identity.  ``kan_norm_layer``
(InstanceNorm by default, or a registry name such as train.py's
"BatchNorm2d") is every conv's output norm; a BatchNorm's running
statistics are buffers, named like the JAX ``batch_stats``
(``KanConvND_0.norm.mean``, ``.var``).
"""

from __future__ import annotations

from inspect import signature
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..factory.conv_factory import CONV_KAN_FACTORY
from ..ops.dropout import dropout
from ..ops.layers import Linear
from ..ops.pooling import adaptive_avg_pool, max_pool
from ..utils.norms import InstanceNorm, resolve_norm

cfgs: dict[str, list] = {
    "VGG16_small": [16, 16, "M", 32, 32, "M", 64, 64, 64, "M", 128, 128, 128,
                    "M", 128, 128, 128],
    "VGG16_kansmall": [8, 8, "M", 16, 16, "M", 32, 32, 32, "M", 64, 64, 64,
                       "M", 64, 64, 64],
    "VGG19_small": [16, 16, "M", 32, 32, "M", 64, 64, 64, 64, "M", 128, 128,
                    128, 128, "M", 128, 128, 128, 128],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512],
}


class VGGKAN(nn.Module):
    """Channel-last VGG with KAN convs and a Linear classifier.  Weights
    are drawn on the CPU from ``generator`` and moved to ``device`` (None:
    the GPU, raising without one)."""

    def __init__(self, input_channels: int, num_classes: int,
                 conv_type: str = "kanconv", kan_conv: Optional[str] = "KAN",
                 groups: int = 1, spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = "silu",
                 grid_range: Tuple[float, float] = (-1, 1),
                 l1_decay: float = 0.0, dropout_linear: float = 0.5,
                 arch: str = "VGG16",
                 classifier_type: str = "Linear",
                 expected_feature_shape: Tuple[int, int] = (1, 1),
                 width_scale: int = 1, kan_norm_layer: Any = InstanceNorm,
                 std_conv_kernel_size: int = 3, std_conv_padding: int = 1,
                 conv_dropout: float = 0.0, degree: int = 3, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if arch not in cfgs:
            raise ValueError(f"Unknown arch: {arch}")
        if conv_type != "kanconv" or (kan_conv or "KAN") not in \
                CONV_KAN_FACTORY:
            raise NotImplementedError(
                f"conv_type={conv_type!r} kan_conv={kan_conv!r} is not ported;"
                f" only {sorted(CONV_KAN_FACTORY)} convs are")
        if classifier_type != "Linear":
            raise NotImplementedError(
                f"classifier_type={classifier_type!r} is not ported; only "
                "'Linear' is")
        self.input_channels = input_channels
        self.num_classes = num_classes
        self.arch = arch
        self.dropout_linear = dropout_linear
        self.classifier_type = classifier_type
        self.expected_feature_shape = tuple(expected_feature_shape)
        self.kan_conv = kan_conv or "KAN"
        conv = CONV_KAN_FACTORY[self.kan_conv]
        # the JAX _filtered rule: only keys the builder names
        accepted = set(signature(conv).parameters)
        prefix = {"WavKAN": "WavKANConvND", "conv": "StdConvBlock"}.get(
            self.kan_conv, "KanConvND")
        in_c, first, n = input_channels, True, 0
        self._plan = []
        for v in cfgs[arch]:
            if v == "M":
                self._plan.append("M")
                continue
            out_c = int(v * width_scale)
            name = f"{prefix}_{n}"
            kwargs = {
                "spline_order": spline_order, "grid_size": grid_size,
                "base_activation": base_activation, "grid_range": grid_range,
                "l1_decay": l1_decay, "dropout": 0.0 if first else conv_dropout,
                "degree": degree,
                "norm_layer": resolve_norm(kan_norm_layer),
                "padding": std_conv_padding, "groups": groups}
            self.add_module(name, conv(
                in_c, out_c, kernel_size=std_conv_kernel_size,
                generator=generator, device=device,
                **{k: v for k, v in kwargs.items() if k in accepted}))
            self._plan.append(name)
            in_c, first, n = out_c, False, n + 1
        feat = in_c * self.expected_feature_shape[0] * \
            self.expected_feature_shape[1]
        self.Linear_0 = Linear(feat, num_classes, generator=generator,
                               device=device)
        self.to(dtype)

    @property
    def model_name(self) -> str:
        return (f"VGGKAN_{self.classifier_type}_{self.kan_conv.upper()}_"
                f"{self.arch}")

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x.  ``generator`` draws the dropout masks in
        train mode, convs first, then the head (None: the device's default
        generator)."""
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"expected {self.input_channels} channels (NHWC),"
                             f" got {tuple(x.shape)}")
        for step in self._plan:
            x = max_pool(x, 2, 2) if step == "M" else \
                getattr(self, step)(x, generator)
        x = adaptive_avg_pool(x, self.expected_feature_shape)
        x = x.reshape(x.shape[0], -1)
        if self.training:
            x = dropout(x, self.dropout_linear, generator)
        return self.Linear_0(x)


def vggkan(input_channels: int, num_classes: int, **kwargs) -> VGGKAN:
    """Builder with the reference's flag vocabulary.  Like the JAX builder
    it drops keys VGGKAN does not take (the KAN-head ``classifier_*``
    overrides, and ``affine``: the JAX model's ``_filtered`` rule keeps it
    from a KAN conv's norm, so a BatchNorm there stays affine), except
    ``classifier_dropout``: when not None it replaces ``dropout_linear``."""
    if kwargs.get("classifier_dropout") is not None:
        kwargs["dropout_linear"] = kwargs["classifier_dropout"]
    names = set(signature(VGGKAN.__init__).parameters)
    return VGGKAN(input_channels, num_classes,
                  **{k: v for k, v in kwargs.items() if k in names})
