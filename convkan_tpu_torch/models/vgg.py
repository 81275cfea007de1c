"""KAN-VGG, port of ``convkan_tpu/models/vgg.py`` (``VGGKAN``, ``vggkan``,
all five ``cfgs``) with the convs of any ``CONV_KAN_FACTORY`` key (every
KAN family but ReLU-KAN, WavKAN, and the standard ``"conv"`` block) and
every head of the reference's menu (kan_vgg.py:137-174): ``"KAN"`` (a
``MLP_KAN_FACTORY`` MLP feat -> classes), ``"Linear"``, ``"HiddenKAN"``
(KAN feat -> 1024, Linear), ``"VGGKAN"`` (Linear-ReLU twice, KAN 1024 ->
classes), ``"VGG"`` (three Linears) and any other name the identity;
the KAN layers of the family ``kan_classifier`` shaped by the
``classifier_*`` overrides (``make_classifier_factory``).

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
family's site); the heads' dropouts (``classifier_dropout`` if given, else
``dropout_linear``) sit where JAX's do; in eval mode all are the
identity.  ``kan_norm_layer``
(InstanceNorm by default, or a registry name such as train.py's
"BatchNorm2d") is every conv's output norm; a BatchNorm's running
statistics are buffers, named like the JAX ``batch_stats``
(``KanConvND_0.norm.mean``, ``.var``).
"""

from __future__ import annotations

from inspect import signature
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..factory.conv_factory import CONV_KAN_FACTORY
from ..ops.dropout import dropout
from ..ops.layers import Linear
from ..ops.pooling import adaptive_avg_pool, max_pool
from ..utils.activations import relu
from ..utils.norms import InstanceNorm, resolve_norm
from .common import (make_mlp_classifier_factory, pop_classifier_overrides,
                     resolve_classifier_overrides)

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


KAN_HEADS = ("HiddenKAN", "VGGKAN", "KAN")


def make_classifier_factory(classifier_type: str,
                            kan_classifier: Optional[str], spline_order=3,
                            grid_size=5, grid_range=(-1, 1), l1_decay=0.0,
                            degree=3, **overrides):
    """fn(layers_hidden, **kw) building the KAN head's MLP of
    ``kan_classifier`` (None: "KAN"), its layers shaped by the model's
    arguments unless ``classifier_X`` overrides X (base activation "silu"
    unless overridden), no dropout inside (kan_vgg.py:226-260); None for a
    head without KAN layers."""
    if classifier_type not in KAN_HEADS:
        return None
    ov = resolve_classifier_overrides(
        overrides, spline_order=spline_order, grid_size=grid_size,
        base_activation="silu", grid_range=grid_range, l1_decay=l1_decay,
        degree=degree)
    return make_mlp_classifier_factory(kan_classifier or "KAN", dropout=0.0,
                                       first_dropout=False, **ov)


class VGGKAN(nn.Module):
    """Channel-last VGG with KAN convs and any head of the menu.  Weights
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
                 conv_dropout: float = 0.0, degree: int = 3,
                 kan_classifier: Optional[str] = "KAN",
                 classifier_overrides: Optional[Mapping[str, Any]] = None,
                 *, generator: torch.Generator = None, device=None,
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
        self.input_channels = input_channels
        self.num_classes = num_classes
        self.arch = arch
        overrides = dict(classifier_overrides or {})
        p = overrides.get("classifier_dropout")
        self.dropout_linear = dropout_linear if p is None else p
        self.classifier_type = classifier_type
        self.kan_classifier = kan_classifier
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
        make = {"generator": generator, "device": device}
        kan = make_classifier_factory(
            classifier_type, kan_classifier, spline_order=spline_order,
            grid_size=grid_size, grid_range=grid_range, l1_decay=l1_decay,
            degree=degree, **overrides)
        # the head in order (kan_vgg.py:137-174): "drop", "relu", a Linear
        # (in, out) or the KAN MLP ("kan", in, out); any other type: none
        plan = {
            "KAN": ["drop", ("kan", feat, num_classes)],
            "Linear": ["drop", (feat, num_classes)],
            "HiddenKAN": [("kan", feat, 1024), "drop", (1024, num_classes)],
            "VGGKAN": [(feat, 1024), "relu", "drop", (1024, 1024), "relu",
                       "drop", ("kan", 1024, num_classes)],
            "VGG": [(feat, 1024), "relu", "drop", (1024, 1024), "relu",
                    "drop", (1024, num_classes)]}.get(classifier_type, [])
        self._head, n_linear = [], 0
        for step in plan:
            if isinstance(step, str):
                self._head.append(step)
            elif step[0] == "kan":
                self.KanMLP_0 = kan(list(step[1:]), **make)
                self._head.append("KanMLP_0")
            else:
                self._head.append(f"Linear_{n_linear}")
                self.add_module(self._head[-1], Linear(*step, **make))
                n_linear += 1
        self.to(dtype)

    @property
    def model_name(self) -> str:
        head = self.classifier_type
        if head in KAN_HEADS:
            head += f"_{(self.kan_classifier or 'KAN').upper()}"
        return f"VGGKAN_{head}_{self.kan_conv.upper()}_{self.arch}"

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
        for step in self._head:
            if step == "drop":
                if self.training:
                    x = dropout(x, self.dropout_linear, generator)
            elif step == "relu":
                x = relu(x)
            elif step == "KanMLP_0":
                x = self.KanMLP_0(x, generator)
            else:
                x = getattr(self, step)(x)
        return x


def vggkan(input_channels: int, num_classes: int, **kwargs) -> VGGKAN:
    """Builder with the reference's flag vocabulary: the ``classifier_*``
    keys (but ``classifier_type``) become ``classifier_overrides``; like
    the JAX builder it drops keys VGGKAN does not take (among them
    ``affine``: the JAX model's ``_filtered`` rule keeps it from a KAN
    conv's norm, so a BatchNorm there stays affine)."""
    overrides = pop_classifier_overrides(kwargs)
    names = set(signature(VGGKAN.__init__).parameters)
    return VGGKAN(input_channels, num_classes, classifier_overrides=overrides,
                  **{k: v for k, v in kwargs.items() if k in names})
