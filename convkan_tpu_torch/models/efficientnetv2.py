"""KAN-EfficientNetV2, port of ``convkan_tpu/models/efficientnetv2.py``
(channel-last): Fused-MBConv and MBConv stages, squeeze-excitation (SiLU,
sigmoid), per-block stochastic depth scaled by the block's index, the
``s``, ``m``, ``l``, ``tiny`` and ``kan_tiny`` tables, and the heads
after the pooled features' dropout: Linear, KAN (a ``kan_classifier``
MLP pooled -> classes), HiddenKAN (KAN pooled -> ``head_hidden_dim``,
Linear) or, for any other name, none.  The same engine builds EfficientNet V1
(``models/efficientnet.py``).

Every KAN conv takes the model's activation (SiLU) but the projections
(the 1x1 conv after a fused expansion, and an MBConv's last conv), which
pass ``base_activation=None``: their KAN base path is the identity, as in
the JAX package.  On the ``conv_type="conv"`` path every standard block
keeps the model's activation, projections included (the reference's std
wrapper closes over the model activation).  Each conv, KAN convs in the
stem and the head too, takes the model's ``norm_layer`` (BatchNorm by
default, not affine): the reference overrides ``kan_norm_layer`` at every
call site, so that default is dead there.

Submodules are named as flax's scopes (``KanConvND_0`` (stem),
``_EffBlock_0`` .. with ``KanConvND_i``, ``StdConvBlock_0`` (the standard
depthwise conv) and ``SqueezeExcitation_0`` inside, ``KanConvND_1``
(head conv), ``Linear_0`` (``KanMLP_0`` for the KAN heads);
``StdConvBlock_i`` for ``conv_type="conv"``),
so a JAX variables tree maps onto the state_dict by a path join
(``utils/from_jax.py``, which also maps the ``Checkpoint_EffBlock_i`` of a
JAX model built with ``remat``).  With ``remat`` (the default, as in the
JAX model) each block is rematerialized (``ops/remat_policy.py``).  In
train mode the masks are drawn from the forward's generator in module
order: a block's convs' channel dropout, then its DropPath, then the next
block's, and the head's dropout last.
"""

from __future__ import annotations

import dataclasses
import math
from inspect import signature
from typing import Any, List, Mapping, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.conv import same_padding
from ..ops.dropout import dropout as head_dropout
from ..ops.layers import DropPath, Linear, SqueezeExcitation
from ..ops.pooling import adaptive_avg_pool
from ..ops.remat_policy import checkpoint_block, resolve_remat_policy
from ..ops.std_conv import StdConvBlock
from ..utils.activations import silu
from ..utils.norms import BatchNorm, resolve_norm
from .common import (_Scoped, make_conv_factory,
                     make_mlp_classifier_factory, pop_classifier_overrides,
                     resolve_classifier_overrides)
from .mobilenet import _make_divisible


@dataclasses.dataclass(frozen=True)
class MBConfig:
    block_type: str       # 'fused' | 'mbconv'
    expand_ratio: float
    kernel: int
    stride: int
    input_channels: int
    out_channels: int
    num_layers: int
    se_ratio: Optional[float] = None


def _cfg(block_type, t, k, s, ci, co, n, wm, dm, se=None) -> MBConfig:
    return MBConfig(block_type, t, k, s,
                    _make_divisible(ci * wm, 8), _make_divisible(co * wm, 8),
                    int(math.ceil(n * dm)), se)


def efficientnetv2_conf(arch: str, width_mult=1.0, depth_mult=1.0
                        ) -> List[MBConfig]:
    """The stage table of ``arch`` (kan_efficientnetv2.py:508-544, 635-661)."""
    tables = {
        "s": [("fused", 1, 3, 1, 24, 24, 2, None),
              ("fused", 4, 3, 2, 24, 48, 4, None),
              ("fused", 4, 3, 2, 48, 64, 4, None),
              ("mbconv", 4, 3, 2, 64, 128, 6, 0.25),
              ("mbconv", 6, 3, 1, 128, 160, 9, 0.25),
              ("mbconv", 6, 3, 2, 160, 256, 15, 0.25)],
        "m": [("fused", 1, 3, 1, 24, 24, 3, None),
              ("fused", 4, 3, 2, 24, 48, 5, None),
              ("fused", 4, 3, 2, 48, 80, 5, None),
              ("mbconv", 4, 3, 2, 80, 160, 7, 0.25),
              ("mbconv", 6, 3, 1, 160, 176, 14, 0.25),
              ("mbconv", 6, 3, 2, 176, 304, 18, 0.25),
              ("mbconv", 6, 3, 1, 304, 512, 5, 0.25)],
        "l": [("fused", 1, 3, 1, 32, 32, 4, None),
              ("fused", 4, 3, 2, 32, 64, 7, None),
              ("fused", 4, 3, 2, 64, 96, 7, None),
              ("mbconv", 4, 3, 2, 96, 192, 10, 0.25),
              ("mbconv", 6, 3, 1, 192, 224, 19, 0.25),
              ("mbconv", 6, 3, 2, 224, 384, 25, 0.25),
              ("mbconv", 6, 3, 1, 384, 640, 7, 0.25)],
        "tiny": [("fused", 1, 3, 1, 16, 16, 1, None),
                 ("fused", 4, 3, 2, 16, 24, 2, None),
                 ("fused", 4, 3, 2, 24, 40, 2, None),
                 ("mbconv", 4, 3, 2, 40, 80, 2, 0.25),
                 ("mbconv", 6, 3, 1, 80, 112, 2, 0.25)],
        "kan_tiny": [("fused", 1, 3, 1, 16, 16, 1, None),
                     ("fused", 4, 3, 2, 16, 24, 1, None),
                     ("fused", 4, 3, 2, 24, 40, 1, None),
                     ("mbconv", 4, 3, 2, 40, 80, 1, 0.25),
                     ("mbconv", 6, 3, 1, 80, 112, 1, 0.25)],
    }
    return [_cfg(bt, t, k, s, ci, co, n, width_mult, depth_mult, se)
            for bt, t, k, s, ci, co, n, se in tables[arch]]


class _EffBlock(_Scoped):
    """One Fused-MBConv or MBConv block: the expansion (a k x k conv where
    the expanded width differs, then the 1x1 projection; else one k x k
    conv) or the 1x1 expansion, the depthwise conv (standard, or a grouped
    KAN conv with ``replace_depthwise``), squeeze-excitation and the 1x1
    projection; DropPath (probability ``sd``) on the residual where the
    stride is 1 and the widths agree."""

    def __init__(self, mc: Mapping[str, Any], cfg: MBConfig, ci: int,
                 stride: int, sd: float):
        super().__init__()
        conv, conv_na, std_dw = mc["conv"], mc["conv_na"], mc["std_dw"]
        expanded = _make_divisible(ci * cfg.expand_ratio, 8)
        self.use_res = stride == 1 and ci == cfg.out_channels
        self._plan = []
        if cfg.block_type == "fused":
            if expanded != ci:
                self._plan.append(self._scoped(conv(
                    ci, expanded, kernel_size=cfg.kernel, stride=stride)))
                self._plan.append(self._scoped(conv_na(
                    expanded, cfg.out_channels, kernel_size=1, stride=1)))
            else:
                self._plan.append(self._scoped(conv(
                    ci, cfg.out_channels, kernel_size=cfg.kernel,
                    stride=stride)))
        else:
            if expanded != ci:
                self._plan.append(self._scoped(conv(ci, expanded,
                                                    kernel_size=1)))
            if mc["replace_depthwise"] and mc["conv_type"] == "kanconv":
                dw = conv(expanded, expanded, kernel_size=cfg.kernel,
                          stride=stride, groups=expanded)
            else:
                dw = std_dw(expanded, cfg.kernel, stride)
            self._plan.append(self._scoped(dw))
            if cfg.se_ratio is not None and cfg.se_ratio > 0:
                self._plan.append(self._scoped(SqueezeExcitation(
                    expanded, max(1, int(ci * cfg.se_ratio)),
                    activation=silu, generator=mc["generator"],
                    device=mc["device"])))
            self._plan.append(self._scoped(conv_na(
                expanded, cfg.out_channels, kernel_size=1)))
        self.drop_path = DropPath(sd) if self.use_res else None

    def forward(self, x, generator: torch.Generator = None):
        y = x
        for name in self._plan:
            m = getattr(self, name)
            y = m(y) if isinstance(m, SqueezeExcitation) else m(y, generator)
        if self.use_res:
            y = x + self.drop_path(y, generator)
        return y


class EfficientNetV2KAN(_Scoped):
    """The EfficientNet engine (V2, and V1 through all-MBConv tables).
    Weights are drawn on the CPU from ``generator`` and moved to ``device``
    (None: the GPU, raising without one).  The JAX model's fields that
    nothing reads (``groups``, ``kan_norm_layer``) are not taken; the
    builders drop them, as the JAX builders drop unknown keys."""

    def __init__(self, inverted_residual_setting, dropout: float,
                 stochastic_depth_prob: float = 0.2, num_classes: int = 1000,
                 in_channels: int = 3, last_channel: Optional[int] = None,
                 stem_stride: int = 2, conv_type: str = "kanconv",
                 conv_dropout: float = 0.0, kan_conv: Optional[str] = "KAN",
                 classifier_type: str = "Linear", degree: int = 3,
                 spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = "silu",
                 grid_range: Tuple[float, float] = (-1, 1),
                 l1_decay: float = 0.0, width_scale: float = 1.0,
                 affine: bool = False, norm_layer: Any = BatchNorm,
                 replace_depthwise: bool = False,
                 name_prefix: str = "EfficientNetV2", arch_tag: str = "s",
                 remat: bool = True, remat_policy: Any = None,
                 kan_classifier: Optional[str] = "KAN",
                 head_hidden_dim: int = 1024,
                 classifier_overrides: Optional[Mapping[str, Any]] = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if remat:   # the JAX model resolves the policy only under remat
            resolve_remat_policy(remat_policy)
        self.remat = remat
        self.conv_type, self.kan_conv = conv_type, kan_conv or "KAN"
        self.classifier_type = classifier_type
        self.kan_classifier = kan_classifier
        self.name_prefix, self.arch_tag = name_prefix, arch_tag
        ov = resolve_classifier_overrides(
            classifier_overrides or {}, dropout=dropout,
            spline_order=spline_order, grid_size=grid_size,
            base_activation="silu", grid_range=grid_range,
            l1_decay=l1_decay, degree=degree)
        self.head_dropout = ov.pop("dropout")
        act = base_activation or "silu"
        norm = resolve_norm(norm_layer)
        norm_kwargs = {"affine": affine}

        def factory(base_act):
            if conv_type == "kanconv":
                return make_conv_factory(
                    self.kan_conv, spline_order=spline_order,
                    grid_size=grid_size, base_activation=base_act,
                    grid_range=grid_range, dropout=conv_dropout,
                    l1_decay=l1_decay, degree=degree, norm_layer=norm_layer,
                    kan_norm_layer=norm_layer, affine=affine,
                    generator=generator, device=device)

            def std_conv(in_planes, out_planes, kernel_size, stride=1,
                         groups=1):
                return StdConvBlock(
                    in_planes, out_planes, kernel_size, stride=stride,
                    padding=same_padding(kernel_size, 1), groups=groups,
                    base_activation=act, norm_layer=norm,
                    norm_kwargs=norm_kwargs, generator=generator,
                    device=device)

            return std_conv

        def std_dw(c, k, stride):
            return StdConvBlock(c, c, k, stride=stride, padding=(k - 1) // 2,
                                groups=c, base_activation=act,
                                norm_layer=norm, norm_kwargs=norm_kwargs,
                                generator=generator, device=device)

        conv = factory(act)
        settings = list(inverted_residual_setting)
        self._plan = [self._scoped(conv(in_channels,
                                        settings[0].input_channels,
                                        kernel_size=3, stride=stem_stride))]
        # projections: base_activation=None, the identity base path (the
        # std path keeps the model's activation)
        mc = {"conv": conv, "conv_na": factory(None), "std_dw": std_dw,
              "conv_type": conv_type, "replace_depthwise": replace_depthwise,
              "generator": generator, "device": device}
        total_blocks = sum(c.num_layers for c in settings)
        block_id = 0
        for cfg in settings:
            for j in range(cfg.num_layers):
                sd = stochastic_depth_prob * block_id / total_blocks
                self._plan.append(self._scoped(_EffBlock(
                    mc, cfg, cfg.input_channels if j == 0
                    else cfg.out_channels, cfg.stride if j == 0 else 1, sd)))
                block_id += 1
        last_in = settings[-1].out_channels
        last_out = (last_channel if last_channel is not None
                    else _make_divisible(1280 * width_scale, 8))
        self._plan.append(self._scoped(conv(last_in, last_out,
                                            kernel_size=1)))
        make = {"generator": generator, "device": device}
        self._head = []
        if classifier_type in ("KAN", "HiddenKAN"):
            head = make_mlp_classifier_factory(kan_classifier, dropout=0.0,
                                               first_dropout=False, **ov,
                                               **make)
            hidden = num_classes if classifier_type == "KAN" else \
                head_hidden_dim
            self.KanMLP_0 = head([last_out, hidden])
            self._head.append("KanMLP_0")
            if classifier_type == "HiddenKAN":
                self.Linear_0 = Linear(hidden, num_classes, **make)
                self._head.append("Linear_0")
        elif classifier_type == "Linear":
            self.Linear_0 = Linear(last_out, num_classes, **make)
            self._head.append("Linear_0")
        self.to(dtype)

    @property
    def model_name(self) -> str:
        convs = (f"_{self.kan_conv.upper()}" if self.conv_type == "kanconv"
                 else "_CONV")
        head = ""
        if self.classifier_type in ("KAN", "HiddenKAN"):
            head = f"_{(self.kan_classifier or 'KAN').upper()}"
        return (f"{self.name_prefix}{self.arch_tag.upper()}-KAN_"
                f"{self.classifier_type}{head}{convs}")

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x; ``generator`` draws the dropout and DropPath
        masks in train mode (None: the device's default generator)."""
        for name in self._plan:
            m = getattr(self, name)
            x = checkpoint_block(m, x, generator) if \
                self.remat and isinstance(m, _EffBlock) else m(x, generator)
        x = adaptive_avg_pool(x, (1, 1)).reshape(x.shape[0], -1)
        if self.training:
            x = head_dropout(x, self.head_dropout, generator)
        for name in self._head:
            m = getattr(self, name)
            x = m(x) if isinstance(m, Linear) else m(x, generator)
        return x


def _build(settings, arch_tag, name_prefix, num_classes, last_channel,
           stem_stride, dropout, stochastic_depth_prob, kwargs):
    """The model from the reference's flag vocabulary: the ``classifier_*``
    keys become ``classifier_overrides``; keys the model does not take,
    and None values, are dropped; ``generator``, ``device`` and ``dtype``
    pass through."""
    overrides = pop_classifier_overrides(kwargs)
    names = set(signature(EfficientNetV2KAN.__init__).parameters)
    kwargs = {k: v for k, v in kwargs.items()
              if k in names and v is not None}
    for k in ("arch", "inverted_residual_setting", "dropout",
              "stochastic_depth_prob", "num_classes", "last_channel",
              "stem_stride", "arch_tag", "name_prefix",
              "classifier_overrides"):
        kwargs.pop(k, None)
    return EfficientNetV2KAN(
        tuple(settings), dropout=dropout,
        stochastic_depth_prob=stochastic_depth_prob, num_classes=num_classes,
        last_channel=last_channel, stem_stride=stem_stride,
        arch_tag=arch_tag, name_prefix=name_prefix,
        classifier_overrides=overrides, **kwargs)


def efficientnetv2_kan(arch: str = "s", num_classes: int = 1000,
                       dropout: float = 0.2,
                       stochastic_depth_prob: float = 0.2, **kwargs
                       ) -> EfficientNetV2KAN:
    """kan_efficientnetv2.py:547-634: the ``s``, ``m`` or ``l`` table, the
    head conv of 1280, stem stride 2."""
    return _build(efficientnetv2_conf(arch), arch, "EfficientNetV2",
                  num_classes, 1280, 2, dropout, stochastic_depth_prob,
                  kwargs)


def efficientnetv2_kan_small(arch: str = "kan_tiny", num_classes: int = 10,
                             width_mult: float = 1.0, depth_mult: float = 1.0,
                             dropout: float = 0.1,
                             stochastic_depth_prob: float = 0.1, **kwargs
                             ) -> EfficientNetV2KAN:
    """kan_efficientnetv2.py:663-752: the ``tiny`` or ``kan_tiny`` table
    (stem stride 1 for ``kan_tiny``), the head conv of 256 x width."""
    settings = efficientnetv2_conf(arch, width_mult, depth_mult)
    return _build(settings, arch, "EfficientNetV2Small-", num_classes,
                  _make_divisible(256 * width_mult, 8),
                  1 if arch == "kan_tiny" else 2, dropout,
                  stochastic_depth_prob, kwargs)
