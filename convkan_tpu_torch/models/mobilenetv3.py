"""KAN-MobileNetV3, port of ``convkan_tpu/models/mobilenetv3.py``
(channel-last): the large and small tables, ``reduced_tail``, ``dilated``,
per-block RE/HS activations on the standard depthwise convs, squeeze-
excitation with hardsigmoid, BatchNorm with eps 1e-3 and momentum 0.01
everywhere, and the Linear-hardswish-dropout-Linear head.

Every KAN conv takes the model-level activation (hardswish by default),
as in the JAX package.  Submodules are named like flax's scopes
(``KanConvND_0`` (stem), ``_MNV3Block_0`` .. with ``KanConvND_i``,
``StdConvBlock_i`` and ``SqueezeExcitation_0`` inside, ``KanConvND_1``
(last conv), ``Linear_0``, ``Linear_1``; ``StdConvBlock_i`` in place of the
KAN convs for ``conv_type="conv"``), so a JAX variables tree maps onto the
state_dict by a path join (utils/from_jax.py).  In train mode the convs'
channel dropout (``conv_dropout``) and the head's dropout draw their masks
from the forward's generator, convs first.  With ``remat`` each block is
rematerialized (``ops/remat_policy.py``: the policy "full", the forward's
masks replayed, the running statistics moved once), as by JAX's
``nn.remat(_MNV3Block)``; flax then names the blocks
``Checkpoint_MNV3Block_i``, which ``utils/from_jax.py`` maps onto these
names.  Not ported yet: the KAN classifier head.
"""

from __future__ import annotations

import dataclasses
from inspect import signature
from typing import Any, List, Mapping, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.dropout import dropout as head_dropout
from ..ops.layers import Linear, SqueezeExcitation
from ..ops.pooling import adaptive_avg_pool
from ..ops.remat_policy import checkpoint_block, resolve_remat_policy
from ..ops.std_conv import StdConvBlock
from ..utils.activations import hardsigmoid, hardswish, relu
from ..utils.norms import BatchNorm, resolve_norm
from .common import _Scoped, make_conv_factory
from .mobilenet import _make_divisible


@dataclasses.dataclass(frozen=True)
class IRConfig:
    input_channels: int
    kernel: int
    expanded_channels: int
    out_channels: int
    use_se: bool
    use_hs: bool
    stride: int
    dilation: int


def _adjust(c, wm):
    return _make_divisible(c * wm, 8)


def mobilenet_v3_conf(arch: str, width_mult: float = 1.0,
                      reduced_tail: bool = False, dilated: bool = False
                      ) -> Tuple[List[IRConfig], int]:
    """The block table of ``arch`` ("large" or "small") and the head's
    width (kan_mobilenetv3.py:412-464)."""
    rd = 2 if reduced_tail else 1
    dil = 2 if dilated else 1
    tables = {
        "large": [
            [16, 3, 16, 16, False, "RE", 1, 1],
            [16, 3, 64, 24, False, "RE", 2, 1],
            [24, 3, 72, 24, False, "RE", 1, 1],
            [24, 5, 72, 40, True, "RE", 2, 1],
            [40, 5, 120, 40, True, "RE", 1, 1],
            [40, 5, 120, 40, True, "RE", 1, 1],
            [40, 3, 240, 80, False, "HS", 2, 1],
            [80, 3, 200, 80, False, "HS", 1, 1],
            [80, 3, 184, 80, False, "HS", 1, 1],
            [80, 3, 184, 80, False, "HS", 1, 1],
            [80, 3, 480, 112, True, "HS", 1, 1],
            [112, 3, 672, 112, True, "HS", 1, 1],
            [112, 5, 672, 160 // rd, True, "HS", 2, dil],
            [160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil],
            [160 // rd, 5, 960 // rd, 160 // rd, True, "HS", 1, dil],
        ],
        "small": [
            [16, 3, 16, 16, True, "RE", 2, 1],
            [16, 3, 72, 24, False, "RE", 2, 1],
            [24, 3, 88, 24, False, "RE", 1, 1],
            [24, 5, 96, 40, True, "HS", 2, 1],
            [40, 5, 240, 40, True, "HS", 1, 1],
            [40, 5, 240, 40, True, "HS", 1, 1],
            [40, 5, 120, 48, True, "HS", 1, 1],
            [48, 5, 144, 48, True, "HS", 1, 1],
            [48, 5, 288, 96 // rd, True, "HS", 2, dil],
            [96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, dil],
            [96 // rd, 5, 576 // rd, 96 // rd, True, "HS", 1, dil],
        ],
    }
    cfgs = [IRConfig(_adjust(ic, width_mult), k, _adjust(ec, width_mult),
                     _adjust(oc, width_mult), se, act == "HS", s, d * dil)
            for ic, k, ec, oc, se, act, s, d in tables[arch]]
    base = 960 if arch == "large" else 576
    last_channel = _make_divisible(base // rd * width_mult, 8)
    return cfgs, last_channel


class _MNV3Block(_Scoped):
    """One inverted-residual block: the 1x1 expansion (where the expanded
    width differs), the depthwise conv (standard, or a grouped KAN conv
    with ``replace_depthwise``), squeeze-excitation, the 1x1 projection
    (linear on the standard path), and the residual where the stride is 1
    and the widths agree."""

    def __init__(self, mc: Mapping[str, Any], cnf: IRConfig):
        super().__init__()
        gen, dev = mc["generator"], mc["device"]
        act = "hardswish" if cnf.use_hs else "relu"

        def conv_block(in_c, out_c, k, stride, groups, dilation=1,
                       std_activation="__block__"):
            if mc["conv_type"] == "kanconv":
                return mc["kan_factory"](in_c, out_c, kernel_size=k,
                                         stride=stride, groups=groups,
                                         dilation=dilation)
            return StdConvBlock(
                in_c, out_c, k, stride=stride,
                padding=dilation * (k - 1) // 2, groups=groups,
                dilation=dilation,
                base_activation=(act if std_activation == "__block__"
                                 else std_activation),
                norm_layer=mc["norm_layer"], norm_kwargs=mc["norm_kwargs"],
                generator=gen, device=dev)

        self.use_res = cnf.stride == 1 and \
            cnf.input_channels == cnf.out_channels
        ec = cnf.expanded_channels
        self._plan = []
        if ec != cnf.input_channels:
            self._plan.append(self._scoped(conv_block(
                cnf.input_channels, ec, 1, 1, 1)))
        stride = 1 if cnf.dilation > 1 else cnf.stride
        if mc["replace_depthwise"] and mc["conv_type"] == "kanconv":
            dw = conv_block(ec, ec, cnf.kernel, stride, ec, cnf.dilation)
        else:
            dw = StdConvBlock(
                ec, ec, cnf.kernel, stride=stride,
                padding=cnf.dilation * (cnf.kernel - 1) // 2, groups=ec,
                dilation=cnf.dilation, base_activation=act,
                norm_layer=mc["norm_layer"], norm_kwargs=mc["norm_kwargs"],
                generator=gen, device=dev)
        self._plan.append(self._scoped(dw))
        if cnf.use_se:
            self._plan.append(self._scoped(SqueezeExcitation(
                ec, _make_divisible(ec // 4, 8), activation=relu,
                scale_activation=hardsigmoid, generator=gen, device=dev)))
        self._plan.append(self._scoped(conv_block(
            ec, cnf.out_channels, 1, 1, 1, std_activation=None)))

    def forward(self, x, generator: torch.Generator = None):
        y = x
        for name in self._plan:
            m = getattr(self, name)
            y = m(y) if isinstance(m, SqueezeExcitation) else m(y, generator)
        return x + y if self.use_res else y


class MobileNetV3KAN(_Scoped):
    """Channel-last KAN-MobileNetV3 with the Linear head.  Weights are
    drawn on the CPU from ``generator`` and moved to ``device`` (None: the
    GPU, raising without one)."""

    def __init__(self, arch: str, num_classes: int = 1000,
                 dropout: float = 0.2, input_channels: int = 3,
                 reduced_tail: bool = False, dilated: bool = False,
                 width_mult: float = 1.0, conv_type: str = "kanconv",
                 kan_conv: Optional[str] = "KAN",
                 kan_classifier: Optional[str] = "KAN",
                 classifier_type: str = "Linear", groups: int = 1,
                 spline_order: int = 3, grid_size: int = 5,
                 base_activation: Any = None,
                 grid_range: Tuple[float, float] = (-1, 1),
                 l1_decay: float = 0.0, degree: int = 3, affine: bool = True,
                 norm_layer: Any = BatchNorm, kan_norm_layer: Any = BatchNorm,
                 replace_depthwise: bool = False, conv_dropout: float = 0.0,
                 remat: bool = False, remat_policy: Any = None, *,
                 generator: torch.Generator = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if remat:   # the JAX model resolves the policy only under remat
            resolve_remat_policy(remat_policy)
        self.remat = remat
        if classifier_type != "Linear":
            raise NotImplementedError(f"classifier_type={classifier_type!r} "
                                      "is not ported (the KAN head needs "
                                      "nn/kan_linear.py); only 'Linear' is")
        self.arch, self.num_classes = arch, num_classes
        self.dropout, self.input_channels = dropout, input_channels
        self.width_mult, self.conv_type = width_mult, conv_type
        self.kan_conv, self.kan_classifier = kan_conv, kan_classifier
        self.classifier_type = classifier_type
        self.replace_depthwise = replace_depthwise
        cfgs, last_channel = mobilenet_v3_conf(arch, width_mult, reduced_tail,
                                               dilated)
        act_name = base_activation or "hardswish"
        # BatchNorm's eps/momentum of the reference (kan_mobilenetv3.py:246)
        norm_kwargs = {"affine": affine}
        extra = {}
        if norm_layer is BatchNorm or norm_layer == "BatchNorm2d":
            extra = {"eps": 0.001, "momentum": 0.01}
            norm_kwargs.update(extra)
        std_norm = resolve_norm(norm_layer)

        # kan_norm_layer is dead in the reference: every conv gets the
        # model's norm_layer (kan_mobilenetv3.py:116,137,155,302,320)
        kan_factory = make_conv_factory(
            kan_conv, spline_order=spline_order,
            grid_size=grid_size, base_activation=act_name,
            grid_range=grid_range, dropout=conv_dropout, l1_decay=l1_decay,
            degree=degree, norm_layer=norm_layer, kan_norm_layer=norm_layer,
            affine=affine, generator=generator, device=device,
            **extra) if conv_type == "kanconv" else None

        def block(in_c, out_c, k, stride):
            if conv_type == "kanconv":
                return kan_factory(in_c, out_c, kernel_size=k, stride=stride,
                                   groups=1, dilation=1)
            return StdConvBlock(
                in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                base_activation=act_name, norm_layer=std_norm,
                norm_kwargs=norm_kwargs, generator=generator, device=device)

        self._plan = [self._scoped(block(input_channels,
                                         cfgs[0].input_channels, 3, 2))]
        mc = {"conv_type": conv_type, "kan_factory": kan_factory,
              "replace_depthwise": replace_depthwise,
              "norm_layer": std_norm, "norm_kwargs": norm_kwargs,
              "generator": generator, "device": device}
        for cnf in cfgs:
            self._plan.append(self._scoped(_MNV3Block(mc, cnf)))
        last_in, last_out = cfgs[-1].out_channels, cfgs[-1].expanded_channels
        self._plan.append(self._scoped(block(last_in, last_out, 1, 1)))
        self.Linear_0 = Linear(last_out, last_channel, generator=generator,
                               device=device)
        self.Linear_1 = Linear(last_channel, num_classes, generator=generator,
                               device=device)
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
        return (f"MobileNetV3KAN{head}{convs}{rdw}_{self.arch.upper()}"
                f"_w{self.width_mult}")

    def forward(self, x, generator: torch.Generator = None):
        """Logits for NHWC x; ``generator`` draws the dropout masks in train
        mode (None: the device's default generator)."""
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"expected {self.input_channels} channels (NHWC),"
                             f" got {tuple(x.shape)}")
        for name in self._plan:
            m = getattr(self, name)
            x = checkpoint_block(m, x, generator) if \
                self.remat and isinstance(m, _MNV3Block) else m(x, generator)
        x = adaptive_avg_pool(x, (1, 1)).reshape(x.shape[0], -1)
        x = hardswish(self.Linear_0(x))
        if self.training:
            x = head_dropout(x, self.dropout, generator)
        return self.Linear_1(x)


def mobilenet_v3_kan(arch: str, num_classes: int = 1000, **kwargs
                     ) -> MobileNetV3KAN:
    """Builder with the reference's flag vocabulary: keys the model does
    not take are dropped (among them the ``classifier_*`` overrides, which
    shape only the KAN head); ``generator``, ``device`` and ``dtype`` pass
    through."""
    names = set(signature(MobileNetV3KAN.__init__).parameters)
    return MobileNetV3KAN(arch, num_classes=num_classes,
                          **{k: v for k, v in kwargs.items() if k in names})
