"""On-device input pipeline, port of ``normalize_batch``,
``_batched_crop``, ``augment_batch``, ``imagenet_batch`` (its evaluation
form), ``train_batch`` and ``_synthetic`` of ``convkan_tpu/train/data.py``,
with its own copy of the per-dataset and ImageNet constants (the
reference's utils/dataloader.py values).

Crop offsets and flips come from an explicit ``torch.Generator`` or are
passed in (the tests pass the same ones to the JAX package, whose random
stream the port cannot reproduce)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dropout import uniform

CROP_PAD = 4   # RandomCrop(32, padding=4)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMAGENET_RESIZE_SIZE = 256
IMAGENET_CROP_SIZE = 224

NORMALIZATION = {
    "MNIST": (np.array([0.1307], np.float32), np.array([0.3081], np.float32)),
    "SVHN": (np.array([0.4377, 0.4438, 0.4728], np.float32),
             np.array([0.1980, 0.2010, 0.1970], np.float32)),
    "CIFAR10": (np.array([0.4914, 0.4822, 0.4465], np.float32),
                np.array([0.2470, 0.2435, 0.2616], np.float32)),
    "CIFAR100": (np.array([0.5071, 0.4867, 0.4408], np.float32),
                 np.array([0.2675, 0.2565, 0.2761], np.float32)),
}


def input_shape(dataset: str):
    """(H, W, C) of one image of ``dataset`` (CIFAR-sized unless MNIST)."""
    if dataset not in NORMALIZATION:
        raise ValueError(f"unknown dataset {dataset!r}")
    return (28, 28, 1) if dataset == "MNIST" else (32, 32, 3)


def normalize_batch(x_uint8: torch.Tensor, dataset: str) -> torch.Tensor:
    """uint8 NHWC -> float32: divide by 255, then (x - mean) / std, on the
    tensor's own device (ToTensor + Normalize parity)."""
    mean, std = NORMALIZATION[dataset]
    x = x_uint8.to(torch.float32) / 255.0
    mean_t = torch.as_tensor(mean, device=x.device).reshape(1, 1, 1, -1)
    std_t = torch.as_tensor(std, device=x.device).reshape(1, 1, 1, -1)
    return (x - mean_t) / std_t


def _synthetic(dataset: str, n: int, seed: int = 0):
    """Seeded random uint8 images (n, H, W, C) and int32 labels, the JAX
    package's synthetic data (same numpy draws)."""
    rng = np.random.RandomState(seed)
    nc = 100 if dataset == "CIFAR100" else 10
    x = rng.randint(0, 256, size=(n,) + input_shape(dataset), dtype=np.uint8)
    y = rng.randint(0, nc, size=(n,), dtype=np.int32)
    return x, y


def _batched_crop(xp, offs, out_h: int, out_w: int, flip=None):
    """Per-sample integer crop of xp (B, Hp, Wp, C) at offs (B, 2) (row,
    column), optionally mirrored left-right where ``flip`` (B,) is True,
    as two gathers."""
    B, _, Wp, C = xp.shape
    ar_h = torch.arange(out_h, device=xp.device)
    ar_w = torch.arange(out_w, device=xp.device)
    rows = offs[:, 0:1] + ar_h[None]                          # (B, out_h)
    cols = offs[:, 1:2] + ar_w[None]                          # (B, out_w)
    if flip is not None:
        cols = torch.where(flip[:, None], offs[:, 1:2] + (out_w - 1)
                           - ar_w[None], cols)                # fold the flip
    xg = torch.gather(xp, 1, rows[:, :, None, None].expand(B, out_h, Wp, C))
    return torch.gather(xg, 2,
                        cols[:, None, :, None].expand(B, out_h, out_w, C))


def crop_params(batch: int, device, generator: Optional[torch.Generator] = None,
                pad: int = CROP_PAD):
    """Random crop offsets (batch, 2) in [0, 2*pad] and flips (batch,)
    with probability 0.5, drawn from ``generator`` (offsets first)."""
    offs = (uniform((batch, 2), device, generator) * (2 * pad + 1)).long()
    flips = uniform((batch,), device, generator) < 0.5
    return offs.clamp_(max=2 * pad), flips


def augment_batch(x, *, generator: Optional[torch.Generator] = None,
                  offsets=None, flips=None):
    """Random HxW crop from a 4-pixel zero pad plus a horizontal flip, per
    sample, on x's device (utils/dataloader.py:70-71 parity).  Missing
    ``offsets`` / ``flips`` are drawn from ``generator``."""
    B, H, W, _ = x.shape
    if offsets is None or flips is None:
        drawn = crop_params(B, x.device, generator)
        offsets = drawn[0] if offsets is None else offsets
        flips = drawn[1] if flips is None else flips
    xp = F.pad(x, (0, 0, CROP_PAD, CROP_PAD, CROP_PAD, CROP_PAD))
    return _batched_crop(xp, offsets.to(x.device).long(), H, W,
                         flip=flips.to(x.device).bool())


def _resize(x, h: int, w: int):
    """Bilinear resize of NHWC float x to (h, w) with half-pixel centres, as
    jax.image.resize(method="bilinear") computes it: its triangle kernel
    widened by the scale when downsampling is F.interpolate's antialiased
    bilinear (the same as the plain one when upsampling)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True
                         ).permute(0, 2, 3, 1)


def imagenet_batch(x_uint8, train: bool, dataset: str):
    """utils/dataloader.py:26-54 on the tensor's device, evaluation form:
    MNIST resized to 224 and repeated to 3 channels; the others resized so
    that the short side is 256, then the centre 224 x 224; then / 255 and
    ImageNet's mean and std.  The training form (RandomResizedCrop and
    flip) is not ported yet."""
    if train:
        raise NotImplementedError("imagenet_batch(train=True) "
                                  "(random_resized_crop) is not ported yet")
    x = x_uint8.to(torch.float32)
    B, H, W, C = x.shape
    S = IMAGENET_CROP_SIZE
    if dataset == "MNIST":
        x = _resize(x, S, S)
        if C == 1:
            x = x.repeat(1, 1, 1, 3)
    else:
        R = IMAGENET_RESIZE_SIZE
        nh, nw = (R, max(round(W * R / H), R)) if H <= W else \
            (max(round(H * R / W), R), R)
        x = _resize(x, nh, nw)
        h0, w0 = (nh - S) // 2, (nw - S) // 2
        x = x[:, h0:h0 + S, w0:w0 + S, :]
    x = x / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).reshape(1, 1, 1, -1)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).reshape(1, 1, 1, -1)
    return (x - mean) / std


def train_batch(x_uint8, dataset: str, augment: bool, *,
                generator: Optional[torch.Generator] = None, offsets=None,
                flips=None, imagenet: bool = False):
    """uint8 batch -> augmented, normalized float32 batch on its device.
    Crop and flip are permutations with a zero pad, so they run on the
    uint8 batch and the normalization after (pad before normalize).
    ``imagenet``: ``imagenet_batch`` (its training form when
    ``augment``)."""
    if imagenet:
        return imagenet_batch(x_uint8, augment, dataset)
    if augment:
        x_uint8 = augment_batch(x_uint8, generator=generator,
                                offsets=offsets, flips=flips)
    return normalize_batch(x_uint8, dataset)
