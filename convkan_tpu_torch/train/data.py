"""Input normalization, port of ``normalize_batch`` in
``convkan_tpu/train/data.py`` with its own copy of the per-dataset
constants (the reference's utils/dataloader.py values)."""

from __future__ import annotations

import numpy as np
import torch

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
