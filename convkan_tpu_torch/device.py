"""Device resolution and float32 numerics for the port.

``resolve_device(None)`` means the GPU: a host without one raises instead of
silently running on the CPU.  The CPU is used only when asked for by name.

TF32 is switched off for float32 matmuls and cuDNN convolutions, so that
float32 on the card means full float32, as the JAX reference computes it
(the JAX tests pin ``jax_default_matmul_precision='highest'``).
"""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (parity numerics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises when no GPU is present); else the named
    device.  Also turns TF32 off (see ``set_full_f32``)."""
    set_full_f32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; convkan_tpu_torch runs on the "
                "GPU by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
