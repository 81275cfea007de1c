"""convkan_tpu_torch — the PyTorch/CUDA port of convkan_tpu.

Activations are channel-last (NHWC) at every public function, exactly as
in the JAX package, so the two can be compared tensor for tensor.  Entry
points run on the GPU (``cuda``) unless the caller passes ``device="cpu"``;
on a CUDA tensor each KAN conv runs the hand-written kernel in
``kernels/kan_conv2d.py`` or raises, and on a CPU tensor it runs that
kernel's plain PyTorch version.

This package imports neither JAX nor anything of ``convkan_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
