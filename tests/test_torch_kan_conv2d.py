"""Port parity for the KAN-conv kernel module
(convkan_tpu_torch/kernels/kan_conv2d.py).

On this CPU host the wrapper runs the kernel's plain PyTorch version; it is
held against BOTH TPU forward kernels it replaces, run in Pallas interpret
mode as tests/test_pallas_kernels.py runs them: the wide kernel
(make_wide_kan_conv_op) and the per-tap kernel (fused_kan_conv2d).  Float32
(the Pallas out_shape is float32); atol = rtol = 1e-5 covers the different
summation order.  The CUDA kernel itself is checked on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.bspline import bspline_basis_unrolled_list
from convkan_tpu.kernels.fused_kan_conv import fused_kan_conv2d
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.utils.activations import silu as jax_silu
from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc

torch.set_num_threads(1)

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
K = 8


def _inputs(B, H, C, O, seed=0, scale=2.5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS)] = KNOTS  # exact knot values occur
    bw = rng.normal(0, 0.2, (3, 3, C, O)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, C * K, O)).astype(np.float32)
    return x, bw, pw


def _port(x, bw, pw, act="silu"):
    return kc.kan_conv2d(torch.from_numpy(x), torch.from_numpy(bw),
                         torch.from_numpy(pw), KNOTS, 3, 3, 1, act).numpy()


def _basis_fn(xt):
    return bspline_basis_unrolled_list(xt, KNOTS, 3)


@pytest.mark.parametrize("tpu_kernel", ["wide", "fused"])
@pytest.mark.parametrize("C,O", [(3, 8), (3, 16), (16, 8), (16, 16)])
def test_plain_kernel_matches_tpu_kernels(tpu_kernel, C, O):
    x, bw, pw = _inputs(2, 8, C, O, seed=C * 100 + O)
    xj, bwj, pwj = jnp.asarray(x), jnp.asarray(bw), jnp.asarray(pw)
    if tpu_kernel == "wide":
        op = make_wide_kan_conv_op(
            basis_list_fn=_basis_fn, num_basis=K, base_act=jax_silu,
            kernel_size=3, padding=1, degree_major=False, has_base=True,
            interpret=True)
        want = np.asarray(op(xj, bwj, pwj))
    else:
        want = np.asarray(fused_kan_conv2d(
            xj, jax_silu(xj), bwj, pwj, basis_list_fn=_basis_fn, num_basis=K,
            padding=1, kernel_size=3, interpret=True))
    got = _port(x, bw, pw)
    assert want.dtype == np.float32 and got.shape == want.shape == (2, 8, 8, O)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_pad_is_zero_after_expansion():
    """Padding x with zeros before the expansion would add B-spline(0) != 0
    on the border; the port's pad must contribute nothing."""
    x, bw, pw = _inputs(1, 4, 3, 4, seed=7)
    y = _port(x, bw, pw)
    xt = torch.from_numpy(x)
    wrong = kc.kan_conv2d_reference(
        torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)), torch.from_numpy(bw),
        torch.from_numpy(pw), KNOTS, 3, 3, 0, "silu").numpy()
    assert np.abs(y - wrong)[:, 0].max() > 1e-3   # border rows differ
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], wrong[:, 1:-1, 1:-1],
                               atol=1e-5, rtol=1e-5)


def test_pack_w_all_matches_jax():
    from convkan_tpu.kernels.wide_kan_conv import pack_w_all as jax_pack

    _, bw, pw = _inputs(1, 4, 5, 6, seed=3)
    want = np.asarray(jax_pack(jnp.asarray(bw), jnp.asarray(pw), C=5, K=K,
                               k=3, O=6, degree_major=False))
    got = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=5, K=K,
                        k=3, O=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_never_touch_the_kernel():
    kc.reset_launches()
    x, bw, pw = _inputs(1, 4, 3, 4)
    _port(x, bw, pw)
    assert sum(kc.launches.values()) == 0


def _args(x, bw, pw):
    return (torch.from_numpy(x), torch.from_numpy(bw), torch.from_numpy(pw),
            KNOTS, 3, 3, 1, "silu")


def test_wrapper_refuses_bad_inputs():
    x, bw, pw = _inputs(1, 4, 3, 4)
    xt, bwt, pwt = torch.from_numpy(x), torch.from_numpy(bw), \
        torch.from_numpy(pw)
    call = lambda *a: kc.kan_conv2d(*a, KNOTS, 3, 3, 1, "silu")  # noqa: E731
    with pytest.raises(TypeError):            # half: neither float32 nor float64
        call(xt.half(), bwt.half(), pwt.half())
    with pytest.raises(TypeError):            # mixed dtypes
        call(xt.double(), bwt, pwt)
    with pytest.raises(ValueError):           # non-contiguous
        call(xt.transpose(1, 2), bwt, pwt)
    with pytest.raises(ValueError):           # wrong weight shape
        call(xt, bwt[:, :, :2], pwt)
    with pytest.raises(ValueError):           # not NHWC
        call(xt[0], bwt, pwt)
    # the kernel route (what a CUDA tensor takes) accepts float32 only
    with pytest.raises(TypeError):
        kc.check_inputs(*_args(x.astype(np.float64), bw.astype(np.float64),
                               pw.astype(np.float64)), for_kernel=True)
    with pytest.raises(ValueError):           # CPU tensors are not CUDA
        kc.check_inputs(*_args(x, bw, pw), for_kernel=True)


def test_launch_config_tiles_vgg16_small():
    """Every VGG16_small conv shape gets a tile that fits the block."""
    for H, C, O in [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
                    (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
                    (2, 128, 128)]:
        for B in (1, 64, 1024):
            cfg = kc.launch_config(B, H, H, C, O, 3, 1, K)
            pixels = kc.THREADS // (cfg["BN"] // kc.TN) * kc.TM
            assert cfg["NB"] * cfg["TH"] * H <= pixels
            assert cfg["NB"] <= B and cfg["CC"] == min(C, kc.MAX_CHUNK)
    with pytest.raises(NotImplementedError):
        kc.launch_config(1, 4, 4096, 3, 16, 3, 1, K)   # row wider than a tile
