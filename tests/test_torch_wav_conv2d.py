"""Port parity for the WavKAN psi-conv kernel module
(convkan_tpu_torch/kernels/wav_conv2d.py).

On this CPU host the wrapper runs its plain PyTorch version.  It is held
against the TPU kernels it replaces, ``fused_wav_conv2d`` (``_fwd_kernel``
and, through its custom_vjp, ``_bwd_kernel``) run in Pallas interpret mode
in float64, forward and the gradients w.r.t. x, w, t and s, for all five
wavelets: max |diff| <= 1e-10 of the largest entry.  Scale and translation
are moved off their 1 / 0 init as tests/test_fused_wav.py does.  The CUDA
kernels themselves are checked on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.kernels import fused_wav_conv as fwc
from convkan_tpu_torch.kernels import wav_conv2d as wc

torch.set_num_threads(1)

WAVELETS = ["mexican_hat", "morlet", "dog", "meyer", "shannon"]
# (H, C, O) of the VGG16_small convs (9 distinct shapes) and the three
# convs of the BASELINE config-4 stack
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]
CONFIG4 = [(32, 3, 32), (16, 32, 64), (8, 64, 128)]
# wavelet breakpoints and Shannon's series branch
SPECIAL = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 5e-5, -5e-5, 1e-4, 2.0])


def _inputs(B, H, W, C, O, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1.0, (B, H, W, C))
    w = rng.normal(0, 0.3, (3, 3, C, O))
    s = 1.0 + 0.3 * rng.rand(O, C)
    t = 0.5 * rng.randn(O, C)
    g = rng.normal(0, 1.0, (B, H, W, O))
    return x, w, t, s, g


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= 1e-10 * scale, what


@pytest.mark.parametrize("wavelet_type", WAVELETS)
def test_psi_table_matches_jax(wavelet_type):
    z = np.concatenate([SPECIAL, np.random.RandomState(0).uniform(-4, 4, 64)])
    for port_fn, jax_fn in zip(wc.PSI[wavelet_type], fwc.PSI[wavelet_type]):
        got = port_fn(torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_fn(jnp.asarray(z))),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("wavelet_type", WAVELETS)
@pytest.mark.parametrize("B,H,W,C,O,pad", [
    (2, 5, 6, 3, 4, 1),        # padded, the first conv's C
    (2, 5, 6, 8, 4, 1),        # padded
    (1, 6, 5, 3, 4, 0),        # unpadded
])
def test_reference_matches_pallas_f64(wavelet_type, B, H, W, C, O, pad):
    x, w, t, s, _ = _inputs(B, H, W, C, O, seed=H * C + O)
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    g = np.random.RandomState(1).normal(0, 1, (B, Ho, Wo, O))
    op = lambda *a: fwc.fused_wav_conv2d(  # noqa: E731
        *a, wavelet_type=wavelet_type, padding=pad, interpret=True)
    y, pull = jax.vjp(op, *(jnp.asarray(a) for a in (x, w, t, s)))
    assert y.dtype == jnp.float64
    want = [y] + list(pull(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, t, s)]
    yt = wc.wav_conv2d(*leaves, wavelet_type=wavelet_type, padding=pad)
    got = [yt.detach()] + list(torch.autograd.grad(yt, leaves,
                                                   torch.from_numpy(g)))
    for name, a, b in zip(("y", "dx", "dw", "dt", "ds"), got, want):
        _close(a.numpy(), b, f"{wavelet_type} {name}")


def test_shannon_single_channel_matches_pallas_f64():
    """C = 1: the Hamming window of one channel is [1]."""
    x, w, t, s, g = _inputs(2, 4, 4, 1, 3, seed=5)
    op = lambda *a: fwc.fused_wav_conv2d(  # noqa: E731
        *a, wavelet_type="shannon", padding=1, interpret=True)
    y, pull = jax.vjp(op, *(jnp.asarray(a) for a in (x, w, t, s)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, t, s)]
    yt = wc.wav_conv2d(*leaves, wavelet_type="shannon", padding=1)
    _close(yt.detach().numpy(), y, "y")
    for name, a, b in zip(("dx", "dw", "dt", "ds"),
                          torch.autograd.grad(yt, leaves, torch.from_numpy(g)),
                          pull(jnp.asarray(g))):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("wavelet_type", ["mexican_hat", "shannon"])
def test_plain_kernel_versions_agree_with_autograd(wavelet_type):
    """The kernels' plain versions (windowless psi, window folded into w):
    the psi-conv equals the module's reference, input_grad and
    param_grads are its gradients, and the per-split partials reduced in
    order give param_grads."""
    B, H, W, C, O = 5, 4, 4, 6, 8
    x, w, t, s, g = (torch.from_numpy(a) for a in _inputs(B, H, W, C, O, 3))
    ham = torch.from_numpy(wc.hamming_window(C)) \
        if wavelet_type == "shannon" else torch.ones(C, dtype=x.dtype)
    wf = (w * ham[None, None, :, None]).contiguous()
    spec = (wavelet_type, 1)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, t, s)]
    y = wc.wav_conv2d_reference(*leaves, wavelet_type=wavelet_type,
                                padding=1)
    torch.testing.assert_close(y, wc.psi_conv_reference(x, wf, t, s, *spec),
                               rtol=1e-12, atol=1e-12)
    dx, dw, dt, ds = torch.autograd.grad(y, leaves, g)
    torch.testing.assert_close(wc.input_grad(x, wf, t, s, g, *spec), dx,
                               rtol=1e-12, atol=1e-12)
    got = wc.param_grads(x, wf, t, s, g, *spec)
    for a, b in zip(got, (dw / ham[None, None, :, None], dt, ds)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    cfg = wc.param_launch_config(B, H, W, C, O, 3, 1)
    partial = wc.param_partials(x, wf, t, s, g, *spec)
    assert partial.shape == (cfg["S"], cfg["N"]) and cfg["S"] == B
    for a, b in zip(wc.split_param_grads(wc.reduce_partials(partial), 3, C,
                                         O), got):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_pad_is_zero_after_psi():
    """psi(-t/s) != 0: padding x with zeros before psi would add it on the
    border; the port's pad must contribute nothing."""
    x, w, t, s, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 3, 4, 7))
    y = wc.wav_conv2d(x, w, t, s, wavelet_type="mexican_hat", padding=1)
    wrong = wc.wav_conv2d(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)),
                          w, t, s, wavelet_type="mexican_hat", padding=0)
    assert (y - wrong)[:, 0].abs().max() > 1e-3      # border rows differ
    torch.testing.assert_close(y[:, 1:-1, 1:-1], wrong[:, 1:-1, 1:-1],
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_reach_the_kernels():
    wc.reset_launches()
    leaves = [torch.from_numpy(a).float().requires_grad_(True)
              for a in _inputs(2, 4, 4, 3, 4, 0)[:4]]
    y = wc.wav_conv2d(*leaves, wavelet_type="morlet", padding=1)
    y.square().sum().backward()
    assert all(a.grad is not None for a in leaves)
    assert sum(wc.launches.values()) == 0
    with pytest.raises(ValueError):            # the kernel route needs CUDA
        wc.check_inputs(*[a.detach() for a in leaves], "morlet", 1,
                        for_kernel=True)


def test_wrapper_refuses_bad_inputs():
    x, w, t, s = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 3, 4, 0)[:4])
    call = lambda *a, wt="dog": wc.wav_conv2d(  # noqa: E731
        *a, wavelet_type=wt, padding=1)
    with pytest.raises(TypeError):             # mixed dtypes
        call(x.float(), w, t, s)
    with pytest.raises(TypeError):             # half precision
        call(x.half(), w.half(), t.half(), s.half())
    with pytest.raises(ValueError):            # non-contiguous
        call(x.transpose(1, 2), w, t, s)
    with pytest.raises(ValueError):            # translation not (O, C)
        call(x, w, t.T.contiguous(), s)
    with pytest.raises(ValueError):            # unknown wavelet
        call(x, w, t, s, wt="haar")
    with pytest.raises(TypeError):             # the kernels take float32
        wc.check_inputs(x, w, t, s, "dog", 1, for_kernel=True)
    with pytest.raises(NotImplementedError):   # 5x5: not carried
        wc._check_kernel_args(x.float(), torch.zeros(5, 5, 3, 4), "dog", 2)


def test_launch_configs_tile_vgg16_small_and_config4():
    """Every VGG16_small and config-4 conv shape gets tiles that fit, at
    the batches the card runs; the parameter split depends on the shape
    only and covers the batch.  The data-gradient block is whole warps of
    4-channel groups over a compiled row width on the small planes and, at
    batch 1024, fits 3 to an SM.  At batch 1024 the parameter block is whole
    warps of pairs (OC x CG x RS threads), cp.async-pipelined over a
    compiled row width, and small enough that 3 fit an SM's shared memory;
    its split balances the SMs over the blocks that fit (registers at the
    launch bounds' cap)."""
    for H, C, O in VGG16_SMALL + CONFIG4:
        for B in (1, 16, 64, 1024):
            f = wc.fwd_launch_config(B, H, H, C, O, 3, 1)
            # whole warps of OG output channels x NT tile slots; a compiled
            # width (the whole row) on the 8x8, 4x4 and 2x2 planes, else
            # strips of 8; bands of rows that cover the plane
            assert f["OG"] * f["NT"] == f["threads"] == wc.FWD_THREADS
            assert f["compiled"] == (H in wc.FWD_WIDTHS)
            assert f["TW"] == (H if f["compiled"] else wc.FWD_TW)
            assert f["bands"] * f["RB"] >= H and f["CC"] == wc.FWD_CC
            d = wc.dx_launch_config(B, H, H, C, O, 3, 1)
            # whole warps of 4-channel groups x images, the warps at NPB
            # tile positions x 4 / NPB image groups; a compiled width with
            # its pad taps left out on the 8x8, 4x4 and 2x2 planes
            assert d["threads"] == wc.DX_THREADS and d["threads"] % 32 == 0
            assert d["CT"] == wc.DX_CT and 32 % d["CG"] == 0
            assert d["NIB"] * d["CG"] * d["NPB"] == d["threads"]
            assert d["compiled"] == (H in wc.DX_WIDTHS)
            assert d["WT"] == (H if d["compiled"] else 0)
            assert d["grid"][1] * d["CT"] * d["CG"] >= C
            assert d == wc.dx_launch_config(B, H, H, C, O, 3, 1)
            p = wc.param_launch_config(B, H, H, C, O, 3, 1)
            assert p["OC"] * p["CG"] * p["RS"] == p["threads"]
            assert p["threads"] % 32 == 0 and p["RB"] % p["RS"] == 0
            assert p["pipe"] and p["compiled"] and p["CT"] == wc.PARAM_CT
            assert p["S"] * p["ips"] >= B > (p["S"] - 1) * p["ips"]
            assert p == wc.param_launch_config(B, H, H, C, O, 3, 1)
            if B < 1024:
                continue
            # the data gradient: 3 blocks an SM within shared memory and
            # registers, blocks on every SM
            assert d["smem"] <= wc.SM_SMEM // 3 - 1024
            assert d["blocks_per_sm"] == 3 == wc.SM_REGS // (
                d["threads"] * wc.DX_REGS)
            assert d["blocks"] >= wc.SMS
            assert p["smem"] <= wc.PARAM_SMEM
            assert wc.SM_SMEM // (p["smem"] + 1024) >= 3
            assert p["blocks_per_sm"] == wc.SM_REGS // (
                p["threads"] * wc.PARAM_REGS)
            assert p["blocks"] == p["tiles"] * p["S"] >= wc.SMS
            # the split: no other one puts fewer blocks x images on the
            # busiest SM (at least the blocks resident at once) by more
            # than the slack, and none within it has fewer splits
            def cost(ips):
                blocks = p["tiles"] * -(-B // ips)
                return max(-(-blocks // wc.SMS), p["blocks_per_sm"]) * ips
            least = min(cost(ips) for ips in range(1, B + 1))
            assert cost(p["ips"]) <= (1 + wc.PARAM_SPLIT_SLACK) * least
            assert all(-(-B // ips) >= p["S"] for ips in range(1, B + 1)
                       if cost(ips) <= (1 + wc.PARAM_SPLIT_SLACK) * least)
            assert p["waves"] <= 1.5
    with pytest.raises(NotImplementedError):
        wc.param_launch_config(1, 4, 100000, 3, 16, 3, 1)   # row too wide
