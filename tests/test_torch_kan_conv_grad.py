"""Port parity for the KAN-conv gradient (the training slice's kernels in
convkan_tpu_torch/kernels/kan_conv2d.py, and KanConvND under autograd).

On this CPU host the wrappers run their plain PyTorch versions.  They are
held against
  * the TPU backward kernel they replace, ``bwd_kernel`` of
    ``make_wide_kan_conv_op`` run in Pallas interpret mode as
    tests/test_pallas_kernels.py runs it, in float32 (rtol = atol = 1e-4:
    dW sums B*H*W = 128 products per entry in another order);
  * the JAX package's default (XLA) KanConvND path in float64, gradients
    of a random linear functional of the module output (max |diff| <=
    1e-10).
The CUDA kernels themselves are checked on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.bspline import bspline_basis_unrolled_list
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.activations import silu as jax_silu
from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.basis.bspline import (
    bspline_basis_unrolled_list as port_basis)
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND

torch.set_num_threads(1)

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
K = 8
# (H, C, O) of the VGG16_small convs (9 distinct shapes)
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


def _inputs(B, H, C, O, seed, dtype=np.float32, scale=2.5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (B, H, H, C))
    x.reshape(-1)[:len(KNOTS)] = KNOTS  # exact knot values occur
    bw = rng.normal(0, 0.2, (3, 3, C, O))
    pw = rng.normal(0, 0.2, (3, 3, C * K, O))
    g = rng.normal(0, 1, (B, H, H, O))
    return tuple(a.astype(dtype) for a in (x, bw, pw, g))


def _port_grads(x, bw, pw, g, act="silu"):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, bw, pw)]
    y = kc.kan_conv2d(*leaves, KNOTS, 3, 3, 1, act)
    return [t.numpy() for t in torch.autograd.grad(y, leaves,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("C,O", [(3, 8), (16, 16)])
def test_grads_match_pallas_bwd_kernel(C, O):
    x, bw, pw, g = _inputs(2, 8, C, O, seed=C * 10 + O)
    op = make_wide_kan_conv_op(
        basis_list_fn=lambda t: bspline_basis_unrolled_list(t, KNOTS, 3),
        num_basis=K, base_act=jax_silu, kernel_size=3, padding=1,
        degree_major=False, has_base=True, interpret=True)
    y, pull = jax.vjp(op, jnp.asarray(x), jnp.asarray(bw), jnp.asarray(pw))
    assert y.dtype == jnp.float32
    want = [np.asarray(t) for t in pull(jnp.asarray(g))]
    got = _port_grads(x, bw, pw, g)
    for name, a, b in zip(("dx", "dbase_w", "dpoly_w"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("C,O,act", [(3, 8, "silu"), (16, 16, "silu"),
                                     (5, 12, "gelu")])
def test_module_grads_match_jax_xla_path_f64(C, O, act):
    x, bw, pw, g = _inputs(2, 8, C, O, seed=C + O, dtype=np.float64,
                           scale=1.5)
    prelu = np.array([-0.3])
    jm = JaxKanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                      padding=1, base_activation=act,
                      param_dtype=jnp.float64)

    def f(xx, p):
        return jnp.sum(jm.apply({"params": p}, xx, train=False) * g)

    params = {"base_w": bw, "poly_w": pw, "prelu": prelu}
    jdx, jdp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)

    tm = KanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                   padding=1, base_activation=act, device="cpu",
                   dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm.eval()(xt) * torch.from_numpy(g)).sum().backward()
    assert np.max(np.abs(xt.grad.numpy() - np.asarray(jdx))) <= 1e-10
    for name, p in tm.named_parameters():
        assert np.max(np.abs(p.grad.numpy() - np.asarray(jdp[name]))) <= \
            1e-10, name


def test_plain_kernel_versions_agree_with_autograd():
    """The wrappers' plain versions: input_grad and weight_grad are the
    gradients of kan_conv2d_reference, and the per-split partials reduced
    in order give weight_grad."""
    x, bw, pw, g = _inputs(5, 4, 6, 8, seed=4, dtype=np.float64)
    xt, bwt, pwt, gt = (torch.from_numpy(a) for a in (x, bw, pw, g))
    w_all = kc.pack_w_all(bwt, pwt, C=6, K=K, k=3, O=8)
    wl = w_all.clone().requires_grad_(True)
    xl = xt.clone().requires_grad_(True)
    y = kc._conv_w_all(kc.expand(xl, KNOTS, 3, "silu"), wl, 3, 1)
    want_dx, want_dw = torch.autograd.grad(y, (xl, wl), gt)
    dx = kc.input_grad(xt, w_all, gt, KNOTS, 3, 3, 1, "silu")
    dw = kc.weight_grad(xt, gt, KNOTS, 3, 3, 1, "silu")
    torch.testing.assert_close(dx, want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    partial = kc.weight_partials(xt, gt, KNOTS, 3, 3, 1, "silu")
    cfg = kc.dw_launch_config(5, 4, 4, 6, 8, 3, 1, K)
    assert partial.shape == (cfg["S"], 9 * 6, 9 * 8) and cfg["S"] == 5
    torch.testing.assert_close(kc.reduce_partials(partial), want_dw,
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_launch_backward_kernels():
    kc.reset_launches()
    _port_grads(*_inputs(1, 4, 3, 4, seed=0))
    assert sum(kc.launches.values()) == 0


def test_backward_launch_configs_tile_vgg16_small():
    """Every VGG16_small conv shape gets data- and weight-gradient tiles
    that fit, and the split count depends on the shape only."""
    for H, C, O in VGG16_SMALL:
        for B in (1, 16, 64, 1024):
            dx = kc.dx_launch_config(B, H, H, C, O, 3, 1, K)
            assert dx["NB"] * dx["TH"] * H <= kc.DX_PIXELS
            assert dx["CC"] == min(C, kc.DX_MAX_CC) and dx["OC"] % 4 == 0
            dw = kc.dw_launch_config(B, H, H, C, O, 3, 1, K)
            assert (dw["rs"] // kc.DW_TR) * (dw["BN"] // kc.DW_TN) <= \
                kc.THREADS
            assert dw["S"] * dw["ips"] >= B > (dw["S"] - 1) * dw["ips"]
            assert dw == kc.dw_launch_config(B, H, H, C, O, 3, 1, K)
    with pytest.raises(NotImplementedError):
        kc.dx_launch_config(1, 4, 4096, 3, 16, 3, 1, K)   # row too wide


def test_grad_wrappers_refuse_bad_gradients():
    x, bw, pw, g = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 4, seed=0))
    w_all = kc.pack_w_all(bw, pw, C=3, K=K, k=3, O=4)
    with pytest.raises(ValueError):          # wrong output-gradient shape
        kc.input_grad(x, w_all, g[:, :2], KNOTS, 3, 3, 1, "silu")
    with pytest.raises(TypeError):           # dtype differs from x
        kc.weight_grad(x, g.double(), KNOTS, 3, 3, 1, "silu")


def _recurrence_f32(x, knots, order, span_only):
    """float32 emulation of the CUDA basis loops (every operation rounded
    to float32 as __fsub_rn/__fdiv_rn/__fmul_rn/__fadd_rn do): the full
    Cox-de Boor recurrence (every basis at every level), or the
    span-limited one of csrc/kan_bspline.cuh (bspline_span, which the
    forward and backward kernels share), for a vector x."""
    f32 = np.float32
    kn = np.asarray(knots, f32)
    nk = len(kn)
    K = nk - order - 1

    def deltas(i, k):
        dr = kn[i + k] - kn[i]
        dd = kn[i + k + 1] - kn[i + 1]
        return np.where(dr == 0, f32(1), dr), np.where(dd == 0, f32(1), dd)

    if not span_only:
        b = [((x >= kn[i]) & (x < kn[i + 1])).astype(f32)
             for i in range(nk - 1)]
        for k in range(1, order + 1):
            for i in range(nk - 1 - k):
                dr, dd = deltas(i, k)
                b[i] = ((x - kn[i]) / dr) * b[i] + \
                    ((kn[i + k + 1] - x) / dd) * b[i + 1]
        return np.stack(b[:K], -1)
    j = np.full(x.shape, -1)
    for i in range(nk - 1):
        j = np.where((x >= kn[i]) & (x < kn[i + 1]), i, j)
    N = [np.ones_like(x)]
    for k in range(1, order + 1):
        nw = []
        for m in range(k + 1):
            i = j - k + m
            ok = (i >= 0) & (i <= nk - 2 - k)
            ic = np.clip(i, 0, nk - 2 - k)
            dr, dd = deltas(ic, k)
            v = np.zeros_like(x)
            if m >= 1:
                v = ((x - kn[ic]) / dr) * N[m - 1]
            if m <= k - 1:
                t2 = ((kn[ic + k + 1] - x) / dd) * N[m]
                v = v + t2 if m >= 1 else t2
            nw.append(np.where(ok, v, f32(0)))
        N = nw
    out = np.zeros(x.shape + (K,), f32)
    for m in range(order + 1):
        kk = j - order + m
        hit = (j >= 0) & (kk >= 0) & (kk < K)
        out[hit, kk[hit]] = N[m][hit]
    return out


def test_span_basis_is_bit_identical_to_full_recurrence():
    """The kernels evaluate only the ORDER+1 bases over x's knot interval;
    every dropped term is an exact 0, so the float32 values are those of
    the full recurrence bit for bit (finite x)."""
    kn = np.asarray(KNOTS, np.float32)
    x = np.concatenate([
        np.random.RandomState(0).uniform(-3, 3, 20000).astype(np.float32),
        kn, np.nextafter(kn, np.float32(9)), np.nextafter(kn, np.float32(-9))])
    with np.errstate(all="ignore"):
        full = _recurrence_f32(x, KNOTS, 3, span_only=False)
        span = _recurrence_f32(x, KNOTS, 3, span_only=True)
    assert full.dtype == span.dtype == np.float32 and full.shape == (20036, K)
    np.testing.assert_array_equal(span, full)
    np.testing.assert_array_equal(   # and both are the port's plain basis
        full, np.stack([b.numpy() for b in port_basis(
            torch.from_numpy(x), KNOTS, 3)], -1))
