"""Port parity for the Chebyshev KAN conv: the plain versions of the CUDA
kernels (kernels/kan_conv2d.py with ``cheby_basis(3)``) and the ChebyKAN
KanConvND, against the JAX package on the same numpy-seeded inputs (8 -> 16
channels at 8x8, batch 2).

  * against the TPU kernels in Pallas interpret mode, as
    tests/test_pallas_kernels.py runs them (the wide ``fwd_kernel`` /
    ``bwd_kernel`` and the per-tap ``fused_kan_conv2d``, ``has_base=False``):
    float32, since the JAX module takes the Pallas route only for float32
    input; forward to 2e-5 and gradients to 5e-5, that file's tolerances
    (float32 sums in another order);
  * against the JAX XLA path (``use_pallas=False``, the trig form of the
    basis): float64, to 1e-10 of the largest entry;
  * the tile rules at R = 4 rows per channel, and the rule that CPU
    tensors never reach a kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.poly import chebyshev_basis_recurrence_list
from convkan_tpu.kernels.fused_kan_conv import make_fused_kan_conv_op
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.ops import dropout as dlib

torch.set_num_threads(1)

CHEBY = kc.cheby_basis(3)
K = 4
C, O = 8, 16
FWD_TOL, GRAD_TOL, F64_TOL = 2e-5, 5e-5, 1e-10


def _inputs(dtype, seed=0, scale=3.0):
    """x U(-scale, scale) with a few values past the clamp, poly_w N(0, 0.2)
    (channel-major rows c*K + n), g N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (2, 8, 8, C))
    x.reshape(-1)[:4] = [9.0, -9.0, 12.0, 0.0]
    pw = rng.normal(0, 0.2, (3, 3, C * K, O))
    g = rng.normal(0, 1, (2, 8, 8, O))
    return tuple(a.astype(dtype) for a in (x, pw, g))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _port_grads(x, pw, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, pw)]
    y = kc.kan_conv2d(leaves[0], None, leaves[1], CHEBY, 3, 1)
    return (y.detach().numpy(),
            *(t.numpy() for t in torch.autograd.grad(y, leaves,
                                                     torch.from_numpy(g))))


def _basis_fn(t):
    return chebyshev_basis_recurrence_list(t, 3, 1e-7)


@pytest.mark.parametrize("tpu_kernel", ["wide", "fused"])
def test_plain_versions_match_pallas_kernels_f32(tpu_kernel):
    """Forward, dx and d poly_w of the plain version against the Pallas
    kernels (the wide op's custom_vjp runs ``bwd_kernel``; the per-tap
    op's, ``fused_kan_conv2d`` forward, recomputes through the reference
    path)."""
    x, pw, g = _inputs(np.float32, seed=1)
    make = make_wide_kan_conv_op if tpu_kernel == "wide" else \
        lambda **kw: make_fused_kan_conv_op(**kw)[0]
    op = make(basis_list_fn=_basis_fn, num_basis=K, base_act=None,
              kernel_size=3, padding=1, degree_major=False, has_base=False,
              interpret=True)
    y, pull = jax.vjp(lambda xx, ww: op(xx, jnp.zeros((), jnp.float32), ww),
                      jnp.asarray(x), jnp.asarray(pw))
    assert y.dtype == jnp.float32
    want = (y, *pull(jnp.asarray(g)))
    got = _port_grads(x, pw, g)
    for name, a, b, tol in zip(("y", "dx", "dpoly_w"), got, want,
                               (FWD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=name)


def test_kernel_wrappers_match_jax_xla_path_f64():
    """The plain versions of the three kernels (forward, input_grad and the
    reduced weight_partials) against jax.vjp of the JAX XLA conv (the
    module's conv before its norm: the trig form of the basis, the
    channel-major poly_w) in float64."""
    x, pw, g = _inputs(np.float64, seed=2)
    jm = JaxKanConvND(family="cheby", input_dim=C, output_dim=O,
                      kernel_size=3, padding=1, norm_layer=None,
                      param_dtype=jnp.float64)
    y, pull = jax.vjp(lambda xx, ww: jm.apply({"params": {"poly_w": ww}}, xx,
                                              train=False),
                      jnp.asarray(x), jnp.asarray(pw))
    jdx, jdpw = pull(jnp.asarray(g))
    xt, pwt, gt = (torch.from_numpy(a) for a in (x, pw, g))
    got = kc.kan_conv2d(xt, None, pwt, CHEBY, 3, 1)
    _close(got, y, F64_TOL, "y")
    w_all = kc.pack_w_all(None, pwt, C=C, K=K, k=3, O=O)
    assert w_all.shape == (K * C, 9 * O)
    _close(kc.input_grad(xt, w_all, gt, CHEBY, 3, 1), jdx, F64_TOL, "dx")
    cfg = kc.dw_launch_config(2, 8, 8, C, O, 3, 1, CHEBY.R)
    part = kc.weight_partials(xt, gt, CHEBY, 3, 1)
    assert part.shape == (cfg["S"], K * C, 9 * O)
    dw = kc.reduce_partials(part)
    torch.testing.assert_close(dw, kc.weight_grad(xt, gt, CHEBY, 3, 1),
                               rtol=1e-12, atol=1e-12)
    # dW_all rows n*C + c back to poly_w's channel-major rows c*K + n
    dpw = dw.reshape(K, C, 3, 3, O).permute(2, 3, 1, 0, 4).reshape(
        3, 3, C * K, O)
    _close(dpw, jdpw, F64_TOL, "dpoly_w")


def test_pad_is_zero_after_expansion():
    """T_0 = 1 at every x: padding x with zeros before the expansion would
    add the taps' sum of w_0 on the border.  The port's pad contributes
    nothing there."""
    x, pw, _ = _inputs(np.float64, seed=3)
    xt, pwt = torch.from_numpy(x), torch.from_numpy(pw)
    y = kc.kan_conv2d_reference(xt, None, pwt, CHEBY, 3, 1).numpy()
    wrong = kc.kan_conv2d_reference(
        torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)), None, pwt, CHEBY, 3,
        0).numpy()
    assert np.abs(y - wrong)[:, 0].min() > 0         # every border pixel
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], wrong[:, 1:-1, 1:-1],
                               rtol=1e-12, atol=1e-12)


def _jax_module(**kw):
    return JaxKanConvND(family="cheby", input_dim=C, output_dim=O,
                        kernel_size=3, padding=1, **kw)


@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax_pallas_interpret_f32(train, monkeypatch):
    """KanConvND("cheby") (conv, InstanceNorm, no PReLU, channel dropout
    0.25 at the output in train mode) against the JAX module on the Pallas
    route in interpret mode, float32, with JAX's dropout mask: the dropped
    channels are the zero channels of JAX's train output (InstanceNorm has
    no running state, so train and eval differ only by the mask)."""
    x, pw, g = _inputs(np.float32, seed=4)
    jm = _jax_module(dropout=0.25, use_pallas=True, pallas_interpret=True)
    params = {"poly_w": jnp.asarray(pw)}

    def jf(xx, p):
        return jm.apply({"params": p}, xx, train=train,
                        rngs={"dropout": jax.random.PRNGKey(5)})

    y, pull = jax.vjp(jf, jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(g))
    tm = KanConvND("cheby", C, O, 3, padding=1, dropout=0.25, device="cpu")
    tm.load_state_dict({"poly_w": torch.from_numpy(pw)}, strict=True)
    if train:
        keep = np.abs(np.asarray(y)).max(axis=(1, 2), keepdims=True) > 0
        assert 0 < keep.sum() < keep.size
        monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None: (
            torch.from_numpy(np.where(keep, 0.0, 0.99).astype(np.float32))))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.train(train)(xt)
    (out * torch.from_numpy(g)).sum().backward()
    for name, a, b, tol in (("y", out.detach(), y, FWD_TOL),
                            ("dx", xt.grad, jdx, GRAD_TOL),
                            ("dpoly_w", tm.poly_w.grad, jdp["poly_w"],
                             GRAD_TOL)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax_xla_path_f64(train, monkeypatch):
    """The same module against the JAX XLA path in float64: output, dx and
    d poly_w to 1e-10 of the largest entry, with JAX's dropout mask."""
    x, pw, g = _inputs(np.float64, seed=6)
    jm = _jax_module(dropout=0.25, param_dtype=jnp.float64)

    def jf(xx, p):
        return jm.apply({"params": p}, xx, train=train,
                        rngs={"dropout": jax.random.PRNGKey(7)})

    y, pull = jax.vjp(jf, jnp.asarray(x), {"poly_w": jnp.asarray(pw)})
    jdx, jdp = pull(jnp.asarray(g))
    tm = KanConvND("cheby", C, O, 3, padding=1, dropout=0.25, device="cpu",
                   dtype=torch.float64)
    tm.load_state_dict({"poly_w": torch.from_numpy(pw)}, strict=True)
    if train:
        keep = np.abs(np.asarray(y)).max(axis=(1, 2), keepdims=True) > 0
        assert 0 < keep.sum() < keep.size
        monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None: (
            torch.from_numpy(np.where(keep, 0.0, 0.99))))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.train(train)(xt)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), y, F64_TOL, "y")
    _close(xt.grad, jdx, F64_TOL, "dx")
    _close(tm.poly_w.grad, jdp["poly_w"], F64_TOL, "dpoly_w")


# (H, C, O) of the VGG16_small convs (9 distinct shapes)
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


@pytest.mark.parametrize("B", [1, 64, 1024])
def test_launch_configs_at_four_rows(B):
    """At R = 4 every VGG16_small shape gets a forward, data-gradient and
    weight-gradient tile within the 227 KB a block may use (two blocks'
    share where the B-spline's R = 9 tile had it), with the tile rules'
    own invariants: the forward's row stride and block count, the data
    gradient's thread per weight entry, the weight gradient's rows of
    whole channels and columns dividing 9*O."""
    R = CHEBY.R
    for H, Cv, Ov in VGG16_SMALL:
        f = kc.launch_config(B, H, H, Cv, Ov, 3, 1, R)
        assert f["smem"] <= kc.SMEM_LIMIT and f["BN"] == Ov
        assert f["rs"] == kc.row_stride(R, f["CC"]) and f["rs"] % 8 == 4
        assert f["blocks"] == f["tiles"] * f["S"]
        assert f["smem"] <= kc.launch_config(B, H, H, Cv, Ov, 3, 1, 9)[
            "smem"] <= kc.SMEM_TWO_BLOCKS
        d = kc.dx_launch_config(B, H, H, Cv, Ov, 3, 1, R)
        assert d["smem"] + kc.DX_SMEM_STATIC <= kc.SMEM_LIMIT
        assert R * d["CC"] * d["OC"] // 4 <= kc.THREADS
        assert d["smem"] == kc.dx_smem(d["tile"], d["pitch"], 9, R, d["CC"],
                                       d["OC"], d["stages"], d["skip"],
                                       d["table"]) <= kc.SMEM_TWO_BLOCKS
        w = kc.dw_launch_config(B, H, H, Cv, Ov, 3, 1, R)
        assert w["smem"] == kc.dw_smem(R, w["CC"], w["BN"], w["PW"]) <= \
            kc.SMEM_TWO_BLOCKS
        assert Cv % w["CC"] == 0 and 9 * Ov % w["BN"] == 0
        assert w["BN"] % kc.DW_TN == 0 and w["threads"] <= kc.DW_THREADS
        assert w["S"] * w["ips"] >= B > (w["S"] - 1) * w["ips"]


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """A ChebyKAN conv on CPU tensors runs the plain versions forward and
    backward: the C entries are never looked up and nothing is counted."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(kc, "_fn", refuse)
    kc.reset_launches()
    conv = KanConvND("cheby", 3, 4, 3, padding=1, dropout=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 5, 3, requires_grad=True)
    conv.train()(x, torch.Generator().manual_seed(1)).square().sum() \
        .backward()
    assert x.grad is not None and conv.poly_w.grad.abs().sum() > 0
    assert sum(kc.launches.values()) == 0
