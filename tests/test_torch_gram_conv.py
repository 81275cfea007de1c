"""Port parity for the Gram KAN conv: the plain versions of the CUDA kernels
(kernels/kan_conv2d.py with ``gram_basis(3)`` and the operand beta) and the
GRAMKAN KanConvND, against the JAX package on the same numpy-seeded inputs
(6 -> 8 channels at 8x8, batch 2; beta drawn far larger than its init so
that its terms count).

  * against the TPU kernels in Pallas interpret mode, as
    tests/test_pallas_kernels.py runs them (the wide ``fwd_kernel`` /
    ``bwd_kernel``, whose ``dextras`` is beta's gradient, and the per-tap
    ``fused_kan_conv2d``), with the JAX module's own Gram basis list:
    float32, forward to 2e-5 and gradients to 5e-5, that file's
    tolerances (float32 sums in another order);
  * against the JAX XLA path (``use_pallas=False``): float64, to 1e-10 of
    the largest entry, each kernel's plain version (forward, data gradient,
    weight partials, beta's partials) and the module in eval and in train
    mode with JAX's dropout mask;
  * degree-major packing, the pad mask after the expansion, the data
    gradient's block layout behind beta's partials, the tile rules at R = 5
    rows per channel, and the rule that CPU tensors never reach a kernel.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.kernels.fused_kan_conv import make_fused_kan_conv_op
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.kernels.wide_kan_conv import pack_w_all as jax_pack_w_all
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.activations import ACTIVATIONS as JAX_ACTIVATIONS
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.ops import dropout as dlib

torch.set_num_threads(1)

GRAM = kc.gram_basis(3)
K = 4
C, O = 6, 8
FWD_TOL, GRAD_TOL, F64_TOL = 2e-5, 5e-5, 1e-10


def _inputs(dtype, seed=0, scale=2.0):
    """x U(-scale, scale), base_w and poly_w N(0, 0.2) (poly_w degree-major,
    rows n*C + c), beta N(0, 0.3), g N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (2, 8, 8, C))
    bw = rng.normal(0, 0.2, (3, 3, C, O))
    pw = rng.normal(0, 0.2, (3, 3, C * K, O))
    beta = rng.normal(0, 0.3, K)
    g = rng.normal(0, 1, (2, 8, 8, O))
    return tuple(a.astype(dtype) for a in (x, bw, pw, beta, g))


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _jax_module(**kw):
    return JaxKanConvND(family="gram", input_dim=C, output_dim=O,
                        kernel_size=3, padding=1, **kw)


def _unpack(dw_all):
    """dW_all rows (n*C + c, then C base rows) -> (d poly_w, d base_w)."""
    dpw = dw_all[:K * C].reshape(K * C, 3, 3, O).permute(1, 2, 0, 3)
    dbw = dw_all[K * C:].reshape(C, 3, 3, O).permute(1, 2, 0, 3)
    return dpw, dbw


@pytest.mark.parametrize("tpu_kernel", ["wide", "fused"])
def test_plain_versions_match_pallas_kernels_f32(tpu_kernel):
    """Forward, dx, d base_w, d poly_w and d beta of the plain version
    against the Pallas kernels (the wide op's custom_vjp runs
    ``bwd_kernel`` and returns beta's gradient as its ``dextras``; the
    per-tap op's, ``fused_kan_conv2d`` forward, recomputes through the
    reference path), the basis list the JAX module hands its kernels."""
    x, bw, pw, beta, g = _inputs(np.float32, seed=1)
    silu = JAX_ACTIVATIONS["silu"]
    basis_fn = _jax_module()._fused_basis_list_fn(silu)
    make = make_wide_kan_conv_op if tpu_kernel == "wide" else \
        lambda **kw: make_fused_kan_conv_op(**kw)[0]
    op = make(basis_list_fn=basis_fn, num_basis=K, base_act=silu,
              kernel_size=3, padding=1, degree_major=True, has_base=True,
              interpret=True)
    y, pull = jax.vjp(op, *(jnp.asarray(a) for a in (x, bw, pw, beta)))
    assert y.dtype == jnp.float32
    want = (y, *pull(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, bw, pw, beta)]
    out = kc.kan_conv2d(leaves[0], leaves[1], leaves[2], GRAM, 3, 1,
                        leaves[3])
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(g)))
    for name, a, b, tol in zip(("y", "dx", "dbase_w", "dpoly_w", "dbeta"),
                               got, want, (FWD_TOL,) + (GRAD_TOL,) * 4):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol, err_msg=name)
    assert got[-1][0] == 0 and got[-1][3] == 0       # beta[0], beta[3]
    assert np.abs(np.asarray(want[-1])[1:3]).min() > 1e-2


def test_kernel_wrappers_match_jax_xla_path_f64():
    """The plain versions of the three kernels (forward, input_grad, the
    reduced weight_partials, and beta's partials from the data gradient)
    against jax.vjp of the JAX XLA path in float64.  The JAX module (no
    norm) applies SiLU after the conv; the port's output gradient g is
    taken through that SiLU first."""
    x, bw, pw, beta, g = _inputs(np.float64, seed=2)
    jm = _jax_module(norm_layer=None, param_dtype=jnp.float64)
    params = {"base_w": jnp.asarray(bw), "poly_w": jnp.asarray(pw),
              "beta_weights": jnp.asarray(beta)}
    y, pull = jax.vjp(lambda xx, p: jm.apply({"params": p}, xx, train=False),
                      jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(g))
    xt, bwt, pwt, bt, gt = (torch.from_numpy(a) for a in (x, bw, pw, beta, g))
    with torch.enable_grad():
        yc = kc.kan_conv2d(xt, bwt, pwt, GRAM, 3, 1, bt).requires_grad_(True)
        out = torch.nn.functional.silu(yc)
        gc = torch.autograd.grad(out, yc, gt)[0]
    _close(out.detach(), y, F64_TOL, "y")
    w_all = kc.pack_w_all(bwt, pwt, C=C, K=K, k=3, O=O, degree_major=True)
    assert w_all.shape == (GRAM.R * C, 9 * O)
    _close(kc.input_grad(xt, w_all, gc, GRAM, 3, 1, bt), jdx, F64_TOL, "dx")
    dpw, dbw = _unpack(kc.reduce_partials(kc.weight_partials(
        xt, gc, GRAM, 3, 1, bt)))
    _close(dpw, jdp["poly_w"], F64_TOL, "dpoly_w")
    _close(dbw, jdp["base_w"], F64_TOL, "dbase_w")
    dx, part = kc.input_extra_grad(xt, w_all, gc, GRAM, 3, 1, bt)
    cfg = kc.dx_launch_config(2, 8, 8, C, O, 3, 1, GRAM.R)
    assert part.shape == (cfg["tiles"] * -(-C // cfg["CC"]), K)
    _close(dx, jdx, F64_TOL, "dx with the partials")
    for de in (kc.reduce_partials(part),
               kc.extra_grad_reference(xt, w_all, gc, GRAM, 3, 1, bt),
               kc.extra_terms_reference(xt, w_all, gc, GRAM, 3, 1, bt)
               .sum((0, 1, 2, 3))):
        _close(de, jdp["beta_weights"], F64_TOL, "dbeta")
        assert de[0] == 0 and de[3] == 0
    assert kc.input_extra_grad(xt, w_all, gc, GRAM, 3, 1, bt,
                               need_dx=False)[0] is None


def test_degree_major_packing_matches_jax():
    """pack_w_all with degree-major poly_w rows (Gram) and channel-major
    rows (B-spline, Chebyshev) equals the JAX wide kernel's packing."""
    _, bw, pw, _, _ = _inputs(np.float64, seed=3)
    for dm in (True, False):
        got = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=C,
                            K=K, k=3, O=O, degree_major=dm)
        want = jax_pack_w_all(jnp.asarray(bw), jnp.asarray(pw), C=C, K=K,
                              k=3, O=O, degree_major=dm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        nobase = kc.pack_w_all(None, torch.from_numpy(pw), C=C, K=K, k=3,
                               O=O, degree_major=dm)
        np.testing.assert_array_equal(nobase.numpy(), np.asarray(want)[:K * C])
    # degree-major row n*C + c of tap (di, dj) is poly_w[di, dj, n*C + c]
    w = kc.pack_w_all(None, torch.from_numpy(pw), C=C, K=K, k=3, O=O,
                      degree_major=True)
    assert torch.equal(w[2 * C + 5, (1 * 3 + 2) * O:(1 * 3 + 2) * O + O],
                       torch.from_numpy(pw[1, 2, 2 * C + 5]))


def test_pad_is_zero_after_expansion():
    """SiLU(p_0) = SiLU(1) at every x: padding x with zeros before the
    expansion would add the taps' sum of w_0 SiLU(1) (and of the other
    rows at x = 0) on the border.  The port's pad contributes nothing
    there."""
    x, bw, pw, beta, _ = _inputs(np.float64, seed=4)
    xt, bwt, pwt, bt = (torch.from_numpy(a) for a in (x, bw, pw, beta))
    y = kc.kan_conv2d_reference(xt, bwt, pwt, GRAM, 3, 1, bt).numpy()
    wrong = kc.kan_conv2d_reference(
        torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)), bwt, pwt, GRAM, 3,
        0, bt).numpy()
    assert np.abs(y - wrong)[:, 0].min() > 0         # every border pixel
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], wrong[:, 1:-1, 1:-1],
                               rtol=1e-12, atol=1e-12)


def _intercept_dropout_masks(masks):
    """A flax method interceptor that records the keep mask of every
    nn.Dropout the JAX module calls."""
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax_pallas_interpret_f32(train):
    """KanConvND("gram") (conv, InstanceNorm, SiLU) against the JAX module
    on the Pallas route in interpret mode, float32, forward and gradients
    (beta's included) to the Pallas tolerances.  Train mode with no
    dropout (the JAX module leaves its kernels for XLA when channel
    dropout before the basis is on); InstanceNorm has no running state,
    so train and eval run the same function."""
    x, bw, pw, beta, g = _inputs(np.float32, seed=5)
    jm = _jax_module(use_pallas=True, pallas_interpret=True)
    params = {"base_w": jnp.asarray(bw), "poly_w": jnp.asarray(pw),
              "beta_weights": jnp.asarray(beta)}
    y, pull = jax.vjp(lambda xx, p: jm.apply({"params": p}, xx, train=train),
                      jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(g))
    tm = KanConvND("gram", C, O, 3, padding=1, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.train(train)(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=FWD_TOL, atol=FWD_TOL, err_msg="y")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx),
                               rtol=GRAD_TOL, atol=GRAD_TOL, err_msg="dx")
    for name in params:
        np.testing.assert_allclose(
            getattr(tm, name).grad.numpy(), np.asarray(jdp[name]),
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax_xla_path_f64(train, monkeypatch):
    """The same module against the JAX XLA path in float64 with channel
    dropout 0.25: output, dx, d base_w, d poly_w and d beta to 1e-10 of
    the largest entry.  In train mode the dropout acts on tanh x before
    the basis (the JAX "basis_input" site; the base path keeps x), with
    JAX's own keep mask (recorded by a method interceptor) given to the
    port."""
    x, bw, pw, beta, g = _inputs(np.float64, seed=6)
    jm = _jax_module(dropout=0.25, param_dtype=jnp.float64)
    params = {"base_w": jnp.asarray(bw), "poly_w": jnp.asarray(pw),
              "beta_weights": jnp.asarray(beta)}
    masks = []

    def jf(xx, p):
        return jm.apply({"params": p}, xx, train=train,
                        rngs={"dropout": jax.random.PRNGKey(7)})

    with fnn.intercept_methods(_intercept_dropout_masks(masks)):
        y, pull = jax.vjp(jf, jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(g))
    tm = KanConvND("gram", C, O, 3, padding=1, dropout=0.25, device="cpu",
                   dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()}, strict=True)
    if train:
        assert len(masks) == 1 and masks[0].shape == x.shape
        keep = masks[0][:, :1, :1, :]     # one mask per (image, channel)
        assert (masks[0] == keep).all() and 0 < keep.sum() < keep.size
        monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None: (
            torch.from_numpy(np.where(keep, 0.0, 0.99))))
    else:
        assert not masks
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.train(train)(xt)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), y, F64_TOL, "y")
    _close(xt.grad, jdx, F64_TOL, "dx")
    for name in params:
        _close(getattr(tm, name).grad, jdp[name], F64_TOL, name)


def _kernel_blocks(B, H, W, Cv, cfg):
    """(B, H, W, Cv) block index of each (pixel, channel) as the data-
    gradient kernel's epilogue reaches it: every block (blockIdx.x,
    blockIdx.y) and thread (pixel slot pm, channel lane tn, pixel q)
    decoded as ``dx_pixel`` and the C entry's layout do (-1: reached by
    none)."""
    out = np.full((B, H, W, Cv), -1)
    k = 3
    CC, tiles = cfg["CC"], cfg["tiles"]
    Wv = 1 << (W - 1).bit_length()
    lw = Wv.bit_length() - 1
    for by in range(-(-Cv // CC)):
        for bx in range(tiles):
            for tid in range(kc.THREADS):
                pm, tn = tid >> 3, tid & 7
                c = by * CC + tn
                if tn >= CC or c >= Cv:
                    continue
                for q in range(kc.DX_TM):
                    if cfg["skip"]:
                        w = tid >> 5
                        slot = bx * kc.WARPS + (w ^ (w >> 2))
                        ig, pos = divmod(slot, H * W)
                        if slot >= -(-B // kc.DX_GROUP) * H * W:
                            continue
                        i, j = divmod(pos, W)
                        b = ig * kc.DX_GROUP + (pm & 3) + 4 * q
                    else:
                        TH, NB = cfg["TH"], cfg["NB"]
                        lth = TH.bit_length() - 1
                        lp = lw + lth
                        rows = cfg["tileR"] - (k - 1)
                        bg, rc = divmod(bx, -(-H // TH))
                        b0, i0 = bg * NB, rc * TH
                        m = pm + kc.DX_SLOTS * q
                        b = b0 + (m >> lp)
                        i = i0 + ((m >> lw) & (TH - 1))
                        j = m & (Wv - 1)
                        if (m >> lp) >= cfg["planes"] or i - i0 >= rows:
                            continue
                    if b >= B or i >= H or j >= W:
                        continue
                    assert out[b, i, j, c] == -1, "reached twice"
                    out[b, i, j, c] = by * tiles + bx
    return out


@pytest.mark.parametrize("B,H,Cv,O_", [(2, 8, 6, 8), (37, 4, 16, 32),
                                       (3, 2, 12, 16), (5, 16, 3, 16),
                                       (2, 32, 3, 16)])
def test_extra_blocks_follow_the_kernel_layout(B, H, Cv, O_):
    """``extra_blocks`` (the plain partials' grouping) assigns each (pixel,
    channel) the data-gradient block whose epilogue the kernel's layout
    sends it to, on dense tiles (image slots, row tiles) and skip tiles
    (a warp per position of 32 images), every pair exactly once."""
    cfg = kc.dx_launch_config(B, H, H, Cv, O_, 3, 1, GRAM.R)
    want = _kernel_blocks(B, H, H, Cv, cfg)
    assert (want >= 0).all()
    np.testing.assert_array_equal(kc.extra_blocks(B, H, H, Cv, cfg).numpy(),
                                  want)
    assert cfg["skip"] == (H * H <= kc.SKIP_POSITIONS)


def test_extra_partials_sum_to_the_gradient():
    """The plain partials, one row per block of the tile, sum to beta's
    gradient (float64), and ``input_grad`` of the Gram basis is the dx of
    the same launch."""
    x, bw, pw, beta, g = _inputs(np.float64, seed=8)
    xt, bwt, pwt, bt, gt = (torch.from_numpy(a) for a in (x, bw, pw, beta, g))
    w_all = kc.pack_w_all(bwt, pwt, C=C, K=K, k=3, O=O, degree_major=True)
    part = kc.extra_partials_reference(xt, w_all, gt, GRAM, 3, 1, bt)
    torch.testing.assert_close(part.sum(0), kc.extra_grad_reference(
        xt, w_all, gt, GRAM, 3, 1, bt), rtol=1e-12, atol=1e-12)
    assert (part[:, 0] == 0).all() and (part[:, 3] == 0).all()
    assert (part[:, 1:3].abs().sum(1) > 0).all()


# (H, C, O) of the VGG16_small convs (9 distinct shapes)
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


@pytest.mark.parametrize("B", [1, 64, 1024])
def test_launch_configs_at_five_rows(B):
    """At R = 5 every VGG16_small shape gets a forward, data-gradient and
    weight-gradient tile within two blocks' share of shared memory, with
    the tile rules' own invariants: the forward's row stride and block
    count, the data gradient's thread per weight entry (5 * CC * OC / 4 <=
    256), the weight gradient's rows of whole channels and columns
    dividing 9*O."""
    R = GRAM.R
    for H, Cv, Ov in VGG16_SMALL:
        f = kc.launch_config(B, H, H, Cv, Ov, 3, 1, R)
        assert f["smem"] <= kc.SMEM_TWO_BLOCKS and f["BN"] == Ov
        assert f["rs"] == kc.row_stride(R, f["CC"]) and f["rs"] % 8 == 4
        assert f["blocks"] == f["tiles"] * f["S"]
        d = kc.dx_launch_config(B, H, H, Cv, Ov, 3, 1, R)
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


def test_operand_is_checked():
    """A Gram conv needs its (4,) operand; a basis without one takes none."""
    x, bw, pw, beta, _ = _inputs(np.float64, seed=9)
    xt, bwt, pwt, bt = (torch.from_numpy(a) for a in (x, bw, pw, beta))
    for bad in (None, bt[:3], bt.float()):
        with pytest.raises((ValueError, TypeError)):
            kc.kan_conv2d(xt, bwt, pwt, GRAM, 3, 1, bad)
    cheby = kc.cheby_basis(3)
    with pytest.raises(ValueError):
        kc.kan_conv2d(xt, None, torch.zeros(3, 3, C * 4, O,
                                            dtype=torch.float64),
                      cheby, 3, 1, bt)


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """A GRAMKAN conv on CPU tensors runs the plain versions forward and
    backward (beta's gradient included): the C entries are never looked
    up and nothing is counted."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(kc, "_fn", refuse)
    kc.reset_launches()
    conv = KanConvND("gram", 3, 4, 3, padding=1, dropout=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 5, 3, requires_grad=True)
    for train in (False, True):
        conv.train(train)(x, torch.Generator().manual_seed(1)).square() \
            .sum().backward()
    assert x.grad is not None and conv.poly_w.grad.abs().sum() > 0
    assert conv.beta_weights.grad[1:3].abs().min() > 0
    assert sum(kc.launches.values()) == 0
