"""The KAN-conv kernels' identity-base instantiations and EfficientNetV2-s's
kernel shapes, on the CPU: the B-spline with an identity base path
(``BSpline<12, 3, identity>``) and the Gram basis with the identity on
every row (``Gram<3, identity>``), which EfficientNetV2's projections take
(built with ``base_activation=None``).

* The two identity policies of ``csrc/kan_basis.cuh`` compiled as host C++
  (g++, no contraction) against the plain versions: the base row is x and
  its derivative 1, bit for bit; the B-spline rows bit for bit; the Gram
  rows (the bare polynomials of tanh x: no activation) within 1e-6 of the
  largest (the C library's tanhf against torch's); each row's derivative
  against torch autograd of the plain version within 1e-5 of the largest.
* The plain versions of both identity bases against the TPU kernels in
  Pallas interpret mode (the wide op at k = 1 and 3, the per-tap op at
  k = 3), with the JAX module's own basis list and identity: float32,
  forward within 2e-5, every gradient (beta's included) within 5e-5, the
  tolerances of tests/test_torch_gram_conv.py.
* ``launch_config``, ``dx_launch_config`` and ``dw_launch_config`` accept
  every kernel shape of EfficientNetV2-s at 224 x 224 (three 3 x 3 shapes,
  one of them at 112 x 112, and 1x1 shapes up to C = O = 1536) at batches
  8 and 128 for R = 9 (B-spline) and R = 5 (Gram); the shape list is the
  one walked out of the port's arch ``s``, whose KAN convs split 77 / 3
  between the kernels and the plain route (FastKAN 0 / 80).
* The launch counters also count by basis (``launches_by_basis``), which
  tells a model's instantiations of one kernel apart.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EFFV2_CONVS
from convkan_tpu.kernels.fused_kan_conv import make_fused_kan_conv_op
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.basis.bspline import (bspline_basis_unrolled_list,
                                             make_bspline_grid)
from convkan_tpu_torch.basis.poly import gram_basis_cols
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.models.efficientnetv2 import _EffBlock, \
    efficientnetv2_kan
from convkan_tpu_torch.nn.kan_conv import KanConvND, kernel_eligible

torch.set_num_threads(1)
CSRC = Path(kc.__file__).resolve().parents[1] / "csrc"
KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
BASES = {"bspline": kc.bspline_basis(KNOTS, 3, "identity"),
         "gram": kc.gram_basis(3, "identity")}
FWD_TOL, GRAD_TOL = 2e-5, 5e-5
_STUB = """#pragma once
#define __host__
#define __device__
#define __forceinline__ inline
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""

# argv: the 12 knots, the 4 beta values, then the x values; per x one line
# of the B-spline's R rows and R derivatives, then the Gram's
_MAIN = r"""#include <cstdio>
#include <cstdlib>
#include "kan_basis.cuh"
using B = kan::BSpline<12, 3, 3>;
using G = kan::Gram<3, 3>;
template <class P>
void rows(float x, const float* p) {
  float e[P::R];
  P::expand(x, p, e, 1, 0);
  for (int r = 0; r < P::R; ++r) printf(" %a", e[r]);
  for (int r = 0; r < P::R; ++r) {
    float acc[P::R] = {};
    acc[r] = 1.0f;
    printf(" %a", P::grad(x, p, acc));
  }
}
int main(int argc, char** argv) {
  float kn[12], beta[4];
  for (int i = 0; i < 12; ++i) kn[i] = strtof(argv[1 + i], nullptr);
  for (int i = 0; i < 4; ++i) beta[i] = strtof(argv[13 + i], nullptr);
  for (int a = 17; a < argc; ++a) {
    const float x = strtof(argv[a], nullptr);
    rows<B>(x, kn);
    rows<G>(x, beta);
    printf("\n");
  }
  return 0;
}
"""


def _policy_rows(xs, beta, tmp_path):
    """(B-spline E, dE, Gram E, dE) of the compiled identity policies."""
    (tmp_path / "cuda_runtime.h").write_text(_STUB)
    (tmp_path / "main.cc").write_text(_MAIN)
    exe = tmp_path / "policy"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{tmp_path}", f"-I{CSRC}", str(tmp_path / "main.cc"),
                    "-o", str(exe)], check=True, capture_output=True)
    out = subprocess.run([str(exe), *(repr(k) for k in KNOTS),
                          *(repr(float(b)) for b in beta),
                          *(repr(float(x)) for x in xs)],
                         check=True, capture_output=True, text=True).stdout
    rows = np.array([[float.fromhex(v) for v in line.split()]
                     for line in out.splitlines()], np.float32)
    rb, rg = BASES["bspline"].R, BASES["gram"].R
    return (rows[:, :rb], rows[:, rb:2 * rb], rows[:, 2 * rb:2 * rb + rg],
            rows[:, 2 * rb + rg:])


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_identity_policies_as_host_cpp(tmp_path):
    rng = np.random.RandomState(0)
    xs = np.concatenate([KNOTS, [0.0, -0.5, 0.5, -3.0, 3.0],
                         rng.uniform(-3.0, 3.0, 200)]).astype(np.float32)
    beta = rng.normal(0.0, 0.3, 4).astype(np.float32)
    bE, bdE, gE, gdE = _policy_rows(xs, beta, tmp_path)
    xt = torch.from_numpy(xs).requires_grad_(True)
    bt = torch.from_numpy(beta)
    # the base row: x itself, derivative exactly 1
    for E, dE in ((bE, bdE), (gE, gdE)):
        assert np.array_equal(E[:, -1], xs)
        assert (dE[:, -1] == 1.0).all()
    b_rows = bspline_basis_unrolled_list(xt, KNOTS, 3) + [xt]
    assert np.array_equal(bE, torch.stack(b_rows, -1).detach().numpy())
    # the Gram rows take no activation: the bare polynomials
    g_rows = gram_basis_cols(torch.tanh(xt), 3, bt) + [xt]
    want = torch.stack(g_rows, -1).detach().numpy()
    assert np.abs(gE - want).max() <= 1e-6 * np.abs(want).max()
    for rows_, dE in ((b_rows, bdE), (g_rows, gdE)):
        for r, row in enumerate(rows_):
            d = torch.autograd.grad(row.sum(), xt, retain_graph=True)[0] \
                .numpy() if row.requires_grad else np.zeros_like(xs)  # p_0
            assert np.abs(dE[:, r] - d).max() <= 1e-5 * max(np.abs(d).max(),
                                                            1)


def _pallas_op(kind, k, tpu_kernel):
    """The JAX op (wide or per-tap) with the JAX module's basis list and
    base activation for ``base_activation=None`` (its identity)."""
    jm = JaxKanConvND(family="kan" if kind == "bspline" else "gram",
                      input_dim=6, output_dim=8, kernel_size=k,
                      padding=k // 2, base_activation=None)
    act = jm._act()
    make = make_wide_kan_conv_op if tpu_kernel == "wide" else \
        lambda **kw: make_fused_kan_conv_op(**kw)[0]
    return make(basis_list_fn=jm._fused_basis_list_fn(act),
                num_basis=BASES[kind].K, base_act=act, kernel_size=k,
                padding=k // 2, degree_major=kind == "gram", has_base=True,
                interpret=True)


@pytest.mark.parametrize("kind,k,tpu_kernel", [
    ("bspline", 1, "wide"), ("bspline", 3, "wide"), ("bspline", 3, "fused"),
    ("gram", 1, "wide"), ("gram", 3, "wide"), ("gram", 3, "fused")])
def test_identity_bases_match_pallas_kernels_f32(kind, k, tpu_kernel):
    """Forward and every gradient of the plain version of the identity
    basis against the Pallas kernels in interpret mode."""
    basis = BASES[kind]
    rng = np.random.RandomState(k * 10 + len(kind))
    x = rng.uniform(-2.5, 2.5, (2, 7, 7, 6)).astype(np.float32)
    x.reshape(-1)[:3] = (KNOTS[4], KNOTS[6], 0.0)
    bw = rng.normal(0, 0.2, (k, k, 6, 8)).astype(np.float32)
    pw = rng.normal(0, 0.2, (k, k, 6 * basis.K, 8)).astype(np.float32)
    g = rng.normal(0, 1, (2, 7, 7, 8)).astype(np.float32)
    args = [x, bw, pw]
    if kind == "gram":
        args.append(rng.normal(0, 0.3, 4).astype(np.float32))
    op = _pallas_op(kind, k, tpu_kernel)
    y, pull = jax.vjp(op, *(jnp.asarray(a) for a in args))
    want = (y, *pull(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = kc.kan_conv2d(leaves[0], leaves[1], leaves[2], basis, k, k // 2,
                        *leaves[3:])
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(g)))
    for name, a, b in zip(("y", "dx", "dbase_w", "dpoly_w", "dbeta"), got,
                          want):
        b = np.asarray(b)
        tol = FWD_TOL if name == "y" else GRAD_TOL
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=tol, atol=tol,
                                   err_msg=name)


def _walk_kan_convs(model, H=224):
    """(KanConvND, input H) of the model's KAN convs in forward order: each
    conv's output side is ceil(H / stride) ('same' padding)."""
    out = []

    def walk(mod, H):
        for name in mod._plan:
            m = getattr(mod, name)
            if isinstance(m, _EffBlock):
                H = walk(m, H)
                continue
            s = m.stride if isinstance(m, KanConvND) else \
                getattr(getattr(m, "Conv_0", None), "stride", 1)
            if isinstance(m, KanConvND):
                out.append((m, H))
            H = -(-H // s)
        return H

    walk(model, H)
    return out


@pytest.mark.parametrize("kan_conv,n_kernel", [("KAN", 77), ("GRAMKAN", 77),
                                               ("FastKAN", 0)])
def test_effv2_s_kernel_shapes_and_routes(kan_conv, n_kernel):
    """The port's arch ``s`` (built without weights, never run): 80 KAN
    convs, of which ``n_kernel`` pass ``kernel_eligible`` at their input
    size (the strided ones and every FastKAN conv take the plain route),
    at the shapes of chip_smoke.py's path D (EFFV2_CONVS); the projections
    carry the
    identity base path and a compiled basis."""
    model = efficientnetv2_kan(arch="s", num_classes=10, kan_conv=kan_conv,
                               device="cpu")
    convs = _walk_kan_convs(model)
    assert len(convs) == 80
    on_kernel = [(H, m.input_dim, m.output_dim, m.kernel_size)
                 for m, H in convs if kernel_eligible(
                     m.family, m.stride, m.dilation, m.groups, m.kernel_size,
                     m.padding, H, H)]
    assert len(on_kernel) == n_kernel
    if n_kernel:
        assert on_kernel == EFFV2_CONVS
        acts = [m.act for m, _ in convs]
        assert acts.count("identity") == 38 and acts.count("silu") == 42
        for m, _ in convs:
            assert m.basis.key in kc.COMPILED


@pytest.mark.parametrize("B", [8, 128])
@pytest.mark.parametrize("R", [9, 5])
def test_launch_configs_accept_effv2_s_shapes(B, R):
    for H, C, O, k in dict.fromkeys(EFFV2_CONVS):
        pad = k // 2
        f = kc.launch_config(B, H, H, C, O, k, pad, R)
        d = kc.dx_launch_config(B, H, H, C, O, k, pad, R)
        w = kc.dw_launch_config(B, H, H, C, O, k, pad, R)
        assert f["smem"] <= kc.SMEM_LIMIT and d["smem"] <= kc.SMEM_LIMIT
        assert w["smem"] <= kc.SMEM_LIMIT
        assert R * d["CC"] * d["OC"] // 4 <= kc.THREADS
        assert w["S"] * R * C * k * k * O < 2 ** 31
        assert B * H * H * max(C, O) * R < 2 ** 31


def test_identity_module_runs_the_kernel_route_on_cpu():
    """A projection (base_activation=None) takes the kernel route, whose
    CPU tensors run the plain version: no launch, no plain-route count."""
    for family in ("kan", "gram"):
        conv = KanConvND(family, 16, 24, 1, base_activation=None,
                         device="cpu", generator=torch.Generator())
        assert conv.basis.key in kc.COMPILED and conv.basis.act == "identity"
        x = torch.randn(2, 7, 7, 16)
        assert conv.kernel_route(x)
        kc.reset_launches()
        conv(x)
        assert kc.plain_calls[kc.PLAIN] == 0 and sum(kc.launches.values()) \
            == 0


def test_launch_counts_by_basis():
    """Each counted launch also counts under its basis's key, and
    ``reset_launches`` zeroes both counts (the launch sites call the
    counter only on a CUDA launch)."""
    ident, silu = BASES["bspline"], kc.bspline_basis(KNOTS, 3, "silu")
    kc.reset_launches()
    try:
        for name, key in (("kan_conv2d_fwd", ident.key),
                          ("kan_conv2d_fwd", silu.key),
                          ("kan_conv2d_fwd", ident.key),
                          ("kan_conv2d_bwd_dw_reduce", BASES["gram"].key)):
            kc._count_launch(name, key)
        assert kc.launches["kan_conv2d_fwd"] == 3
        assert kc.launches_by_basis == {
            ("kan_conv2d_fwd", ident.key): 2,
            ("kan_conv2d_fwd", silu.key): 1,
            ("kan_conv2d_bwd_dw_reduce", BASES["gram"].key): 1}
    finally:
        kc.reset_launches()
    assert kc.launches_by_basis == {} and sum(kc.launches.values()) == 0
