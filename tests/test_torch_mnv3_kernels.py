"""The KAN-conv kernels at MobileNetV3's shapes, on the CPU: the B-spline
with a hardswish base path (``BSpline<12, 3, HardSwish>``) and the 1x1
convs (k = 1, pad 0) of MobileNetV3-small at 224 x 224.

* The hardswish policy of ``csrc/kan_basis.cuh`` compiled as host C++ (g++,
  no contraction): hardswish and its derivative bit for bit against
  torch's (F.hardswish and its autograd, float32: 0 at x <= -3, x/3 + 1/2
  on (-3, 3), 1 at x >= 3, x exactly at -3 and 3 included), the policy's
  expanded rows bit for bit against the plain version's, and its
  derivative (``grad``) against torch autograd of the plain version within
  1e-5 of each row's largest derivative.
* The plain version of the hardswish basis at k = 1 against the JAX
  module on its Pallas route (``wide_kan_conv`` in interpret mode),
  float32: the forward within 1e-5, the gradients within 5e-5 of the
  largest entry (the Pallas tolerances of tests/test_torch_kan_conv_grad).
* ``launch_config``, ``dx_launch_config`` and ``dw_launch_config`` accept
  each of the 17 distinct 1x1 shapes at batch 64 and 512 for R = 9
  (B-spline) and R = 4 (Chebyshev), and the forward's, the data
  gradient's and the weight gradient's index mappings, replayed in
  float64 by the emulations of tests/test_torch_kan_conv2d.py and
  tests/test_torch_kan_conv_grad.py, write every output once and agree
  with the plain versions to 1e-12 at k = 1.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.basis.bspline import (bspline_basis_unrolled_list,
                                             make_bspline_grid)
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND

torch.set_num_threads(1)
CSRC = Path(kc.__file__).resolve().parents[1] / "csrc"
KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
HS = kc.bspline_basis(KNOTS, 3, "hardswish")
# the 17 distinct (H, C, O) of MobileNetV3-small's 1x1 KAN convs at 224^2
MNV3_1X1 = [(56, 16, 16), (56, 16, 72), (28, 72, 24), (28, 24, 88),
            (28, 88, 24), (28, 24, 96), (14, 96, 40), (14, 40, 240),
            (14, 240, 40), (14, 40, 120), (14, 120, 48), (14, 48, 144),
            (14, 144, 48), (14, 48, 288), (7, 288, 96), (7, 96, 576),
            (7, 576, 96)]

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

_MAIN = r"""#include <cstdio>
#include <cstdlib>
#include "kan_basis.cuh"
using P = kan::BSpline<12, 3, 2>;
int main(int argc, char** argv) {
  float kn[12];
  for (int i = 0; i < 12; ++i) kn[i] = strtof(argv[1 + i], nullptr);
  for (int a = 13; a < argc; ++a) {
    const float x = strtof(argv[a], nullptr);
    float e[P::R];
    P::expand(x, kn, e, 1, 0);
    printf("%a %a", kan::hardswish(x), kan::hardswish_grad(x));
    for (int r = 0; r < P::R; ++r) printf(" %a", e[r]);
    for (int r = 0; r < P::R; ++r) {
      float acc[P::R] = {};
      acc[r] = 1.0f;
      printf(" %a", P::grad(x, kn, acc));
    }
    printf("\n");
  }
  return 0;
}
"""


def _policy_rows(xs, tmp_path):
    """(hardswish, hardswish', E rows, dE rows) of the compiled policy."""
    (tmp_path / "cuda_runtime.h").write_text(_STUB)
    (tmp_path / "main.cc").write_text(_MAIN)
    exe = tmp_path / "policy"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{tmp_path}", f"-I{CSRC}", str(tmp_path / "main.cc"),
                    "-o", str(exe)], check=True, capture_output=True)
    out = subprocess.run([str(exe), *(repr(k) for k in KNOTS),
                          *(repr(float(x)) for x in xs)],
                         check=True, capture_output=True, text=True).stdout
    rows = np.array([[float.fromhex(v) for v in line.split()]
                     for line in out.splitlines()], np.float32)
    R = HS.R
    return rows[:, 0], rows[:, 1], rows[:, 2:2 + R], rows[:, 2 + R:]


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_hardswish_policy_as_host_cpp(tmp_path):
    rng = np.random.RandomState(0)
    xs = np.concatenate([
        [-3.0, 3.0, 0.0, -2.2, 2.2, -1.0, 1.0],
        [np.nextafter(np.float32(v), np.float32(d))
         for v in (-3.0, 3.0) for d in (-10.0, 10.0)],
        rng.uniform(-4.0, 4.0, 200)]).astype(np.float32)
    hs, dhs, E, dE = _policy_rows(xs, tmp_path)
    xt = torch.from_numpy(xs).requires_grad_(True)
    want = F.hardswish(xt)
    (dwant,) = torch.autograd.grad(want.sum(), xt)
    assert np.array_equal(hs, want.detach().numpy())
    assert np.array_equal(dhs, dwant.numpy())
    assert dhs[0] == 0.0 and dhs[1] == 1.0          # the kinks as torch
    rows = bspline_basis_unrolled_list(xt, KNOTS, 3) + [F.hardswish(xt)]
    assert np.array_equal(E, torch.stack(rows, -1).detach().numpy())
    for r, row in enumerate(rows):
        (d,) = torch.autograd.grad(row.sum(), xt, retain_graph=True)
        d = d.numpy()
        assert np.abs(dE[:, r] - d).max() <= 1e-5 * max(np.abs(d).max(), 1)


@pytest.mark.parametrize("C,O", [(16, 24), (24, 8)])
def test_plain_hardswish_basis_matches_the_pallas_kernel_at_k1(C, O):
    rng = np.random.RandomState(C)
    x = rng.uniform(-3.5, 3.5, (2, 7, 7, C)).astype(np.float32)
    x.reshape(-1)[:4] = (-3.0, 3.0, KNOTS[4], KNOTS[7])
    g = rng.normal(0.0, 1.0, (2, 7, 7, O)).astype(np.float32)
    jm = JaxKanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=1,
                      padding=0, base_activation="hardswish",
                      norm_layer=None, use_pallas=True, pallas_interpret=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, a.shape).astype(np.float32), params)
    params["prelu"] = np.full((1,), 1.0, np.float32)   # identity PReLU
    y, pull = jax.vjp(lambda xx, p: jm.apply({"params": p}, xx, train=False),
                      jnp.asarray(x), params)
    jdx, jdp = pull(jnp.asarray(g))
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_(True)
              for a in (x, params["base_w"], params["poly_w"])]
    got = kc.kan_conv2d(*leaves, HS, 1, 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for a, b in zip(grads, (jdx, jdp["base_w"], jdp["poly_w"])):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 5e-5 * np.abs(b).max()


@pytest.mark.parametrize("B", [64, 512])
@pytest.mark.parametrize("R", [9, 4])
def test_launch_configs_accept_mobilenetv3_shapes(B, R):
    for H, C, O in MNV3_1X1:
        f = kc.launch_config(B, H, H, C, O, 1, 0, R)
        d = kc.dx_launch_config(B, H, H, C, O, 1, 0, R)
        w = kc.dw_launch_config(B, H, H, C, O, 1, 0, R)
        assert f["smem"] <= kc.SMEM_LIMIT and d["smem"] <= kc.SMEM_LIMIT
        assert w["smem"] <= kc.SMEM_LIMIT
        assert R * d["CC"] * d["OC"] // 4 <= kc.THREADS
        assert w["S"] * R * C * O < 2 ** 31 and B * H * H * max(C, O) < 2 ** 31


def _emulators():
    import test_torch_kan_conv2d as fwd
    import test_torch_kan_conv_grad as bwd
    return fwd, bwd


@pytest.mark.parametrize("B,H,C,O", [(2, 14, 24, 40), (1, 7, 96, 36),
                                     (3, 8, 16, 24)])
def test_index_mappings_at_k1(B, H, C, O):
    fwd, bwd = _emulators()
    rng = np.random.RandomState(B * 100 + H)
    x = rng.uniform(-2.5, 2.5, (B, H, H, C))
    bw = rng.normal(0, 0.2, (1, 1, C, O))
    pw = rng.normal(0, 0.2, (1, 1, C * 8, O))
    g = rng.normal(0, 1, (B, H, H, O))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    cfg = kc.launch_config(B, H, H, C, O, 1, 0, 9)
    w_all = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=C,
                          K=8, k=1, O=O).numpy()
    got, written = fwd._emulate(x, w_all, KNOTS, 1, 0, cfg)
    want = kc.kan_conv2d_reference(xt, torch.from_numpy(bw),
                                   torch.from_numpy(pw), fwd.BASIS, 1, 0)
    assert (written == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
    cfg = kc.dw_launch_config(B, H, H, C, O, 1, 0, 9)
    got, written = bwd._emulate_dw(x, g, 1, 0, cfg)
    want = kc.weight_partials_reference(xt, gt, bwd.BASIS, 1, 0, cfg["S"],
                                        cfg["ips"])
    assert (written == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
    cfg = kc.dx_launch_config(B, H, H, C, O, 1, 0, 9)
    dE, written = bwd._emulate_dx(x, w_all, g, 1, 0, cfg)
    assert (written == 1).all() and not np.isnan(dE).any()
    xr = xt.clone().requires_grad_(True)
    got = torch.autograd.grad(kc.expand(xr, bwd.BASIS), xr,
                              torch.from_numpy(dE))[0]
    want = kc.input_grad_reference(xt, torch.from_numpy(w_all), gt,
                                   bwd.BASIS, 1, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_module_with_hardswish_runs_the_kernel_route_on_cpu():
    conv = KanConvND("kan", 16, 24, 1, base_activation="hardswish",
                     device="cpu", generator=torch.Generator())
    assert conv.basis == HS and HS.key in kc.COMPILED
    x = torch.randn(2, 7, 7, 16)
    assert conv.kernel_route(x)
    kc.reset_launches()
    conv(x)
    assert kc.plain_calls[kc.PLAIN] == 0 and sum(kc.launches.values()) == 0
