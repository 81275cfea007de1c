"""The KAN-conv kernels' static-basis instantiations on the CPU: the
three-term recurrence (``Recur3<4, SiLU>`` for Bessel, Fibonacci,
Gegenbauer, Hermite, Laguerre and Lucas, ``Recur3<4, identity>`` for
Jacobi, ``Recur3<3, SiLU>`` for Taylor), ``Bernstein<3>`` and
``Fourier<5, SiLU>`` of ``csrc/kan_basis.cuh``, which KAN-VGG16_small runs.

* The policies compiled as host C++ (g++, no contraction, a stub
  ``cuda_runtime.h``) against the plain versions (``Basis.columns``):
  the recurrences' rows bit for bit on the same t (the C library's tanhf
  printed beside; torch's tanh within 2 ulp of it), Bernstein's rows
  exactly 1 and their derivative exactly 0 (dx is the base row's alone),
  Fourier's rows within 2 ulp of torch's cos and sin, the base row x bit
  for bit (SiLU within 2 ulp of torch's); each row's derivative against
  torch autograd of the plain version within 1e-5 of the largest.
  Non-default a, b, alpha and alpha_param (0.5) run too, and alpha_param
  0 gives Gegenbauer's exact zero rows.
* The plain versions against the TPU kernels in Pallas interpret mode (the
  wide op at k = 3, with the JAX module's own basis list and base
  activation): float32, forward within 2e-5, every gradient within 5e-5,
  for each of the ten families.
* ``launch_config``, ``dx_launch_config`` and ``dw_launch_config`` accept
  the 13 VGG16_small shapes at batch 1024 (and 64) for R = 5, 4 and 11.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import VGG16_SMALL_CONVS
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND

torch.set_num_threads(1)
CSRC = Path(kc.__file__).resolve().parents[1] / "csrc"
FWD_TOL, GRAD_TOL = 2e-5, 5e-5
# the ten families with VGG16_small's hyperparameters (base_activation
# "silu", degree 3, grid 5), as KanConvND builds them
FAMILIES = ("jacobi", "bernstein", "bessel", "fibonacci", "fourier",
            "gegenbauer", "hermite", "laguerre", "lucas", "taylor")


def _vgg_basis(family, **kw):
    return KanConvND(family, 4, 4, 3, base_activation="silu", device="cpu",
                     **kw).basis


_STUB = """#pragma once
#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline void sincosf(float x, float* s, float* c) {
  *s = sinf(x);
  *c = cosf(x);
}
"""

# argv: the policy's code, its parameters' count, the parameters, then the
# x values; per x one line: tanhf(x), the R rows, the R derivatives
_MAIN = r"""#include <cstdio>
#include <cstdlib>
#include "kan_basis.cuh"
int main(int argc, char** argv) {
  const int code = atoi(argv[1]), np = atoi(argv[2]);
  float p[32] = {};
  for (int i = 0; i < np; ++i) p[i] = strtof(argv[3 + i], nullptr);
  const int order = code == 11 ? 5 : 3;
  for (int a = 3 + np; a < argc; ++a) {
    const float x = strtof(argv[a], nullptr);
    kan::with_basis(code, np, order, [&](auto b) {
      using P = decltype(b);
      float e[P::R];
      P::expand(x, p, e, 1, 0);
      printf("%a", tanhf(x));
      for (int r = 0; r < P::R; ++r) printf(" %a", e[r]);
      for (int r = 0; r < P::R; ++r) {
        float acc[P::R] = {};
        acc[r] = 1.0f;
        printf(" %a", P::grad(x, p, acc));
      }
      printf("\n");
      return cudaSuccess;
    });
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def policy_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("policy")
    (tmp / "cuda_runtime.h").write_text(_STUB)
    (tmp / "main.cc").write_text(_MAIN)
    exe = tmp / "policy"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{tmp}", f"-I{CSRC}", str(tmp / "main.cc"), "-o",
                    str(exe)], check=True, capture_output=True)
    return exe


def _policy_rows(exe, basis, xs):
    """(tanhf(x), E, dE) of the compiled policy of ``basis``."""
    params = [repr(v) for v in basis.params]
    out = subprocess.run([str(exe), str(kc.COMPILED[basis.key]),
                          str(len(params)), *params,
                          *(repr(float(x)) for x in xs)],
                         check=True, capture_output=True, text=True).stdout
    rows = np.array([[float.fromhex(v) for v in line.split()]
                     for line in out.splitlines()], np.float32)
    R = basis.R
    return rows[:, 0], rows[:, 1:1 + R], rows[:, 1 + R:]


def _ulps(a, b):
    """|a - b| in units of the last place of max(|a|, |b|, tiny)."""
    scale = np.spacing(np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                  np.float32(1e-30)).astype(np.float32))
    return np.abs(a.astype(np.float64) - b) / scale


POLICY_CASES = [(f, {}) for f in FAMILIES] + [
    ("jacobi", dict(a=0.5, b=1.5)), ("gegenbauer", dict(alpha_param=0.5)),
    ("laguerre", dict(alpha=0.5))]


@pytest.mark.parametrize("family,kw", POLICY_CASES,
                         ids=[f + "".join(f"-{k}{v}" for k, v in kw.items())
                              for f, kw in POLICY_CASES])
def test_policies_as_host_cpp(policy_exe, family, kw):
    basis = _vgg_basis(family, **kw)
    rng = np.random.RandomState(len(family))
    xs = np.concatenate([[0.0, -0.5, 0.5, -3.0, 3.0, 12.0, -12.0],
                         rng.uniform(-4.0, 4.0, 300)]).astype(np.float32)
    tc, E, dE = _policy_rows(policy_exe, basis, xs)
    xt = torch.from_numpy(xs).requires_grad_(True)
    t = basis.squash(xt)
    if family in ("bernstein", "fourier"):
        rows = basis.columns(xt)
    else:
        # the C library's tanhf and torch's agree within 2 ulp; the rows
        # of the same t bit for bit
        assert _ulps(tc, t.detach().numpy()).max() <= 2
        rows = basis.expansion(torch.from_numpy(tc))
    plain = torch.stack(rows, -1).detach().numpy()
    if family == "fourier":
        assert _ulps(E[:, :-1], plain).max() <= 2
    else:
        assert np.array_equal(E[:, :-1], plain)
    # the base row: x bit for bit, or SiLU within 2 ulp of torch's
    base = xt if basis.act == "identity" else torch.nn.functional.silu(xt)
    assert _ulps(E[:, -1], base.detach().numpy()).max() <= \
        (0 if basis.act == "identity" else 2)
    # each row's derivative against autograd of the plain version
    auto = basis.columns(xt) + [base]
    for r, row in enumerate(auto):
        d = torch.autograd.grad(row.sum(), xt, retain_graph=True)[0] \
            .numpy() if row.requires_grad else np.zeros_like(xs)
        assert np.abs(dE[:, r] - d).max() <= 1e-5 * max(np.abs(d).max(), 1)
    if family == "bernstein":
        assert (E[:, :-1] == 1).all() and (dE[:, :-1] == 0).all()
        assert (dE[:, -1] == 1).all()
    if family == "fibonacci":
        assert (E[:, 0] == 0).all() and (dE[:, 0] == 0).all()


def test_gegenbauer_alpha0_rows_exactly_zero(policy_exe):
    """alpha_param = 0 (the factory's and VGG's default): rows 1-3 are
    exactly 0, and their derivatives too (never a NaN)."""
    basis = _vgg_basis("gegenbauer")
    xs = np.random.RandomState(3).uniform(-4, 4, 200).astype(np.float32)
    _, E, dE = _policy_rows(policy_exe, basis, xs)
    assert (E[:, 0] == 1).all() and (E[:, 1:4] == 0).all()
    assert (dE[:, :4] == 0).all() and np.isfinite(dE).all()


@pytest.mark.parametrize("family", FAMILIES)
def test_plain_versions_match_the_pallas_kernel_f32(family):
    """Forward and every gradient of ``kan_conv2d``'s plain version against
    the wide Pallas kernel in interpret mode, with the JAX module's own
    basis list and base activation (x for Jacobi and Bernstein)."""
    jm = JaxKanConvND(family=family, input_dim=5, output_dim=8,
                      kernel_size=3, padding=1, base_activation="silu",
                      grid_size=5)
    act = jm._act()
    spec = jm.spec
    basis = _vgg_basis(family)
    op = make_wide_kan_conv_op(
        basis_list_fn=jm._fused_basis_list_fn(act), num_basis=basis.K,
        base_act=act if spec.base_input == "act" else None, kernel_size=3,
        padding=1, degree_major=spec.layout == "degree_major",
        has_base=True, interpret=True)
    rng = np.random.RandomState(len(family) + 1)
    x = rng.uniform(-2.5, 2.5, (2, 6, 6, 5)).astype(np.float32)
    bw = rng.normal(0, 0.2, (3, 3, 5, 8)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, 5 * basis.K, 8)).astype(np.float32)
    g = rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)
    y, pull = jax.vjp(op, *(jnp.asarray(a) for a in (x, bw, pw)))
    want = (y, *pull(jnp.asarray(g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, bw, pw)]
    out = kc.kan_conv2d(*leaves, basis, 3, 1)
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(g)))
    for name, a, b in zip(("y", "dx", "dbase_w", "dpoly_w"), got, want):
        b = np.asarray(b)
        tol = FWD_TOL if name == "y" else GRAD_TOL
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=tol,
                                   atol=tol * max(np.abs(b).max(), 1),
                                   err_msg=name)


@pytest.mark.parametrize("B", [64, 1024])
@pytest.mark.parametrize("R", [5, 4, 11])
def test_launch_configs_accept_vgg16_small_shapes(B, R):
    """R = 5 (the recurrences of 4 rows, Bernstein), 4 (Taylor) and 11
    (Fourier of grid 5): every tile fits, the data gradient's weight entries
    stay within a thread each, the forward's row stride within the C
    entry's row tables (92 floats at R = 11)."""
    assert len(VGG16_SMALL_CONVS) == 13
    for H, C, O in VGG16_SMALL_CONVS:
        f = kc.launch_config(B, H, H, C, O, 3, 1, R)
        d = kc.dx_launch_config(B, H, H, C, O, 3, 1, R)
        w = kc.dw_launch_config(B, H, H, C, O, 3, 1, R)
        assert f["smem"] <= kc.SMEM_LIMIT and d["smem"] <= kc.SMEM_LIMIT
        assert w["smem"] <= kc.SMEM_LIMIT
        assert f["rs"] <= max(76, kc.row_stride(R, kc.MAX_CHUNK))
        assert R * d["CC"] * d["OC"] // 4 <= kc.THREADS
        assert w["S"] * R * C * 9 * O < 2 ** 31


def test_compiled_keys_of_the_vgg16_small_families():
    """Each family as VGG16_small builds it has a compiled basis: six
    share code 7 (their coefficients are parameters), and a basis the
    build does not carry (another degree, GELU) is not compiled."""
    codes = {f: kc.COMPILED[_vgg_basis(f).key] for f in FAMILIES}
    assert sorted(set(codes.values())) == [7, 8, 9, 10, 11]
    assert [f for f, c in codes.items() if c == 7] == [
        "bessel", "fibonacci", "gegenbauer", "hermite", "laguerre", "lucas"]
    assert _vgg_basis("jacobi").act == "identity"
    assert _vgg_basis("bernstein").act == "identity"
    assert _vgg_basis("fourier").R == 11 and _vgg_basis("taylor").R == 4
    assert len(_vgg_basis("hermite").params) == 12
    assert len(_vgg_basis("taylor").params) == 8
    for kw in (dict(degree=4), dict(base_activation="gelu")):
        b = KanConvND("hermite", 4, 4, 3, device="cpu",
                      **{"base_activation": "silu", **kw}).basis
        assert b.key not in kc.COMPILED


def test_modules_run_the_kernel_route_on_cpu():
    """Each family's conv of VGG16_small's kind passes the gate and on the
    CPU runs the plain version: no launch, no plain-route count; Legendre
    takes the plain route."""
    x = torch.randn(2, 6, 6, 4)
    for family in FAMILIES + ("legendre",):
        conv = KanConvND(family, 4, 6, 3, padding=1, base_activation="silu",
                         device="cpu", generator=torch.Generator())
        kc.reset_launches()
        conv(x)
        on_kernel = family != "legendre"
        assert conv.kernel_route(x) == on_kernel
        assert kc.plain_calls[kc.PLAIN] == (not on_kernel)
        assert sum(kc.launches.values()) == 0
