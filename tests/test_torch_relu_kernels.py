"""The KAN-conv kernels at the shapes of train.py's model zoo, on the CPU:
the B-spline with a ReLU base path (``BSpline<12, 3, ReLU>``,
MobileNetV1's KAN convs), AlexNet's 5x5 convs and the MobileNets' 1x1
convs.

* The ReLU policy of ``csrc/kan_basis.cuh`` compiled as host C++ (g++,
  no contraction, a stub ``cuda_runtime.h``): ReLU and its derivative bit
  for bit against torch's (F.relu and its autograd, float32: the
  derivative 0 at x = 0 and below, 1 above, -0 passed through), the
  policy's expanded rows bit for bit against the plain version's, and its
  derivative (``grad``) against autograd of the plain version within 1e-5
  of each row's largest derivative.
* The plain version of the ReLU basis against the JAX module on its
  Pallas route (``wide_kan_conv`` in interpret mode), float32, at k = 1
  (MobileNetV1's pointwise convs) and k = 5 (AlexNet's): the forward
  within 1e-5, the gradients within 5e-5 of the largest entry (the Pallas
  tolerances of tests/test_torch_kan_conv_grad.py).
* ``launch_config``, ``dx_launch_config`` and ``dw_launch_config`` accept
  every kernel shape of AlexNet (small at 32 x 32, default at 224 x 224:
  k = 5 and 3) and of MobileNetV1/V2 (``chip_smoke.ZOO_CONVS``) at batch 64
  and 1024 for R = 9, within shared memory, the data gradient's staged
  weight entries and 32-bit indices.
* The port's models walked on the meta device (never run): their KAN
  convs on the kernel route are ``chip_smoke.ZOO_CONVS`` in order, with
  ZOO_PLAIN on the plain route (the strided stems), every basis compiled,
  MobileNetV1's ReLU.
* The forward's and the weight gradient's index mappings at k = 5,
  replayed in float64 by the emulations of tests/test_torch_kan_conv2d.py
  and tests/test_torch_kan_conv_grad.py on AlexNet-like tiles.
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

from chip_smoke import ZOO_ACT, ZOO_ARGV, ZOO_CONVS, ZOO_PLAIN, zoo_size
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.basis.bspline import (bspline_basis_unrolled_list,
                                             make_bspline_grid)
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND, kernel_eligible
from convkan_tpu_torch.serve import build_model, build_parser

torch.set_num_threads(1)
CSRC = Path(kc.__file__).resolve().parents[1] / "csrc"
KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
RELU = kc.bspline_basis(KNOTS, 3, "relu")

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
using P = kan::BSpline<12, 3, 4>;
int main(int argc, char** argv) {
  float kn[12];
  for (int i = 0; i < 12; ++i) kn[i] = strtof(argv[1 + i], nullptr);
  for (int a = 13; a < argc; ++a) {
    const float x = strtof(argv[a], nullptr);
    float e[P::R];
    P::expand(x, kn, e, 1, 0);
    printf("%a %a", kan::relu(x), kan::relu_grad(x));
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
    """(relu, relu', E rows, dE rows) of the compiled policy."""
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
    R = RELU.R
    return rows[:, 0], rows[:, 1], rows[:, 2:2 + R], rows[:, 2 + R:]


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_relu_policy_as_host_cpp(tmp_path):
    rng = np.random.RandomState(0)
    tiny = np.float32(1e-30)
    xs = np.concatenate([
        [0.0, -0.0, tiny, -tiny, 1.0, -1.0, *KNOTS],
        rng.uniform(-3.0, 3.0, 200)]).astype(np.float32)
    r, dr, E, dE = _policy_rows(xs, tmp_path)
    xt = torch.from_numpy(xs).requires_grad_(True)
    want = F.relu(xt)
    (dwant,) = torch.autograd.grad(want.sum(), xt)
    assert np.array_equal(r.view(np.uint32),
                          want.detach().numpy().view(np.uint32))
    assert np.array_equal(dr, dwant.numpy())
    assert dr[0] == 0.0 and dr[1] == 0.0 and dr[2] == 1.0   # 0 at 0
    assert np.array_equal(dr, (xs > 0).astype(np.float32))
    rows = bspline_basis_unrolled_list(xt, KNOTS, 3) + [F.relu(xt)]
    assert np.array_equal(E, torch.stack(rows, -1).detach().numpy())
    for k, row in enumerate(rows):
        (d,) = torch.autograd.grad(row.sum(), xt, retain_graph=True)
        d = d.numpy()
        assert np.abs(dE[:, k] - d).max() <= 1e-5 * max(np.abs(d).max(), 1)


@pytest.mark.parametrize("C,O,k", [(16, 24, 1), (6, 8, 5)])
def test_plain_relu_basis_matches_the_pallas_kernel(C, O, k):
    rng = np.random.RandomState(C + k)
    pad = k // 2
    x = rng.uniform(-2.5, 2.5, (2, 7, 7, C)).astype(np.float32)
    x.reshape(-1)[:4] = (0.0, KNOTS[4], KNOTS[7], -0.0)
    g = rng.normal(0.0, 1.0, (2, 7, 7, O)).astype(np.float32)
    jm = JaxKanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=k,
                      padding=pad, base_activation="relu", norm_layer=None,
                      use_pallas=True, pallas_interpret=True)
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
    got = kc.kan_conv2d(*leaves, RELU, k, pad)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for a, b in zip(grads, (jdx, jdp["base_w"], jdp["poly_w"])):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 5e-5 * np.abs(b).max()


ZOO_SHAPES = list(dict.fromkeys(s for convs in ZOO_CONVS.values()
                                for s in convs))


@pytest.mark.parametrize("B", [64, 1024])
def test_launch_configs_accept_the_zoo_shapes(B):
    for H, C, O, k in ZOO_SHAPES:
        pad = k // 2
        f = kc.launch_config(B, H, H, C, O, k, pad, 9)
        d = kc.dx_launch_config(B, H, H, C, O, k, pad, 9)
        w = kc.dw_launch_config(B, H, H, C, O, k, pad, 9)
        assert f["smem"] <= kc.SMEM_LIMIT and d["smem"] <= kc.SMEM_LIMIT
        assert w["smem"] <= kc.SMEM_LIMIT
        assert 9 * d["CC"] * d["OC"] // 4 <= kc.THREADS
        assert w["S"] * 9 * C * k * k * O < 2 ** 31
        assert B * H * H * max(C, O) < 2 ** 31


def _walk(model, size):
    """(H, C, O, k, on the kernel route, base activation) of the model's
    KAN convs in forward order, from a forward on the meta device whose
    KAN convs only give their output's shape."""
    out = []

    def forward(m, x, generator=None):
        B, H, W, _ = x.shape
        k, s, p = m.kernel_size, m.stride, m.padding
        out.append((H, m.input_dim, m.output_dim, k, kernel_eligible(
            m.family, s, m.dilation, m.groups, k, p, H, W), m.act, m.basis))
        return torch.zeros(B, (H + 2 * p - k) // s + 1,
                           (W + 2 * p - k) // s + 1, m.output_dim,
                           device=x.device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(KanConvND, "forward", forward)
        with torch.no_grad():
            model.eval()(torch.zeros(1, size, size, 3, device="meta"))
    return out


@pytest.mark.parametrize("name", list(ZOO_ARGV))
def test_zoo_models_walk_to_the_chip_smoke_shapes(name):
    args = build_parser().parse_args(ZOO_ARGV[name] + [
        "--dataset", "CIFAR10", "--init_random", "--device", "meta"])
    size = zoo_size(name)
    convs = _walk(build_model(args, (size, size, 3), 10), size)
    assert [c[:4] for c in convs if c[4]] == ZOO_CONVS[name]
    assert sum(not c[4] for c in convs) == ZOO_PLAIN[name]
    assert {c[5] for c in convs} == {ZOO_ACT.get(name, "silu")}
    assert all(c[6].key in kc.COMPILED for c in convs)


def test_relu_module_runs_the_kernel_route_on_cpu():
    conv = KanConvND("kan", 16, 24, 1, base_activation="relu",
                     device="cpu", generator=torch.Generator())
    assert conv.basis == RELU and RELU.key in kc.COMPILED
    x = torch.randn(2, 7, 7, 16)
    assert conv.kernel_route(x)
    kc.reset_launches()
    conv(x)
    assert kc.plain_calls[kc.PLAIN] == 0 and sum(kc.launches.values()) == 0


def _emulators():
    import test_torch_kan_conv2d as fwd
    import test_torch_kan_conv_grad as bwd
    return fwd, bwd


@pytest.mark.parametrize("B,H,C,O", [(2, 9, 6, 12), (1, 7, 10, 20)])
def test_index_mappings_at_k5(B, H, C, O):
    fwd, bwd = _emulators()
    rng = np.random.RandomState(B * 100 + H)
    x = rng.uniform(-2.5, 2.5, (B, H, H, C))
    bw = rng.normal(0, 0.2, (5, 5, C, O))
    pw = rng.normal(0, 0.2, (5, 5, C * 8, O))
    g = rng.normal(0, 1, (B, H, H, O))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    cfg = kc.launch_config(B, H, H, C, O, 5, 2, 9)
    w_all = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=C,
                          K=8, k=5, O=O).numpy()
    got, written = fwd._emulate(x, w_all, KNOTS, 5, 2, cfg)
    want = kc.kan_conv2d_reference(xt, torch.from_numpy(bw),
                                   torch.from_numpy(pw), fwd.BASIS, 5, 2)
    assert (written == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
    cfg = kc.dw_launch_config(B, H, H, C, O, 5, 2, 9)
    got, written = bwd._emulate_dw(x, g, 5, 2, cfg)
    want = kc.weight_partials_reference(xt, gt, bwd.BASIS, 5, 2, cfg["S"],
                                        cfg["ips"])
    assert (written == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
