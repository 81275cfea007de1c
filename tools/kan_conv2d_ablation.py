"""Where the time of the CUDA KAN-conv kernel goes: times
``convkan_tpu_torch``'s ``kan_conv2d`` at the 9 KAN-VGG16_small conv
shapes (batch 1024, CUDA events), for the kernel as committed and for two
ablated copies built from edited sources:

  * ``rcp``:   the basis recurrence multiplies by a rounded reciprocal
               instead of dividing (the cost of the IEEE divides);
  * ``nobasis``: the expanded values are x itself (the cost of the whole
               basis and activation; the contraction alone is left).

The ablated kernels compute wrong values and are only timed; the copies
live under ``build/ablation/`` and the package itself is not touched.
Run on the GPU machine from the repository root:

    python3 tools/kan_conv2d_ablation.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ablation"
SRC = "convkan_tpu_torch/csrc/kan_conv2d_fwd.cu"
SHAPES = [(32, 3, 16, 1), (32, 16, 16, 1), (16, 16, 32, 1), (16, 32, 32, 1),
          (8, 32, 64, 1), (8, 64, 64, 2), (4, 64, 128, 1), (4, 128, 128, 2),
          (2, 128, 128, 3)]   # (H, C, O, layers) of VGG16_small

EDITS = {
    "committed": [],
    "rcp": [("__fdiv_rn(__fsub_rn(x, kn.v[i]), dr)",
             "__fmul_rn(__fsub_rn(x, kn.v[i]), __frcp_rn(dr))"),
            ("__fdiv_rn(__fsub_rn(kn.v[i + k + 1], x), dd)",
             "__fmul_rn(__fsub_rn(kn.v[i + k + 1], x), __frcp_rn(dd))")],
    "nobasis": [("""        float bas[K];
        bspline<NK, ORDER>(xv, kn, bas);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) Ep[kk * s.CC] = bas[kk];
        Ep[K * s.CC] = base_act<ACT>(xv);""", """#pragma unroll
        for (int kk = 0; kk <= K; ++kk) Ep[kk * s.CC] = xv;""")],
}

TIMER = r"""
import json, sys, torch
sys.path.insert(0, '.')
from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc
knots = tuple(float(v) for v in make_bspline_grid(5, 3))
g = torch.Generator().manual_seed(0)
rows = {}
for H, C, O, n in json.loads(sys.argv[1]):
    x = (torch.rand(1024, H, H, C, generator=g) * 2 - 1).cuda()
    bw = (torch.randn(3, 3, C, O, generator=g) * 0.1).cuda()
    pw = (torch.randn(3, 3, C * 8, O, generator=g) * 0.1).cuda()
    run = lambda: kc.kan_conv2d(x, bw, pw, knots, 3, 3, 1, "silu")
    for _ in range(3):
        run()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(); a.record()
    for _ in range(20):
        run()
    b.record(); torch.cuda.synchronize()
    rows[f"{H}x{H} {C}->{O}"] = (n, a.elapsed_time(b) / 20)
print(json.dumps(rows))
"""


def variant_dir(name: str) -> Path:
    """A copy of the package with the variant's edits applied."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "convkan_tpu_torch", d / "convkan_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = d / SRC
    text = src.read_text()
    for old, new in EDITS[name]:
        if old not in text:
            raise SystemExit(f"{name}: the kernel source no longer contains "
                             f"the text this ablation edits:\n{old}")
        text = text.replace(old, new)
    src.write_text(text)
    return d


def main():
    dirs = {name: variant_dir(name) for name in EDITS}
    results = {name: [] for name in EDITS}
    for _ in range(2):                       # two rounds, variants in turn
        for name, d in dirs.items():
            proc = subprocess.run(
                [sys.executable, "-c", TIMER, json.dumps(SHAPES)], cwd=d,
                capture_output=True, text=True, check=True)
            results[name].append(json.loads(proc.stdout.strip()
                                            .splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    for name, runs in results.items():
        totals = [sum(n * ms for n, ms in r.values()) for r in runs]
        per = {k: round(min(r[k][1] for r in runs), 4) for k in runs[0]}
        print(json.dumps({"variant": name, "total_ms_runs": totals,
                          "min_ms_per_shape": per}))


if __name__ == "__main__":
    main()
