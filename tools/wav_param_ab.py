"""Device times of the WavKAN parameter-gradient kernel
(``wav_conv2d_bwd_param``) of one checkout of the port, at the 9 distinct
VGG16_small conv shapes at batch 1024, timed by this checkout's
``chip_smoke.py`` (``cuda_ms``: a preloaded queue) with its bound
(``wav_bound``), so that two versions of the kernel are timed the same
way.  Run on the GPU machine from the repository root, once per tree, in
the order old, new, new, old:

    python3 tools/wav_param_ab.py --tree build/ab/v1 --label parent
    python3 tools/wav_param_ab.py --label new

``--tree`` is the root of the checkout whose ``convkan_tpu_torch`` is timed
(default: this one).  Builds only that tree's ``wav_conv2d_bwd.cu`` and
prints the compiler's registers and spills.  ``--check`` first holds the
kernel's partials against float64 autograd of the plain version
(``chip_smoke.bwd_close``: BWD_TOL) at the row widths it compiles, ragged
shapes and all 5 wavelets, and two calls bit-identical; ``--no-time``
skips the timing.  Prints one JSON line per shape (ms, bound, share, the
launch config), the 13-conv total per train step, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# (B, H, W, C, O, wavelet, pad): each compiled row width, the generic one,
# C not a multiple of 4, H = 1, pads 0 and 2, and all 5 wavelets
CHECKS = [(4, 32, 32, 3, 16, "mexican_hat", 1),
          (3, 32, 32, 16, 16, "mexican_hat", 1),
          (5, 16, 16, 16, 32, "mexican_hat", 1),
          (6, 8, 8, 32, 64, "mexican_hat", 1),
          (9, 4, 4, 64, 128, "mexican_hat", 1),
          (33, 2, 2, 128, 128, "mexican_hat", 1),
          (1024, 2, 2, 128, 128, "mexican_hat", 1),
          (3, 7, 5, 13, 5, "mexican_hat", 1),
          (5, 5, 7, 5, 16, "mexican_hat", 1),
          (9, 1, 8, 6, 32, "mexican_hat", 1),
          (4, 6, 4, 3, 8, "mexican_hat", 1),
          (3, 4, 4, 5, 16, "mexican_hat", 0),
          (2, 3, 5, 4, 12, "mexican_hat", 2)]
CHECKS += [(8, 8, 8, 16, 32, w, 1)
           for w in ("morlet", "dog", "meyer", "shannon")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import build
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tag = f"[{args.label or 'tree'}]"
    print(f"{tag} {card}; timing {Path(wc.__file__).resolve()}", flush=True)
    build.build(wc.BWD_SOURCE)   # named by a hash of the sources
    log = build.library_path(wc.BWD_SOURCE).with_suffix(".log").read_text()
    for line in log.splitlines():
        if "param" in line or "registers" in line or "spill" in line:
            print(f"{tag} [build] {line.strip()}")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    if args.check:
        for B, H, W, C, O, wt, pad in CHECKS:
            x, w, t, s = (a.to(dev) for a in smoke.wav_inputs(gen, B, H, W,
                                                              C, O))
            Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
            g = torch.randn(B, Ho, Wo, O, generator=gen).to(dev)
            cfg = wc.param_launch_config(B, H, W, C, O, 3, pad)
            part = wc.param_partials(x, w, t, s, g, wt, pad)
            again = wc.param_partials(x, w, t, s, g, wt, pad)
            torch.cuda.synchronize()
            ref = wc.param_partials_reference(
                *(a.double() for a in (x, w, t, s, g)), wt, pad, cfg["S"],
                cfg["ips"])
            err, ok = smoke.bwd_close(part, ref)
            same = torch.equal(part, again)
            print(f"{tag} [check] B={B} {H}x{W} C={C} O={O} {wt} pad={pad} "
                  f"S={cfg['S']}: max|err| {err:.3e} "
                  f"{'bit-identical' if same else 'NOT bit-identical'} "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            smoke.check(ok and same and bool(torch.isfinite(part).all()),
                        f"parameter kernel wrong at B={B} {H}x{W} C={C} "
                        f"O={O} {wt} pad={pad}")
    if args.no_time:
        return
    B, total, bound = smoke.TIME_BATCH, 0.0, 0.0
    for H, C, O in dict.fromkeys(smoke.VGG16_SMALL_CONVS):
        x, w, t, s = (a.to(dev) for a in smoke.wav_inputs(gen, B, H, H, C,
                                                          O))
        g = torch.randn(B, H, H, O, generator=gen).to(dev)
        cfg = wc.param_launch_config(B, H, H, C, O, 3, 1)
        ms = smoke.cuda_ms(lambda: wc.param_partials(x, w, t, s, g,
                                                     "mexican_hat", 1))
        b_ms = max(smoke.wav_bound("wav_conv2d_bwd_param", B, H, C, O,
                                   cfg["S"], cfg["N"]))
        n = smoke.VGG16_SMALL_CONVS.count((H, C, O))
        total += n * ms
        bound += n * b_ms
        print(f"{tag} [param time] " + json.dumps(
            {"H": H, "C": C, "O": O, "layers": n, "ms": round(ms, 4),
             "bound_ms": round(b_ms, 4), "share": round(b_ms / ms, 4),
             "config": {k: v for k, v in cfg.items() if k != "N"}}),
            flush=True)
    print(f"{tag} [param time] wav_conv2d_bwd_param per train step at batch "
          f"{B}: {total:.3f} ms, bound {bound:.3f} ms, "
          f"{100 * bound / total:.1f}% of the bound (on {card})", flush=True)


if __name__ == "__main__":
    main()
