"""Device times of one WavKAN kernel of one checkout of the port: the
parameter-gradient kernel (``wav_conv2d_bwd_param``, the default), the
data-gradient kernel (``--kernel dx``, ``wav_conv2d_bwd_dx``) or the
forward (``--kernel fwd``, ``wav_conv2d_fwd``), at the distinct
VGG16_small conv shapes at ``--batch`` (default 1024), timed by this
checkout's ``chip_smoke.py`` (``cuda_ms``: a preloaded queue) with its
bound (``wav_bound``), so that two versions of a kernel are timed the same
way.  Run on the GPU machine from the repository root, once per tree, in
the order old, new, new, old:

    python3 tools/wav_param_ab.py --kernel dx --tree build/ab/v1 --label parent
    python3 tools/wav_param_ab.py --kernel dx --label new

``--tree`` is the root of the checkout whose ``convkan_tpu_torch`` is timed
(default: this one).  Builds only that tree's source of the kernel
(``wav_conv2d_bwd.cu``, or ``wav_conv2d_fwd.cu`` for the forward) and
prints the compiler's registers and spills of the chosen kernel's
instantiations.  ``--check`` first holds the kernel's result (the
parameter partials or dx against float64 autograd of the plain version,
``chip_smoke.bwd_close``: BWD_TOL; the forward against the plain version
within ``chip_smoke.TOL``) at the row widths it compiles, ragged shapes,
pads 0 and 2 and all 5 wavelets, and two calls bit-identical;
``--no-time`` skips the timing.  Prints one JSON line per shape (ms,
bound, share, the launch config), the total per train step (the data
gradient skips the first conv) or per forward, and the card's name and
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
# the data gradient's compiled rows of 4 and 2 in the other wavelets, a
# compiled width at odd H, O = 9 and width 11 at pad 0
DX_CHECKS = CHECKS + [(6, H, H, C, 32, w, 1) for H, C in ((4, 32), (2, 64))
                      for w in ("morlet", "dog", "meyer", "shannon")]
DX_CHECKS += [(5, 3, 8, 16, 20, "mexican_hat", 1),
              (4, 5, 4, 16, 9, "mexican_hat", 1),
              (4, 5, 2, 16, 9, "mexican_hat", 1),
              (3, 5, 11, 12, 13, "shannon", 0)]
# the forward's: each compiled width (8, 4, 2) in every wavelet, the
# generic strips (32, 16, odd widths), pads 0 and 2, C not a multiple of
# the chunk or of 4, O not a multiple of 4, batch 1, and at batch 1024
# (one band of the whole plane, RB = H) each VGG16_small plane
FWD_CHECKS = [(5, H, H, C, 24, w, 1) for H, C in ((8, 16), (4, 32), (2, 64))
              for w in ("mexican_hat", "morlet", "dog", "meyer", "shannon")]
FWD_CHECKS += [(4, 32, 32, 3, 16, "mexican_hat", 1),
               (3, 16, 16, 32, 32, "mexican_hat", 1),
               (3, 7, 5, 13, 5, "mexican_hat", 1),
               (2, 11, 13, 5, 9, "shannon", 1),
               (3, 4, 4, 5, 16, "mexican_hat", 0),
               (2, 3, 5, 4, 12, "dog", 2),
               (1, 32, 32, 16, 16, "mexican_hat", 1),
               (1, 2, 2, 128, 128, "mexican_hat", 1),
               (1024, 2, 2, 128, 128, "mexican_hat", 1),
               (1024, 4, 4, 128, 128, "mexican_hat", 1),
               (1024, 8, 8, 64, 64, "mexican_hat", 1),
               (1024, 16, 16, 32, 32, "mexican_hat", 1),
               (1024, 32, 32, 16, 16, "mexican_hat", 1)]
KERNEL_NAMES = {"param": "wav_conv2d_bwd_param", "dx": "wav_conv2d_bwd_dx",
                "fwd": "wav_conv2d_fwd"}


def build_report(log: str, kernel: str):
    """(instantiation, registers line) of the kernel's entries in a ptxas
    -v log, demangled where c++filt is there."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and kernel in name and ("registers" in line or
                                          "spill" in line):
            out.append((name, line.strip()))
    names = sorted({n for n, _ in out})
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
        names = dict(zip(names, dem))
    except (OSError, subprocess.CalledProcessError):
        names = {n: n for n in names}
    return [(names[n], line) for n, line in out]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernel", choices=sorted(KERNEL_NAMES), default="param")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--batch", type=int, default=1024)
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
    fwd = args.kernel == "fwd"
    source = wc.SOURCE if fwd else wc.BWD_SOURCE
    build.build(source)   # named by a hash of the sources
    log = build.library_path(source).with_suffix(".log").read_text()
    name = KERNEL_NAMES[args.kernel]
    for inst, line in build_report(log, name + "_kernel"):
        print(f"{tag} [build] {inst}: {line}")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    dx = args.kernel == "dx"

    def run(x, w, t, s, g, wt, pad):
        if fwd:
            return wc.wav_conv2d(x, w, t, s, wavelet_type=wt, padding=pad)
        if dx:
            return wc.input_grad(x, w, t, s, g, wt, pad)
        return wc.param_partials(x, w, t, s, g, wt, pad)

    def config(B, H, W, C, O, pad):
        if fwd:
            return wc.fwd_launch_config(B, H, W, C, O, 3, pad)
        if dx:
            return wc.dx_launch_config(B, H, W, C, O, 3, pad)
        return wc.param_launch_config(B, H, W, C, O, 3, pad)

    if args.check:
        for B, H, W, C, O, wt, pad in (FWD_CHECKS if fwd else
                                        DX_CHECKS if dx else CHECKS):
            x, w, t, s = (a.to(dev) for a in smoke.wav_inputs(gen, B, H, W,
                                                              C, O))
            Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
            g = torch.randn(B, Ho, Wo, O, generator=gen).to(dev)
            cfg = config(B, H, W, C, O, pad)
            got = run(x, w, t, s, g, wt, pad)
            again = run(x, w, t, s, g, wt, pad)
            torch.cuda.synchronize()
            if fwd:
                ref = wc.wav_conv2d_reference(x, w, t, s, wavelet_type=wt,
                                              padding=pad)
                err = (got - ref).abs().max().item()
                ok = torch.allclose(got, ref, rtol=smoke.TOL, atol=smoke.TOL)
            else:
                d64 = [a.double() for a in (x, w, t, s, g)]
                ref = wc.input_grad_reference(*d64, wt, pad) if dx else \
                    wc.param_partials_reference(*d64, wt, pad, cfg["S"],
                                                cfg["ips"])
                err, ok = smoke.bwd_close(got, ref)
            same = torch.equal(got, again)
            band = f" RB={cfg['RB']}" if fwd else ""
            print(f"{tag} [check] {name} B={B} {H}x{W} C={C} O={O} {wt} "
                  f"pad={pad}{band}: max|err| {err:.3e} "
                  f"{'bit-identical' if same else 'NOT bit-identical'} "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            smoke.check(ok and same and bool(torch.isfinite(got).all()),
                        f"{name} wrong at B={B} {H}x{W} C={C} O={O} {wt} "
                        f"pad={pad}")
    if args.no_time:
        return
    B, total, bound = args.batch, 0.0, 0.0
    for H, C, O in dict.fromkeys(smoke.VGG16_SMALL_CONVS):
        x, w, t, s = (a.to(dev) for a in smoke.wav_inputs(gen, B, H, H, C,
                                                          O))
        g = torch.randn(B, H, H, O, generator=gen).to(dev)
        cfg = config(B, H, H, C, O, 1)
        pcfg = wc.param_launch_config(B, H, H, C, O, 3, 1)
        ms = smoke.cuda_ms(lambda: run(x, w, t, s, g, "mexican_hat", 1))
        b_ms = max(smoke.wav_bound(name, B, H, C, O, pcfg["S"], pcfg["N"]))
        n = smoke.VGG16_SMALL_CONVS.count((H, C, O))
        if dx and (H, C, O) == smoke.VGG16_SMALL_CONVS[0]:
            n -= 1   # the first conv's input is the image: no dx
        total += n * ms
        bound += n * b_ms
        print(f"{tag} [{args.kernel} time] " + json.dumps(
            {"H": H, "C": C, "O": O, "layers": n, "ms": round(ms, 4),
             "bound_ms": round(b_ms, 4), "share": round(b_ms / ms, 4),
             "config": {k: v for k, v in cfg.items() if k != "N"}}),
            flush=True)
    print(f"{tag} [{args.kernel} time] {name} per "
          f"{'forward' if fwd else 'train step'} at batch "
          f"{B}: {total:.3f} ms, bound {bound:.3f} ms, "
          f"{100 * bound / total:.1f}% of the bound (on {card})", flush=True)


if __name__ == "__main__":
    main()
