"""How far the WavKAN train phase's gradient readings of ``chip_smoke.py``
(phase 13, in lockstep) move from run to run, and why.  Run on the GPU
machine from the repository root:

    python3 tools/train_grad_spread.py --runs 12

1. repeats: each kernel of the model's backward on the GPU, called again
   on the same inputs at the phase's shapes (batch 16): the psi-conv
   kernels, cuDNN's data and weight gradients of the base conv (with
   cuDNN's deterministic algorithms off and on) and max-pool's backward;
   prints for each how many of the calls differ in any bit from the first.
   Also the ops that torch.use_deterministic_algorithms(warn_only=True)
   flags in one run of the GPU steps.
2. runs: the phase's comparison (``chip_smoke.train_compare``: three
   train steps on the GPU, on the CPU in float32 and in float64, each GPU
   step from the CPU run's state before it; ``--gpu_starts``: each CPU
   and float64 step from the GPU run's, as the phase did before),
   ``--runs`` times with ``torch.backends.cudnn.deterministic`` False
   and as many times True (``--cudnn_deterministic off`` or ``on``: one
   of them; ``benchmark`` False in both): per run the GPU losses, the
   readings (max |got - want| / max |want| over parameters and steps, at
   the worst: GPU vs float64, which the phase checks; CPU vs float64; GPU
   vs CPU) and which parameters' step-0 GPU gradients differ in any bit
   from the first run's; per setting the readings sorted, and how many
   are over GRAD_TOL.
``--skip_repeats``: runs only.  Writes every number to
``chiprun_out/train_grad_spread_<setting>[_gpu_starts].json``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _differs(a, b) -> bool:
    return not torch.equal(a, b)


def repeats(cs, dev, calls):
    """Calls that differ in any bit from the first, per kernel and shape."""
    from convkan_tpu_torch.kernels import wav_conv2d as wc
    gen = torch.Generator().manual_seed(11)
    B, out = cs.TRAIN_BATCH, []
    for H, C, O in dict.fromkeys(cs.VGG16_SMALL_CONVS):
        g = torch.randn(B, H, H, O, generator=gen).to(dev)
        x, w, t, s = (a.to(dev) for a in cs.wav_inputs(gen, B, H, H, C, O))
        spec = ("mexican_hat", 1)
        part = wc.param_partials(x, w, t, s, g, *spec)
        fns = {
            "wav_conv2d_fwd": lambda: wc.wav_conv2d(
                x, w, t, s, wavelet_type="mexican_hat", padding=1),
            "wav_conv2d_bwd_dx": lambda: wc.input_grad(x, w, t, s, g, *spec),
            "wav_conv2d_bwd_param": lambda: wc.param_partials(x, w, t, s, g,
                                                              *spec),
            "wav_conv2d_bwd_reduce": lambda: wc.reduce_partials(part)}
        # the base conv's gradients, as F.conv2d's backward takes them
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()
        gn = g.permute(0, 3, 1, 2).contiguous()
        for det in (False, True):
            for which, mask in (("dgrad", [True, False, False]),
                                ("wgrad", [False, True, False])):
                fns[f"cudnn {which} deterministic={det}"] = functools.partial(
                    conv_grad, gn, xn, wn, mask, det)
        if H > 2:
            y = torch.randn(B, O, H, H, generator=gen).to(dev) \
                .requires_grad_(True)
            p = F.max_pool2d(y, 2, 2)
            gp = torch.randn(p.shape, generator=gen).to(dev)
            fns["max_pool2d backward"] = lambda: torch.autograd.grad(
                p, y, gp, retain_graph=True)[0]
        for name, fn in fns.items():
            first = fn().clone()
            bad = sum(_differs(fn(), first) for _ in range(calls - 1))
            out.append({"kernel": name, "H": H, "C": C, "O": O, "B": B,
                        "calls": calls, "differ": bad})
            print(f"[repeat] {name} {B}x{H}x{H} {C}->{O}: {bad} of "
                  f"{calls - 1} calls differ from the first", flush=True)
    return out


def conv_grad(gn, xn, wn, mask, deterministic):
    torch.backends.cudnn.deterministic = deterministic
    try:
        return torch.ops.aten.convolution_backward(
            gn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            mask)[mask.index(True)]
    finally:
        torch.backends.cudnn.deterministic = False


def flagged_ops(cs, dev):
    """The warnings of torch.use_deterministic_algorithms(warn_only=True)
    over the phase's GPU steps: the ops PyTorch knows to have no
    deterministic implementation."""
    model = cs.train_model("WavKAN", **cs.WAV_MODEL).to(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            cs.train_run(model, dev, cs.train_batches())
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split("\n")[0][:200] for w in caught
                      if "determinis" in str(w.message)})
    print(f"[flagged] ops without a deterministic implementation: "
          f"{flagged}", flush=True)
    return flagged


def runs(cs, dev, n, settings, gpu_starts):
    """The phase's comparison (``train_compare``) ``n`` times per cuDNN
    setting: the GPU losses, the readings, and which parameters' step-0
    GPU gradients differ in any bit from the first run's."""
    from convkan_tpu_torch.kernels import wav_conv2d as wc
    out = {}
    for det in settings:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = False
        rows, first = [], None
        for i in range(n):
            r = cs.train_compare(wc, dev, "WavKAN", lockstep=True,
                                 gpu_starts=gpu_starts, **cs.WAV_MODEL)
            g0 = r["grads_gpu"][0]
            first = first or g0
            moved0 = [name for name, t in g0.items()
                      if _differs(t, first[name])]
            row = {"run": i, "losses_gpu": r["losses_gpu"],
                   "losses_cpu": r["losses_cpu"],
                   **{key: r[key] for key in ("gpu_vs_f64", "cpu_vs_f64",
                                              "gpu_vs_cpu")},
                   "step0_grads_differ_from_run0": moved0}
            rows.append(row)
            print(f"[run] det={det} {i}: losses GPU {r['losses_gpu']}; "
                  f"GPU vs float64 {r['gpu_vs_f64']}, CPU vs float64 "
                  f"{r['cpu_vs_f64']}, GPU vs CPU {r['gpu_vs_cpu']}; "
                  f"step-0 GPU gradients differing from run 0: "
                  f"{len(moved0)}", flush=True)
        for key in ("gpu_vs_f64", "cpu_vs_f64", "gpu_vs_cpu"):
            vals = sorted(round(row[key][0], 6) for row in rows)
            over = sum(v > cs.GRAD_TOL for v in vals)
            print(f"[runs] det={det} {key}: {over} of {n} runs over "
                  f"GRAD_TOL {cs.GRAD_TOL}; readings {vals}", flush=True)
        out[f"deterministic={det}"] = rows
    torch.backends.cudnn.deterministic = False
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--gpu_starts", action="store_true")
    ap.add_argument("--cudnn_deterministic", default="both",
                    choices=("both", "off", "on"))
    ap.add_argument("--skip_repeats", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    cs = _smoke()
    from convkan_tpu_torch.device import set_full_f32
    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    settings = {"both": (False, True), "off": (False,),
                "on": (True,)}[args.cudnn_deterministic]
    result = {"card": card, "gpu_starts": args.gpu_starts,
              "runs": runs(cs, dev, args.runs, settings, args.gpu_starts)}
    if not args.skip_repeats:
        result.update(repeats=repeats(cs, dev, args.calls),
                      flagged=flagged_ops(cs, dev))
    path = ROOT / "chiprun_out" / (
        f"train_grad_spread_{args.cudnn_deterministic}"
        f"{'_gpu_starts' if args.gpu_starts else ''}.json")
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(f"wrote {path.relative_to(ROOT)}", flush=True)


if __name__ == "__main__":
    main()
