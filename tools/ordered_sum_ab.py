"""Device times of the two ordered reductions of one checkout of the port
(``kan_conv2d_bwd_dw_reduce`` and ``wav_conv2d_bwd_reduce``) at the (S, N)
partials of the 13 VGG16_small convs at batch 1024, by ``chip_smoke.py``'s
``reduction_times`` (bit-exact check; cold and warm L2, ``partial.sum(0)``
beside) and bound, both taken from THIS checkout's ``chip_smoke.py``, so
that two versions of the kernels are timed the same way.  Run on the GPU
machine from the repository root, once per tree, in the order old, new,
new, old:

    python3 tools/ordered_sum_ab.py --tree build/ab/v1 --label parent
    python3 tools/ordered_sum_ab.py --label new

``--tree`` is the root of the checkout whose ``convkan_tpu_torch`` is timed
(default: this one).  Prints one JSON line per shape and kernel, the
13-conv totals, an empty kernel's time, and the card's name and power
limit.

    python3 tools/ordered_sum_ab.py --sweep

times instead this checkout's kernel, on a cold L2, at each distinct
(S, N) under every launch it takes (VW 1 and 4, Gw and Gc in 1, 2, 4, 8
with Gw*Gc <= S), beside the one ``reduce_launch_config`` picks: the data
its rule is fitted to.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import kan_conv2d as kc
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; timing {Path(kc.__file__).resolve()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    convs = smoke.VGG16_SMALL_CONVS
    pairs = {
        "kan_conv2d_bwd_dw_reduce": [
            (kc.dw_launch_config(1024, H, H, C, O, 3, 1, 9)["S"], 81 * C * O)
            for H, C, O in convs],
        "wav_conv2d_bwd_reduce": [
            (cfg["S"], cfg["N"]) for cfg in (
                wc.param_launch_config(1024, H, H, C, O, 3, 1)
                for H, C, O in convs)],
    }
    if args.sweep:
        sweep(smoke, kc, gen, dict.fromkeys(
            pairs["kan_conv2d_bwd_dw_reduce"]
            + pairs["wav_conv2d_bwd_reduce"]))
        return
    mods = {"kan_conv2d_bwd_dw_reduce": kc, "wav_conv2d_bwd_reduce": wc}
    totals = {}
    for name, shapes in pairs.items():
        tot = dict.fromkeys(("ms", "library_ms", "warm_l2_ms",
                             "library_warm_l2_ms", "bound_ms"), 0.0)
        for (H, C, O), (S, N) in zip(convs, shapes):
            part = torch.randn(S, N, device="cuda", generator=gen)
            red = smoke.reduction_times(name, mods[name].reduce_partials,
                                        mods[name].reduce_reference, part)
            adds, nbytes = smoke.reduce_work(S, N)
            red["bound_ms"] = max(adds / smoke.PEAK_FP32_FLOPS,
                                  nbytes / smoke.PEAK_BYTES) * 1e3
            for key in tot:
                tot[key] += red[key]
            print(json.dumps({
                "label": args.label, "kernel": name, "H": H, "C": C, "O": O,
                "S": S, "N": N, **{k: round(v, 5) for k, v in red.items()},
                "bound_share": round(red["bound_ms"] / red["ms"], 4),
                "vs_sum": round(red["ms"] / red["library_ms"], 4)}),
                flush=True)
        totals[name] = {k: round(v, 4) for k, v in tot.items()}
    empty = smoke.cuda_ms(lambda: torch.cuda._sleep(0), iters=100)
    print(json.dumps({"label": args.label, "totals": totals,
                      "empty_kernel_ms": round(empty, 5), "card": card,
                      "host_bound": {k: sorted(v) for k, v in
                                     smoke.HOST_BOUND.items()}}), flush=True)


def sweep(smoke, kc, gen, pairs):
    """Every launch the kernel takes at each (S, N), timed on a cold L2
    through the C entry of kan_conv2d_bwd_dw_reduce; one JSON line per
    (S, N)."""
    fn = kc._fn("kan_conv2d_bwd_dw_reduce")
    stream = torch.cuda.current_stream().cuda_stream
    for S, N in pairs:
        part = torch.randn(S, N, device="cuda", generator=gen)
        nxt = smoke.cold_copies(part)
        out = torch.empty(N, device="cuda")
        pick = kc.reduce_launch_config(S, N)
        times = {}
        for vw in sorted({1, pick["VW"]}):
            for gw in (1, 2, 4, 8):
                for gc in (1, 2, 4, 8):
                    if gw * gc > S:
                        continue

                    def run():
                        err = fn(nxt().data_ptr(), out.data_ptr(), S, N, vw,
                                 gw, gc, stream)
                        assert err == 0, err
                    times[f"{vw},{gw},{gc}"] = round(
                        1e3 * smoke.cuda_ms(run), 3)
        best = min(times, key=times.get)
        print(json.dumps({
            "S": S, "N": N, "pick": f"{pick['VW']},{pick['Gw']},{pick['Gc']}",
            "pick_us": times[f"{pick['VW']},{pick['Gw']},{pick['Gc']}"],
            "best": best, "best_us": times[best],
            "sum_us": round(1e3 * smoke.cuda_ms(
                lambda: nxt().sum(0), what=("sum", "library_ms")), 3),
            "us_by_VW_Gw_Gc": times}), flush=True)


if __name__ == "__main__":
    main()
