"""How far float32 lies from float64 in a VGG16_small or a
MobileNetV3-small of the port, on the CPU: the conditioning that
``chip_smoke.py``'s model and train phases hold the GPU's float32 readings
against.

    python3 tools/f32_spread.py --kan_conv ChebyKAN --seeds 5
    python3 tools/f32_spread.py --model MobileNetV3KAN --kan_conv FastKAN \
        --curve 0.1 --trace

``--kan_conv`` takes KAN, ChebyKAN, GRAMKAN or WavKAN.  For each seed of
the model's weights (the (2, 2) head for ChebyKAN and WavKAN, as
``chip_smoke.py`` builds them; KAN and GRAMKAN keep (1, 1)): the max |logit| difference of
float32 and float64 on ``chip_smoke.py``'s 64 images (eval mode), its
median over the images, and how far a relative change of 1e-7 of the
input moves the float32 logits.  Then, for ``chip_smoke.py``'s train model
and first batch, the first train step's gradients in float32 against
float64 (max |diff| over each parameter's largest entry, the worst three)
with each KAN conv's output multiplied by 1 + delta * N(0, 1): how much a
relative perturbation of the size of float32 sums taken in another order
(the GPU's kernels) moves them.  ``--steps 3`` reads the three train steps
of ``chip_smoke.py``'s lockstep phases instead (each from the float32
run's state before it), ``--batch`` sets their batch and
``--kan_norm_layer BatchNorm2d`` builds train.py's norm (phase 26).

``--model MobileNetV3KAN`` (``--kan_conv`` KAN, ChebyKAN or FastKAN) reads
one train-mode forward and backward of path C's train model (phase 34:
224 x 224, its first batch of 8) in float32 against float64: the loss,
the worst gradients and running statistics, with each KAN conv's curved
basis terms scaled by ``--curve`` (``chip_smoke.mnv3_smooth``; 1 is the
seeded init).  ``--trace`` prints, for every KAN conv and BatchNorm in
order, float32's error of its output and of its input (max |diff| over the
largest float64 entry) and their ratio: where the rounding grows.  Needs
no card.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from convkan_tpu_torch.models.vgg import vggkan  # noqa: E402
from convkan_tpu_torch.nn import kan_conv as nk  # noqa: E402
from convkan_tpu_torch.train.data import imagenet_batch  # noqa: E402
from convkan_tpu_torch.train.data import normalize_batch  # noqa: E402
from convkan_tpu_torch.train.metrics import cross_entropy_loss  # noqa: E402


def rel(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return ((a.double() - b.double()).abs().max() / b.abs().max()).item()


def mnv3(args):
    """Path C's train model in float32 against float64 (module docs)."""
    base = cs.mnv3_smooth(cs.mnv3_model(args.kan_conv, seed=22), args.curve)
    xb, yb, _, _ = cs.mnv3_batches(cs.MNV3_TRAIN_BATCH, steps=1)[0]
    x = imagenet_batch(xb, False, "CIFAR10")
    runs = []
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(base).to(dt).train()
        seen = {}
        for name, mod in m.named_modules():
            if type(mod).__name__ in ("KanConvND", "BatchNorm"):
                mod.register_forward_hook(
                    lambda _m, i, o, name=name: seen.__setitem__(
                        name, (i[0].detach(), o.detach())))
        loss = cross_entropy_loss(m(x.to(dt), torch.Generator().manual_seed(7)),
                                  yb)
        loss.backward()
        runs.append((loss.item(), seen,
                     {n: p.grad for n, p in m.named_parameters()},
                     dict(m.named_buffers())))
    (l32, s32, g32, b32), (l64, s64, g64, b64) = runs
    worst_g = sorted(((rel(g32[n], g), n) for n, g in g64.items()),
                     reverse=True)[:3]
    worst_b = max((rel(b32[n], b), n) for n, b in b64.items())
    print(f"{args.kan_conv} MobileNetV3-small, curved terms x {args.curve:g},"
          f" train mode, batch {cs.MNV3_TRAIN_BATCH}, float32 vs float64: "
          f"loss {abs(l32 - l64) / abs(l64):.3e} relative; gradients "
          + ", ".join(f"{n} {e:.3e}" for e, n in worst_g)
          + f"; running statistics {worst_b[1]} {worst_b[0]:.3e}", flush=True)
    if args.trace:
        for name, (i64, o64) in s64.items():
            i32, o32 = s32[name]
            e_in, e_out = rel(i32, i64), rel(o32, o64)
            print(f"  {name}: output {e_out:.3e}, input {e_in:.3e}, ratio "
                  f"{e_out / e_in if e_in else float('inf'):.3g}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="VGGKAN",
                   choices=["VGGKAN", "MobileNetV3KAN"])
    p.add_argument("--kan_conv", default="ChebyKAN",
                   choices=["KAN", "ChebyKAN", "GRAMKAN", "WavKAN",
                            "FastKAN"])
    p.add_argument("--curve", type=float, default=1.0)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--kan_norm_layer", default="InstanceNorm2d",
                   choices=["InstanceNorm2d", "BatchNorm2d"])
    p.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    p.add_argument("--steps", type=int, default=1)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    if args.model == "MobileNetV3KAN":
        return mnv3(args)
    kw = {} if args.kan_conv in ("KAN", "GRAMKAN") else \
        {"expected_feature_shape": (2, 2)}
    kw["kan_norm_layer"] = args.kan_norm_layer
    imgs = np.random.RandomState(0).randint(0, 256, (64, 32, 32, 3),
                                            np.uint8)
    x = normalize_batch(torch.from_numpy(imgs), "CIFAR10")
    for seed in range(args.seeds):
        m = vggkan(3, 10, arch="VGG16_small", kan_conv=args.kan_conv,
                   classifier_type="Linear", device="cpu",
                   generator=torch.Generator().manual_seed(seed), **kw).eval()
        with torch.no_grad():
            y32 = m(x)
            y64 = copy.deepcopy(m).double()(x.double())
            moved = (m(x * (1 + 1e-7)) - y32).abs().max().item()
        d = (y32.double() - y64).abs().max(dim=1).values
        print(f"{args.kan_conv} seed {seed}: logits float32 vs float64 max "
              f"{d.max().item():.3e}, median over images "
              f"{d.median().item():.3e}; input x (1 + 1e-7) moves float32 "
              f"by {moved:.3e}; max |logit| {y64.abs().max().item():.3f}",
              flush=True)
    if args.kan_conv == "WavKAN":
        return
    cs.TRAIN_BATCH = args.batch
    batch = cs.train_batches()[:args.steps]
    steps = range(args.steps)
    base = cs.train_model(args.kan_conv, **kw)
    _, _, snaps = cs.train_run(copy.deepcopy(base), "cpu", batch)
    starts = snaps[:-1]
    _, g64, _ = cs.train_run(copy.deepcopy(base).double(), "cpu", batch,
                             starts)
    conv = nk.kan_conv2d
    try:
        for delta in (0.0, 1e-7, 1e-6, 1e-5):
            gen = torch.Generator().manual_seed(11)

            def noisy(*a, delta=delta, gen=gen):
                y = conv(*a)
                return y * (1 + delta * torch.randn(y.shape, generator=gen,
                                                    dtype=y.dtype))

            nk.kan_conv2d = noisy
            _, g32, _ = cs.train_run(copy.deepcopy(base), "cpu", batch,
                                     starts)
            worst = cs.grad_readings(g32, g64, steps)[:3]
            span = "first step" if args.steps == 1 else \
                f"{args.steps} steps"
            print(f"{args.kan_conv} {args.kan_norm_layer} train model, batch "
                  f"{args.batch}, {span},"
                  f" conv outputs x (1 + {delta:g} N(0, 1)): gradients vs "
                  f"float64 " + ", ".join(f"{n} step {i} {e:.3e}"
                                          for e, i, n in worst), flush=True)
    finally:
        nk.kan_conv2d = conv


if __name__ == "__main__":
    main()
