"""How far float32 lies from float64 in a VGG16_small, a
MobileNetV3-small or an EfficientNetV2 of the port, on the CPU: the
conditioning that ``chip_smoke.py``'s model and train phases hold the
GPU's float32 readings against.

    python3 tools/f32_spread.py --kan_conv ChebyKAN --seeds 5
    python3 tools/f32_spread.py --model MobileNetV3KAN --kan_conv FastKAN \
        --curve 0.1 --trace

``--kan_conv`` takes a key of the port's conv factory (for VGG16_small
every one but FastKAN: KAN, ChebyKAN, GRAMKAN, WavKAN and path E's static
families, JacobiKAN, HermiteKAN, FourierKAN, ...). For each seed of the
model's weights (the (2, 2) head for ChebyKAN and WavKAN, as
``chip_smoke.py`` builds them; the others keep (1, 1)): the max |logit|
difference of float32 and float64 on ``chip_smoke.py``'s 64 images (eval
mode), its median over the images, and how far a relative change of 1e-7
of the input moves the float32 logits. Then, for ``chip_smoke.py``'s train
model and first batch, the first train step's gradients in float32 against
float64 (max |diff| over each parameter's largest entry, the worst three)
with each KAN conv's output multiplied by 1 + delta * N(0, 1): how much a
relative perturbation of the size of float32 sums taken in another order
(the GPU's kernels) moves them. ``--steps 3`` reads the three train steps
of ``chip_smoke.py``'s lockstep phases instead (each from the float32
run's state before it), ``--batch`` sets their batch and
``--kan_norm_layer BatchNorm2d`` builds train.py's norm (phase 26);
``--curve`` scales the convs' curved basis terms (``chip_smoke.mnv3_smooth``:
path E's FourierKAN runs at ``chip_smoke.STATIC_CURVE``).  Last, the spread
that ``chip_smoke.f32_spread`` reads at the lockstep starts, and the
gradient limit it sets on every parameter but the PReLU slopes.

``--model EfficientNetV2KAN`` (``--kan_conv`` KAN, GRAMKAN or FastKAN)
reads, for path D's s model (``chip_smoke.effv2_eval_model``: smoothed,
calibrated; GRAMKAN: kan_tiny), the eval logits of phase 37's images in
float32 against float64; then (KAN, GRAMKAN) the seeded s model of phase
39 (``chip_smoke.effv2_train_model``: GRAMKAN at ``--curve 1``, KAN
at ``chip_smoke.MNV3_CURVE``) with its curved terms at ``--curve``, on
phase 39's first batch, as for MobileNetV3 below (its DropPath masks from
one seeded generator on both sides), and phase 39's first train step's
float32 spread under ``chip_smoke.F32_NOISE`` (``chip_smoke.f32_spread``):
the largest entries beside float32's own reading, and how many reach
1 / ``chip_smoke.F32_SPREAD``, where a zero gradient would pass
``chip_smoke.phase_train``'s rule.  With ``--card`` (needs a GPU) it
also runs phase 39's first train step (``chip_smoke.train_run``) in
float32 on the card, once with the KAN convs on the kernels and once with
all of them on the plain route, and prints, for the card's worst
gradients against float64, each route's reading beside the CPU float32's:
whether a distance from float64 comes from the kernels or from the rest
of the card's step.  Then the same step without remat, which keeps every
KAN conv's input and output gradient: each conv's forward, data-gradient
and weight-gradient kernels on those tensors against float64 of their
plain versions (max |diff| over the largest float64 entry), the worst
convs printed.

``--model MobileNetV3KAN`` (``--kan_conv`` KAN, ChebyKAN or FastKAN) reads
one train-mode forward and backward of path C's train model (phase 34:
224 x 224, its first batch of 8) in float32 against float64: the loss,
the worst gradients and running statistics, with each KAN conv's curved
basis terms scaled by ``--curve`` (``chip_smoke.mnv3_smooth``; 1 is the
seeded init).  ``--trace`` prints, for every KAN conv and BatchNorm in
order, float32's error of its output and of its input (max |diff| over the
largest float64 entry) and their ratio: where the rounding grows.  Needs
no card but for ``--card``.

``--model AlexNetKAN`` reads path F's main model (``chip_smoke.zoo_model``
"alexnet_small": train.py's AlexNet small with the KAN head and
BatchNorm2d): phase 47's eval logits (calibrated) in float32 against
float64, then phase 49's train steps (``--steps 3``) as for VGG16_small
above, with the convs' poly_w at ``--curve``.
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
from convkan_tpu_torch.factory.conv_factory import \
    CONV_KAN_FACTORY  # noqa: E402
from convkan_tpu_torch.models.vgg import vggkan  # noqa: E402
from convkan_tpu_torch.nn import kan_conv as nk  # noqa: E402
from convkan_tpu_torch.train.data import imagenet_batch  # noqa: E402
from convkan_tpu_torch.train.data import normalize_batch  # noqa: E402
from convkan_tpu_torch.train.metrics import cross_entropy_loss  # noqa: E402


def rel(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return ((a.double() - b.double()).abs().max() / b.abs().max()).item()


def effv2(args):
    """Path D's models in float32 against float64 (module docs)."""
    tiny = args.kan_conv == "GRAMKAN"
    m = cs.effv2_eval_model(args.kan_conv)
    imgs = cs.seeded_images(cs.EFFV2_MODEL_BATCH, 41, 32 if tiny else 224)
    x = normalize_batch(torch.from_numpy(imgs), "CIFAR10") if tiny else \
        cs.mnv3_prep(imgs)
    with torch.no_grad():
        y32 = m(x)
        y64 = copy.deepcopy(m).double()(x.double())
    print(f"{args.kan_conv} EfficientNetV2 eval logits float32 vs float64: "
          f"max |diff| {(y32.double() - y64).abs().max().item():.3e}, max "
          f"|logit| {y64.abs().max().item():.3f}, spread over the images "
          f"{(y64 - y64[0]).abs().max().item():.3e}", flush=True)
    if args.kan_conv == "FastKAN":
        return
    base = cs.mnv3_smooth(cs.effv2_model(
        args.kan_conv, seed=42, stochastic_depth_prob=cs.EFFV2_SD),
        args.curve)
    xb, yb, _, _ = cs.effv2_batches(cs.EFFV2_TRAIN_BATCH, steps=1)[0]
    train_readings(base, normalize_batch(xb, "CIFAR10"), yb, args,
                   f"{args.kan_conv} EfficientNetV2-s {cs.EFFV2_TRAIN_SIZE}x"
                   f"{cs.EFFV2_TRAIN_SIZE}, batch {cs.EFFV2_TRAIN_BATCH}")
    batches = cs.effv2_batches(cs.EFFV2_TRAIN_BATCH, steps=1)
    spread_readings(base, batches, cs.effv2_step)
    if args.card:
        card_readings(base, batches, cs.effv2_step)


def spread_readings(base, batches, make_step, worst=8):
    """The first train step of ``batches`` on the CPU in float32 and
    float64, and float32's spread there (module docs)."""
    _, g32, snaps = cs.train_run(copy.deepcopy(base), "cpu", batches,
                                 make_step=make_step, steps_per_epoch=100)
    _, g64, _ = cs.train_run(copy.deepcopy(base).double(), "cpu", batches,
                             make_step=make_step, steps_per_epoch=100)
    spread = cs.f32_spread(base, batches, snaps[:1], range(1), make_step,
                           g64, 100)
    f32 = {n: e for e, _, n in cs.grad_readings(g32, g64, range(1))}
    top = sorted(spread.items(), key=lambda kv: kv[1], reverse=True)[:worst]
    loose = sum(cs.F32_SPREAD * v >= 1 for v in spread.values())
    print(f"first train step on the CPU: float32's spread (conv outputs x "
          f"(1 + {cs.F32_NOISE:g} N(0, 1)), seeds {cs.F32_NOISE_SEEDS}) "
          f"reaches 1 / {cs.F32_SPREAD} at {loose} of {len(spread)} "
          f"gradients; the largest (float32 vs float64, spread): "
          + "; ".join(f"{n} {f32[n]:.3e} {v:.3e}" for (_, n), v in top),
          flush=True)


def card_readings(base, batches, make_step, worst=8):
    """``--card``: the first train step of ``batches`` in float32 on the
    card, its KAN convs on the kernels and then on the plain route, and on
    the CPU, each against float64 (module docs)."""
    from concurrent.futures import ThreadPoolExecutor

    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import build
    from convkan_tpu_torch.kernels import kan_conv2d as kc

    set_full_f32()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build.build, (kc.SOURCE, kc.BWD_SOURCE)))

    def grads(dt, device, plain=False):
        route = nk.KanConvND.kernel_route
        if plain:
            nk.KanConvND.kernel_route = lambda self, x: False
        try:
            return cs.train_run(copy.deepcopy(base).to(dt).to(device),
                                device, batches, make_step=make_step,
                                steps_per_epoch=100)[1][0]
        finally:
            nk.KanConvND.kernel_route = route

    g64 = grads(torch.float64, "cpu")
    runs = {"CPU float32": grads(torch.float32, "cpu"),
            "card, kernels": grads(torch.float32, "cuda"),
            "card, plain route": grads(torch.float32, "cuda", plain=True)}
    read = {k: {n: rel(g[n], r) for n, r in g64.items()}
            for k, g in runs.items()}
    for k, r in read.items():
        n = max(r, key=r.get)
        print(f"{k} vs float64: max {r[n]:.3e} ({n})", flush=True)
    top = sorted(g64, key=read["card, kernels"].get, reverse=True)[:worst]
    print("card's worst gradients vs float64 (" + ", ".join(read) + "): "
          + "; ".join(f"{n} " + " ".join(f"{r[n]:.3e}" for r in
                                          read.values()) for n in top),
          flush=True)
    model = copy.deepcopy(base).to("cuda")
    model.remat = False     # the same step, each conv called once
    rows = cs.conv_kernel_readings(kc, model, batches, make_step, "cuda")
    print(f"kernels on the step's own tensors (no remat) vs float64, "
          f"{len(rows)} convs (forward, dx, dW), the worst {worst}: "
          + "; ".join(f"{nm} {key}: {f:.3e} {dx:.3e} {dw:.3e}"
                      for _, nm, key, f, dx, dw in rows[:worst]), flush=True)


def mnv3(args):
    """Path C's train model in float32 against float64 (module docs)."""
    base = cs.mnv3_smooth(cs.mnv3_model(args.kan_conv, seed=22), args.curve)
    xb, yb, _, _ = cs.mnv3_batches(cs.MNV3_TRAIN_BATCH, steps=1)[0]
    train_readings(base, imagenet_batch(xb, False, "CIFAR10"), yb, args,
                   f"{args.kan_conv} MobileNetV3-small, batch "
                   f"{cs.MNV3_TRAIN_BATCH}")


def train_readings(base, x, yb, args, label):
    """One train-mode forward and backward of ``base`` on x in float32
    against float64: the loss, the worst gradients and running statistics
    and, with ``--trace``, each KAN conv's and BatchNorm's error."""
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
    print(f"{label}, curved terms x {args.curve:g},"
          f" train mode, float32 vs float64: "
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
                   choices=["VGGKAN", "MobileNetV3KAN",
                            "EfficientNetV2KAN", "AlexNetKAN"])
    p.add_argument("--kan_conv", default="ChebyKAN",
                   choices=sorted(set(CONV_KAN_FACTORY) - {"conv"}))
    p.add_argument("--curve", type=float, default=1.0)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--kan_norm_layer", default="InstanceNorm2d",
                   choices=["InstanceNorm2d", "BatchNorm2d"])
    p.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--card", action="store_true",
                   help="EfficientNetV2KAN: also the card's float32 step")
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    if args.model == "MobileNetV3KAN":
        return mnv3(args)
    if args.model == "EfficientNetV2KAN":
        return effv2(args)
    if args.model == "AlexNetKAN":
        return alexnet(args)
    kw = {"expected_feature_shape": (2, 2)} \
        if args.kan_conv in ("ChebyKAN", "WavKAN") else {}
    kw["kan_norm_layer"] = args.kan_norm_layer
    imgs = np.random.RandomState(0).randint(0, 256, (64, 32, 32, 3),
                                            np.uint8)
    x = normalize_batch(torch.from_numpy(imgs), "CIFAR10")
    for seed in range(args.seeds):
        m = cs.mnv3_smooth(vggkan(
            3, 10, arch="VGG16_small", kan_conv=args.kan_conv,
            classifier_type="Linear", device="cpu",
            generator=torch.Generator().manual_seed(seed), **kw),
            args.curve).eval()
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
    lockstep_readings(cs.mnv3_smooth(cs.train_model(args.kan_conv, **kw),
                                     args.curve), args,
                      f"{args.kan_conv} {args.kan_norm_layer} train model")


def alexnet(args):
    """Path F's AlexNet (small, KAN head) in float32 against float64:
    the eval logits of phase 47 (calibrated), then the train steps of
    phase 49 (module docs)."""
    m = cs.mnv3_calibrate(cs.zoo_model("alexnet_small"), cs.zoo_prep(
        cs.seeded_images(cs.ZOO_CHECK, 46, 32)))
    x = cs.zoo_prep(cs.seeded_images(cs.ZOO_CHECK, 47, 32))
    with torch.no_grad():
        y32 = m(x)
        y64 = copy.deepcopy(m).double()(x.double())
        moved = (m(x * (1 + 1e-7)) - y32).abs().max().item()
    print(f"AlexNet small eval logits float32 vs float64: max |diff| "
          f"{(y32.double() - y64).abs().max().item():.3e}; input x (1 + "
          f"1e-7) moves float32 by {moved:.3e}; max |logit| "
          f"{y64.abs().max().item():.3f}", flush=True)
    cs.TRAIN_BATCH = args.batch
    lockstep_readings(cs.mnv3_smooth(cs.zoo_model("alexnet_small", seed=2),
                                     args.curve), args,
                      "AlexNet small, KAN head")


def lockstep_readings(base, args, label):
    """The train steps of ``chip_smoke.py``'s lockstep phases for
    ``base`` in float32 against float64, with the KAN convs' outputs
    perturbed, and the spread ``chip_smoke.f32_spread`` reads there."""
    batch = cs.train_batches()[:args.steps]
    steps = range(args.steps)
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
            readings = cs.grad_readings(g32, g64, steps)
            slopes = [r for r in readings if r[2].endswith(".prelu")]
            rest = [r for r in readings if not r[2].endswith(".prelu")]
            span = "first step" if args.steps == 1 else \
                f"{args.steps} steps"
            print(f"{label}, batch {args.batch}, {span},"
                  f" conv outputs x (1 + {delta:g} N(0, 1)): gradients vs "
                  f"float64 " + ", ".join(f"{n} step {i} {e:.3e}"
                                          for e, i, n in rest[:3])
                  + ("; PReLU slopes " + ", ".join(
                      f"{n} step {i} {e:.3e}" for e, i, n in slopes[:3])
                     if slopes else ""), flush=True)
    finally:
        nk.kan_conv2d = conv
    # the spread chip_smoke.py's lockstep phases read at these starts
    # (f32_floor), and the limit it sets on the gradients other than the
    # PReLU slopes (path E prints the slopes' readings, not holds them)
    spread = cs.f32_spread(base, batch, starts, steps, None, g64)
    rest = {k: v for k, v in spread.items() if not k[1].endswith(".prelu")}
    top = max(rest.items(), key=lambda kv: kv[1])
    print(f"{label}: float32 spread (chip_smoke.f32_spread, conv "
          f"outputs x (1 + {cs.F32_NOISE:g} N(0, 1)), seeds "
          f"{cs.F32_NOISE_SEEDS}): but the PReLU slopes, max {top[1]:.3e} "
          f"(step {top[0][0]}, {top[0][1]}): gradient limit "
          f"{max(cs.GRAD_TOL, cs.F32_SPREAD * top[1]):.3e}; the slopes' "
          f"max {max([0.0] + [v for k, v in spread.items() if k not in rest]):.3e}",
          flush=True)


if __name__ == "__main__":
    main()
