"""GPU smoke test of convkan_tpu_torch: serves KAN-VGG16_small on one CUDA
card through the hand-written KAN-conv kernel and checks every step.

    python3 chip_smoke.py

Phases (the first failed check exits non-zero):
  1. setup: the card's name and power limit, TF32 off, the kernel built
     from csrc/ (build time and the compiler's register/spill report);
  2. kernel vs its plain PyTorch version on the card, at the 9 distinct
     VGG16_small conv shapes (batch 64), a batch-1 case, an input scaled
     to +-3 with exact knot values, and a GELU case (rtol = atol = 1e-4:
     float32 sums of up to 10,368 products taken in another order);
  3. the model: VGG16_small with seeded weights on the card against the
     same state_dict on the CPU (logits within 1e-3), 13 launches per
     forward;
  4. serving, the main path: launch counts are zeroed, an InferenceEngine
     with buckets (1, 8, 64) starts, the HTTP server answers 8 concurrent
     clients x 4 single-image requests and one 64-image request, the
     answers are checked against engine.predict, and the counts are read;
  5. times with CUDA events: predict at batch 1024 (images/s) and, per conv
     shape at batch 1024, the kernel, its plain version, one cuDNN conv over
     a materialized basis (a yardstick the port never calls) and the bound.

Prints a {"kernels": [...]} line, then the contract line
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
TOL = 1e-4                  # kernel vs plain version, float32
MODEL_TOL = 1e-3            # 13 layers of float32 GPU vs CPU
# (H, C, O) of the VGG16_small convs in order; 13 layers, 9 distinct shapes
VGG16_SMALL_CONVS = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
                     (8, 32, 64), (8, 64, 64), (8, 64, 64), (4, 64, 128),
                     (4, 128, 128), (4, 128, 128), (2, 128, 128),
                     (2, 128, 128), (2, 128, 128)]
REPLACES = "convkan_tpu/kernels/wide_kan_conv.py:300"
ALSO_REPLACES = "convkan_tpu/kernels/fused_kan_conv.py:167"


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def conv_inputs(gen, B, H, C, O, scale=1.0):
    x = (torch.rand(B, H, H, C, generator=gen) * 2 - 1) * scale
    bw = torch.randn(3, 3, C, O, generator=gen) * 0.1
    pw = torch.randn(3, 3, C * 8, O, generator=gen) * 0.1
    return x, bw, pw


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    from convkan_tpu_torch.basis.bspline import (
        bspline_basis_unrolled_list, make_bspline_grid)
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import build
    from convkan_tpu_torch.kernels import kan_conv2d as kc
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.serve import InferenceEngine, make_server
    from convkan_tpu_torch.train.data import normalize_batch

    t_start = time.perf_counter()
    # ---------------------------------------------------------- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    set_full_f32()
    lib = build.library_path(kc.SOURCE)
    lib.unlink(missing_ok=True)  # build from the checkout's sources
    t0 = time.perf_counter()
    build.build(kc.SOURCE)
    print(f"[build] {kc.SOURCE}: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    dev = torch.device("cuda")
    knots = tuple(float(v) for v in make_bspline_grid(5, 3))
    gen = torch.Generator().manual_seed(0)

    # ------------------------------------------ 2. kernel vs plain version
    cases = [(64, H, C, O, 1.0, "silu")
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(1, 32, 16, 16, 1.0, "silu"), (8, 8, 32, 64, 3.0, "silu"),
              (8, 16, 16, 32, 3.0, "gelu")]
    max_err = 0.0
    for B, H, C, O, scale, act in cases:
        x, bw, pw = conv_inputs(gen, B, H, C, O, scale)
        if scale > 1:  # exact knots and out-of-grid values occur
            flat = x.view(-1)
            flat[: 4 * len(knots)] = torch.tensor(knots).repeat(4)
        x, bw, pw = x.to(dev), bw.to(dev), pw.to(dev)
        y = kc.kan_conv2d(x, bw, pw, knots, 3, 3, 1, act)
        torch.cuda.synchronize()
        ref = kc.kan_conv2d_reference(x, bw, pw, knots, 3, 3, 1, act)
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
        print(f"[kernel] B={B} {H}x{H} C={C} O={O} x*{scale} {act}: "
              f"max|err| {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(bool(torch.isfinite(y).all()), "kernel output not finite")
        check(ok, f"kernel disagrees with the plain version (B={B} H={H} "
                  f"C={C} O={O} {act})")
        max_err = max(max_err, err)

    # ---------------------------------------------------------- 3. model
    model_cpu = vggkan(3, 10, arch="VGG16_small", classifier_type="Linear",
                       generator=torch.Generator().manual_seed(0),
                       device="cpu").eval()
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    imgs = np.random.RandomState(0).randint(0, 256, (64, 32, 32, 3), np.uint8)
    with torch.inference_mode():
        want = model_cpu(normalize_batch(torch.from_numpy(imgs), "CIFAR10"))
        kc.reset_launches()
        got = model_gpu(normalize_batch(torch.from_numpy(imgs).to(dev),
                                        "CIFAR10")).cpu()
        torch.cuda.synchronize()
    n_launch = kc.launches
    err = (got - want).abs().max().item()
    print(f"[model] VGG16_small logits {tuple(got.shape)} GPU vs CPU max|err| "
          f"{err:.3e}; kernel launches per forward {n_launch}", flush=True)
    check(bool(torch.isfinite(got).all()), "model logits not finite")
    check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
          "model logits on the GPU disagree with the CPU")
    check(n_launch == 13, f"expected 13 kernel launches, got {n_launch}")

    # ------------------------------------------- 4. serving (main path)
    kc.reset_launches()
    engine = InferenceEngine(
        vggkan(3, 10, arch="VGG16_small", classifier_type="Linear",
               generator=torch.Generator().manual_seed(1), device="cuda"),
        "CIFAR10", (32, 32, 3), buckets=(1, 8, 64), batch_timeout_ms=5.0,
        device="cuda")
    server = make_server(engine, "VGGKAN_Linear_KAN_VGG16_small",
                         "127.0.0.1", 0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(batch):
        req = urllib.request.Request(
            url + "/predict", data=json.dumps(
                {"instances": batch.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    req_imgs = np.random.RandomState(2).randint(0, 256, (32, 32, 32, 3),
                                                np.uint8)
    answers: dict = {}
    errors: list = []

    def client(c):
        try:
            for r in range(4):
                i = c * 4 + r
                answers[i] = post(req_imgs[i:i + 1])
        except Exception as e:  # collected and reported below
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    try:
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in clients), "HTTP clients hung")
        check(not errors, f"HTTP errors: {errors}")
        check(len(answers) == 32, f"{len(answers)} of 32 answers")
        big = post(imgs)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        n_main = kc.launches
    finally:
        server.shutdown()
        server.server_close()
        srv_thread.join(timeout=10)
        engine.close()
    direct = engine.predict(req_imgs)
    single = np.array([answers[i]["predictions"][0] for i in range(32)])
    serr = float(np.abs(single - direct).max())
    berr = float(np.abs(np.array(big["predictions"])
                        - engine.predict(imgs)).max())
    print(f"[serve] 32 single-image requests from 8 clients, max|err| vs "
          f"predict {serr:.3e}; 64-image request max|err| {berr:.3e}",
          flush=True)
    print(f"[serve] /metrics {json.dumps(metrics)}", flush=True)
    print(f"[serve] kernel launches on the main path: {n_main}", flush=True)
    check(serr <= TOL and berr <= TOL, "served logits disagree with predict")
    check(big["batch"] == 64 and metrics["requests"] == 33,
          "server counted the wrong requests")
    steps = metrics["device_batches"] + len(engine.buckets)  # + warm-up
    check(n_main == 13 * steps, f"{n_main} launches for {steps} forwards")

    # ---------------------------------------------------------- 5. times
    bench = InferenceEngine(model_gpu, "CIFAR10", (32, 32, 3),
                            buckets=(1024,), device="cuda")
    try:
        x1024 = np.random.RandomState(3).randint(0, 256, (1024, 32, 32, 3),
                                                 np.uint8)
        runs = []
        for _ in range(10):
            t0 = time.perf_counter()
            bench.predict(x1024)  # returns host numpy: the device is done
            runs.append(1024 / (time.perf_counter() - t0))
    finally:
        bench.close()
    print(f"[time] predict batch 1024: median {statistics.median(runs):.1f} "
          f"images/s over {len(runs)} runs "
          f"(min {min(runs):.1f}, max {max(runs):.1f}) on {card}", flush=True)

    shapes = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "op_ms": 0.0, "byte_ms": 0.0}
    for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS):
        B, K = 1024, 8
        x, bw, pw = (t.to(dev) for t in conv_inputs(gen, B, H, C, O))
        k_ms = cuda_ms(lambda: kc.kan_conv2d(x, bw, pw, knots, 3, 3, 1,
                                             "silu"))
        p_ms = cuda_ms(lambda: kc.kan_conv2d_reference(
            x, bw, pw, knots, 3, 3, 1, "silu"), iters=5, warmup=1)
        E = torch.cat(bspline_basis_unrolled_list(x, knots, 3)
                      + [torch.nn.functional.silu(x)], -1)
        E = E.permute(0, 3, 1, 2).contiguous()
        w = kc.pack_w_all(bw, pw, C=C, K=K, k=3, O=O)
        w = w.reshape((K + 1) * C, 3, 3, O).permute(3, 0, 1, 2).contiguous()
        l_ms = cuda_ms(lambda: torch.nn.functional.conv2d(E, w, padding=1))
        del E
        flops = 2 * B * H * H * 9 * (K + 1) * C * O
        nbytes = 4 * (x.numel() + bw.numel() + pw.numel() + B * H * H * O)
        op_ms = flops / PEAK_FP32_FLOPS * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(op_ms, byte_ms)
        n = VGG16_SMALL_CONVS.count((H, C, O))
        row = {"H": H, "C": C, "O": O, "batch": B, "layers": n,
               "kernel_ms": round(k_ms, 4), "plain_ms": round(p_ms, 4),
               "library_ms": round(l_ms, 4), "bound_ms": round(bound_ms, 4),
               "gflops": round(flops / 1e9, 3),
               "tflops": round(flops / k_ms / 1e9, 2)}
        shapes.append(row)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                       ("bound_ms", bound_ms), ("library_ms", l_ms),
                       ("op_ms", op_ms), ("byte_ms", byte_ms)):
            totals[key] += n * v
        print(f"[time] {json.dumps(row)}", flush=True)
    print(f"[time] per forward of the 13 convs at batch 1024: kernel "
          f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, cuDNN "
          f"over materialized E {totals['library_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms (on {card})", flush=True)
    print(f"[time] total {time.perf_counter() - t_start:.1f} s", flush=True)

    bound_by = "operations" if totals["op_ms"] >= totals["byte_ms"] \
        else "bytes"
    print(json.dumps({"kernels": [{
        "name": "kan_conv2d_fwd", "route": "cuda",
        "source": "convkan_tpu_torch/csrc/kan_conv2d_fwd.cu",
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": n_main, "max_abs_err": max_err,
        "ms": round(totals["ms"], 4), "plain_ms": round(totals["plain_ms"], 4),
        "bound_ms": round(totals["bound_ms"], 4), "bound_by": bound_by,
        "library_ms": round(totals["library_ms"], 4),
        "times_are": "sum over the 13 VGG16_small convs at batch 1024",
        "shapes": shapes}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
