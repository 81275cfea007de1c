"""Inference server for convkan_tpu_torch models, port of
``convkan_tpu/serve.py`` (engine, HTTP surface, ``--init_random`` CLI).

  * **shape buckets, warmed at startup**: batches are padded up to a fixed
    set of bucket sizes, each run once when the engine starts (this also
    builds the CUDA kernels), so a request never waits for a first launch;
  * **dynamic batching**: concurrent single-image requests are coalesced
    (up to the largest bucket, waiting at most ``batch_timeout_ms``) into
    one device step;
  * **uint8 ingress**: clients send raw image arrays; dataset normalization
    runs on the device.

CLI (serves freshly initialized weights from ``--seed``; restoring a
checkpoint is not ported yet), with train.py's flags and defaults
(``--model FlexibleAlexNet``, ``--dataset MNIST``):

    python -m convkan_tpu_torch.serve --model AlexNetKAN --arch small \\
        --dataset CIFAR10 --classifier_type KAN --init_random --port 8421
    python -m convkan_tpu_torch.serve --model VGGKAN --arch VGG16_small \\
        --dataset CIFAR10 --init_random [--fold_bn]
    python -m convkan_tpu_torch.serve --model MobileNetV3KAN --arch small \\
        --imagenet_preprocessing --kan_conv FastKAN --init_random
    python -m convkan_tpu_torch.serve --model EfficientNetV2KAN --arch s \\
        --imagenet_preprocessing --kan_conv FastKAN --init_random

``--model`` takes every train.py model but the two ``parallel/`` MLPs:
``FlexibleAlexNet`` (= ``AlexNetKAN``, ``--arch`` default or small),
``VGGKAN`` (a cfgs key, VGG16 by default), ``MobileNetV1KAN``,
``MobileNetV2KAN`` (default, small, kan_small), ``MobileNetV3KAN`` (small
or large), ``EfficientNetV2KAN`` (s, m, l, tiny, kan_tiny) and
``EfficientNetKAN`` (b0 .. b2, b0_small .. b2_small).  ``build_engine``
wires each flag as train.py's ``build_model`` does: ``--kan_conv`` (any
key of the conv factory; ``--degree``, ``--grid_size``,
``--spline_order``, ``--groups``), ``--conv_type``, ``--norm_layer``,
``--kan_norm_layer``, ``--norm_affine``, ``--width_scale``,
``--replace_depthwise`` and the head: ``--classifier_type`` (Linear, KAN,
HiddenKAN, VGGKAN, VGG, ...), ``--kan_classifier`` (any key of
``MLP_KAN_FACTORY``) and the ``--classifier_*`` overrides.  A VGG's head
pools to 7 x 7 with ``--imagenet_preprocessing``, else to 1 x 1.  An
argv whose model cannot take the input (train.py's default, the
``default`` AlexNet at MNIST's 28 x 28) is refused before anything runs,
as the JAX CLI fails on it.  train.py's dropout and stochastic depth
flags are accepted and do nothing: serving runs in eval mode.
``--imagenet_preprocessing`` serves 224 x 224 x 3 images with the
dataset's normalization, as the JAX CLI does; the engine does not resize.
The norms are served in eval mode from their running statistics;
``--fold_bn`` folds each KAN conv's BatchNorm into its weights
(utils/fold_bn.py, with ``--bn_eps``) before serving, and is refused for
a model with standard convs whose norms it does not fold yet (the
EfficientNets; MobileNetV1/V2 with standard depthwise convs; any
``--conv_type conv``).

Endpoints: POST /predict  {"instances": [...uint8 HWC arrays...]}
           -> {"predictions": [[per-class logits]...], "batch": n}
           GET  /healthz   -> {"ok": true, "model": "...", "buckets": [...]}
           GET  /metrics   -> request/instance/device-batch counters +
                              device-step latency p50/p95/p99
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np
import torch

from .device import resolve_device
from .factory.conv_factory import CONV_KAN_FACTORY
from .factory.mlp_factory import MLP_KAN_FACTORY
from .train.data import input_shape as dataset_input_shape
from .train.data import normalize_batch
from .utils.fold_bn import fold_batch_norms
from .utils.norms import NORM_LAYERS


class InferenceEngine:
    """Bucketed, dynamically batched forward of a channel-last model.

        eng = InferenceEngine(model, dataset, input_shape)   # on cuda
        logits = eng.predict(batch_uint8)     # direct, padded to a bucket
        logits = eng.submit(one_uint8_image)  # through the batching queue

    ``device=None`` means the GPU and raises on a host without one;
    ``device="cpu"`` runs the plain PyTorch path."""

    def __init__(self, model: torch.nn.Module, dataset: str,
                 input_shape: Sequence[int],
                 buckets: Sequence[int] = (1, 8, 64),
                 batch_timeout_ms: float = 2.0, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset = dataset
        self.input_shape = tuple(input_shape)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_batch = self.buckets[-1]
        self.batch_timeout_s = batch_timeout_ms / 1e3

        for b in self.buckets:
            self._fwd(np.zeros((b,) + self.input_shape, np.uint8))

        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "instances": 0, "device_batches": 0}
        self._latencies_ms: "collections.deque" = collections.deque(
            maxlen=1024)

        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self._worker.start()

    def _fwd(self, x_uint8: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(x_uint8).to(self.device)
            out = self.model(normalize_batch(x, self.dataset))
            return out.to(torch.float32).cpu().numpy()

    # ---------------------------------------------------------- direct path
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, x_uint8: np.ndarray) -> np.ndarray:
        """Run a whole batch now (padding to the enclosing bucket; batches
        beyond the largest bucket run in largest-bucket chunks)."""
        x = np.asarray(x_uint8, np.uint8)
        if len(x) == 0:
            raise ValueError("empty batch")
        if x.shape[1:] != self.input_shape:
            raise ValueError(
                f"instance shape {x.shape[1:]} != expected "
                f"{self.input_shape} for dataset {self.dataset}")
        outs = []
        cap = self.buckets[-1]
        for i in range(0, len(x), cap):
            chunk = x[i:i + cap]
            n = len(chunk)
            b = self._bucket_for(n)
            if n < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - n,) + self.input_shape, np.uint8)])
            t0 = time.perf_counter()
            outs.append(self._fwd(chunk)[:n])  # .cpu() waits for the device
            ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self._stats["instances"] += n
                self._stats["device_batches"] += 1
                self._latencies_ms.append(ms)
        return np.concatenate(outs)

    def count_request(self):
        with self._stats_lock:
            self._stats["requests"] += 1

    def metrics(self) -> dict:
        """Counters + device-step latency percentiles (last 1024 steps)."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            out = dict(self._stats)
        if lat:
            # nearest-rank percentile: ceil(q*n)-1
            def pct(q):
                return round(lat[max(0, math.ceil(q * len(lat)) - 1)], 3)

            out["device_step_ms"] = {"p50": pct(0.50), "p95": pct(0.95),
                                     "p99": pct(0.99), "n": len(lat)}
        return out

    # ------------------------------------------------------- batched path
    def submit(self, instance: np.ndarray, timeout: float = 30.0):
        """Enqueue ONE instance; blocks until its result is ready.  Called
        from many request threads at once — the worker coalesces whatever
        is queued into a single device step."""
        if self._stop.is_set():
            raise RuntimeError("engine closed")
        instance = np.asarray(instance, np.uint8)
        if instance.shape != self.input_shape:
            # validated here so one malformed instance cannot poison the
            # coalesced batch of other callers' requests
            raise ValueError(
                f"instance shape {instance.shape} != expected "
                f"{self.input_shape} for dataset {self.dataset}")
        box = {"event": threading.Event()}
        self._queue.put((instance, box))
        if self._stop.is_set() and not box["event"].wait(0.1):
            # close() raced our enqueue and its drain may have missed it
            raise RuntimeError("engine closed")
        if not box["event"].wait(timeout):
            # the worker sheds abandoned instances instead of computing them
            box["abandoned"] = True
            raise TimeoutError("inference timed out")
        if "error" in box:
            raise RuntimeError(box["error"])
        return box["result"]

    def _batch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.batch_timeout_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = [b for b in batch if not b[1].get("abandoned")]
            if not batch:
                continue
            boxes = [b[1] for b in batch]
            try:
                preds = self.predict(np.stack([b[0] for b in batch]))
                for box, row in zip(boxes, preds):
                    box["result"] = row
            except Exception as e:  # surface to every waiter, keep serving
                for box in boxes:
                    box["error"] = f"{type(e).__name__}: {e}"
            for box in boxes:
                box["event"].set()

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2.0)
        # fail queued submit() callers now instead of at their timeout
        while True:
            try:
                _, box = self._queue.get_nowait()
            except queue.Empty:
                break
            box["error"] = "engine closed"
            box["event"].set()


# ------------------------------------------------------------------ HTTP
def _make_handler(engine: InferenceEngine, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "model": model_name,
                                 "dataset": engine.dataset,
                                 "input_shape": list(engine.input_shape),
                                 "buckets": list(engine.buckets)})
            elif self.path == "/metrics":
                self._send(200, engine.metrics())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            engine.count_request()
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                instances = np.asarray(req["instances"], np.uint8)
                if instances.shape[1:] != engine.input_shape:
                    raise ValueError(
                        f"instance shape {instances.shape[1:]} != "
                        f"{engine.input_shape}")
                t0 = time.perf_counter()
                if len(instances) == 1:
                    # single request: ride the dynamic batcher so
                    # concurrent clients share one device step
                    preds = engine.submit(instances[0])[None]
                else:
                    preds = engine.predict(instances)
                ms = (time.perf_counter() - t0) * 1e3
                self._send(200, {"predictions": preds.tolist(),
                                 "batch": len(instances),
                                 "latency_ms": round(ms, 3)})
            except (ValueError, KeyError, TypeError, OverflowError,
                    json.JSONDecodeError) as e:
                # OverflowError: numpy raises it for out-of-uint8-range ints
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # server-side fault (device error, timeout): 5xx
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the default listen backlog of 5 resets bursts of concurrent clients
    request_queue_size = 128
    daemon_threads = True


def make_server(engine: InferenceEngine, model_name: str, host: str,
                port: int) -> ThreadingHTTPServer:
    return _Server((host, port), _make_handler(engine, model_name))


# train.py's flags that act only in training (dropout, stochastic depth)
TRAIN_ONLY = ("--dropout_conv", "--dropout_linear", "--stochastic_depth_prob")
# train.py's --classifier_base_activation choices (train.py:22-23)
ACT_CHOICES = ["gelu", "silu", "relu", "leakyrelu", "prelu", "tanh",
               "sigmoid", "hardswish", "None"]
MODELS = ["FlexibleAlexNet", "AlexNetKAN", "VGGKAN", "MobileNetV1KAN",
          "MobileNetV2KAN", "MobileNetV3KAN", "EfficientNetV2KAN",
          "EfficientNetKAN"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve a convkan_tpu_torch model over HTTP.")
    p.add_argument("--model", default="FlexibleAlexNet", choices=MODELS,
                   help="train.py's model (FlexibleAlexNet = AlexNetKAN)")
    p.add_argument("--arch", default=None,
                   help="AlexNetKAN: default or small; VGGKAN: a cfgs key "
                        "(VGG16 by default); MobileNetV2KAN: default, small "
                        "or kan_small; MobileNetV3KAN: small or large; "
                        "EfficientNetV2KAN: s, m, l, tiny or kan_tiny; "
                        "EfficientNetKAN: b0 (by default), b1, b2, b0_small "
                        ".. b2_small")
    p.add_argument("--kan_conv", default="KAN",
                   choices=sorted(CONV_KAN_FACTORY),
                   help="conv family of the trunk (train.py's flag)")
    p.add_argument("--conv_type", default="kanconv",
                   choices=["kanconv", "conv"],
                   help="KAN convs or standard ones (not VGGKAN)")
    p.add_argument("--width_scale", type=float, default=1)
    p.add_argument("--replace_depthwise", action="store_true",
                   help="the MobileNets and the EfficientNets: grouped KAN "
                        "depthwise convs")
    for flag in TRAIN_ONLY:
        p.add_argument(flag, type=float, default=None,
                       help="train.py's flag, accepted and ignored: serving "
                            "runs in eval mode, where it does nothing")
    p.add_argument("--imagenet_preprocessing", action="store_true",
                   help="224 x 224 x 3 inputs (train.py's flag)")
    p.add_argument("--norm_layer", default="BatchNorm2d",
                   choices=sorted(NORM_LAYERS),
                   help="the norm of standard convs, and of every conv of "
                        "the MobileNets and the EfficientNets (train.py's "
                        "flag)")
    p.add_argument("--kan_norm_layer", default="BatchNorm2d",
                   choices=sorted(NORM_LAYERS),
                   help="norm after each KAN conv of VGGKAN and AlexNetKAN "
                        "(train.py's flag)")
    p.add_argument("--norm_affine", action="store_true",
                   help="train.py's flag; as there, it does not reach the "
                        "norms of a VGGKAN's KAN convs")
    p.add_argument("--degree", type=int, default=3,
                   help="polynomial degree of the polynomial families' "
                        "convs (train.py does not pass it to the "
                        "EfficientNets)")
    p.add_argument("--grid_size", type=int, default=5,
                   help="the B-spline's grid (the Fourier convs' "
                        "frequencies)")
    p.add_argument("--spline_order", type=int, default=3)
    p.add_argument("--groups", type=int, default=1,
                   help="groups of the KAN convs (train.py's flag)")
    p.add_argument("--classifier_type", default="Linear",
                   help="the head: Linear, KAN, HiddenKAN, VGGKAN, VGG, ... "
                        "(train.py's flag; which a model takes is its own)")
    p.add_argument("--kan_classifier", default="KAN",
                   choices=sorted(MLP_KAN_FACTORY),
                   help="the KAN head's family (train.py's flag)")
    p.add_argument("--classifier_dropout", type=float, default=None)
    p.add_argument("--classifier_grid_size", type=int, default=None)
    p.add_argument("--classifier_spline_order", type=int, default=None)
    p.add_argument("--classifier_l1_decay", type=float, default=None)
    p.add_argument("--classifier_degree", type=int, default=None)
    p.add_argument("--classifier_base_activation", default="None",
                   choices=ACT_CHOICES)
    p.add_argument("--fold_bn", action="store_true",
                   help="fold each KAN conv's BatchNorm into its weights "
                        "before serving (utils/fold_bn.py)")
    p.add_argument("--bn_eps", type=float, default=1e-5)
    p.add_argument("--dataset", default="MNIST",
                   choices=["MNIST", "SVHN", "CIFAR10", "CIFAR100"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--init_random", action="store_true",
                   help="serve freshly initialized weights from --seed "
                        "(restoring a checkpoint is not ported yet)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (raises without a GPU)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8421)
    p.add_argument("--buckets", default="1,8,64",
                   help="comma-separated batch buckets, warmed at startup")
    p.add_argument("--batch_timeout_ms", type=float, default=2.0)
    return p


def build_model(args, shape, num_classes: int, generator=None):
    """The model of train.py's ``build_model`` (train.py:207-351) for the
    parsed flags and the input ``shape``, its weights from ``generator``
    onto ``args.device``; SystemExit where train.py exits or the model
    cannot take the input."""
    from .models.alexnet import alexnet_kan, feature_sizes
    from .models.efficientnet import efficientnet_kan, efficientnet_kan_small
    from .models.efficientnetv2 import (efficientnetv2_kan,
                                        efficientnetv2_kan_small)
    from .models.mobilenet import mobilenet_v1_kan
    from .models.mobilenetv2 import mobilenet_v2_kan
    from .models.mobilenetv3 import mobilenet_v3_kan
    from .models.vgg import vggkan

    make = {"generator": generator, "device": args.device}
    head = dict(
        classifier_type=args.classifier_type,
        classifier_spline_order=args.classifier_spline_order,
        classifier_grid_size=args.classifier_grid_size,
        classifier_dropout=args.classifier_dropout,
        classifier_l1_decay=args.classifier_l1_decay,
        classifier_degree=args.classifier_degree,
        classifier_base_activation=(
            None if args.classifier_base_activation == "None"
            else args.classifier_base_activation))
    kan_conv = args.kan_conv if args.conv_type == "kanconv" else None
    # the flags every model of train.py takes alike
    common = dict(conv_type=args.conv_type, norm_layer=args.norm_layer,
                  kan_norm_layer=args.kan_norm_layer,
                  affine=args.norm_affine, groups=args.groups,
                  grid_size=args.grid_size, spline_order=args.spline_order,
                  **head, **make)
    if args.model == "VGGKAN":
        return vggkan(
            shape[-1], num_classes, kan_conv=kan_conv,
            kan_classifier=(args.kan_classifier if args.classifier_type in
                            ("VGGKAN", "KAN", "HiddenKAN") else None),
            arch=args.arch or "VGG16",
            expected_feature_shape=(7, 7) if args.imagenet_preprocessing
            else (1, 1), width_scale=args.width_scale, degree=args.degree,
            **common)
    if args.model in ("FlexibleAlexNet", "AlexNetKAN"):
        try:
            feature_sizes(args.arch or "default", shape[0], shape[1])
        except ValueError as e:
            raise SystemExit(f"--model {args.model} --dataset {args.dataset}"
                             f": {e}") from None
        return alexnet_kan(
            num_classes=num_classes, input_channels=shape[-1],
            arch=args.arch or "default", kan_conv=kan_conv,
            kan_classifier=args.kan_classifier, degree=args.degree,
            **common)
    mobile = dict(num_classes=num_classes, input_channels=shape[-1],
                  width_mult=args.width_scale, kan_conv=args.kan_conv,
                  replace_depthwise=args.replace_depthwise,
                  kan_classifier=args.kan_classifier, degree=args.degree,
                  **common)
    if args.model == "MobileNetV1KAN":
        return mobilenet_v1_kan(**mobile)
    if args.model == "MobileNetV2KAN":
        return mobilenet_v2_kan(arch=args.arch or "default", **mobile)
    if args.model == "MobileNetV3KAN":
        if args.arch not in ("large", "small"):
            raise SystemExit("MobileNetV3 requires --arch large|small")
        return mobilenet_v3_kan(args.arch, **mobile)
    v2 = args.model == "EfficientNetV2KAN"
    if v2 and args.arch not in ("s", "m", "l", "tiny", "kan_tiny"):
        raise SystemExit(f"Unsupported EfficientNetV2 arch: {args.arch}")
    if v2:
        fn = efficientnetv2_kan_small if args.arch in (
            "tiny", "kan_tiny") else efficientnetv2_kan
    else:
        fn = efficientnet_kan_small if args.arch and "small" in args.arch \
            else efficientnet_kan
    # train.py's builder call (train.py:321-351): no degree, no groups
    del common["groups"]
    return fn(arch=args.arch or "b0", num_classes=num_classes,
              in_channels=shape[-1], kan_conv=args.kan_conv,
              replace_depthwise=args.replace_depthwise,
              kan_classifier=args.kan_classifier, **common)


def _has_unfolded_norms(args) -> bool:
    """Whether the model has standard convs, whose norms --fold_bn does
    not fold yet (ROADMAP A9)."""
    return args.model in ("EfficientNetV2KAN", "EfficientNetKAN") or \
        args.conv_type == "conv" or (
            args.model in ("MobileNetV1KAN", "MobileNetV2KAN") and
            not args.replace_depthwise)


def build_engine(args):
    """Model + weights + engine from parsed CLI args (the testable core of
    main).  Returns (engine, model name)."""
    if not args.init_random:
        raise SystemExit("restoring a checkpoint is not ported yet; pass "
                         "--init_random to serve seeded random weights")
    # train.py's input shapes (migrate.py:59-65 of the JAX package)
    shape = (224, 224, 3) if args.imagenet_preprocessing else \
        dataset_input_shape(args.dataset)
    num_classes = 100 if args.dataset == "CIFAR100" else 10
    if args.fold_bn and _has_unfolded_norms(args):
        raise SystemExit("--fold_bn does not fold the standard convs' "
                         f"norms of {args.model} yet (ROADMAP A9)")
    model = build_model(args, shape, num_classes,
                        torch.Generator().manual_seed(args.seed))
    if args.fold_bn:
        print(f"folded {fold_batch_norms(model, eps=args.bn_eps)} "
              "BatchNorms", flush=True)
    engine = InferenceEngine(
        model, args.dataset, shape,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        batch_timeout_ms=args.batch_timeout_ms, device=args.device)
    return engine, model.model_name


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, name = build_engine(args)
    server = make_server(engine, name, args.host, args.port)
    print(f"serving {name} ({args.dataset}, buckets {engine.buckets}) on "
          f"http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
