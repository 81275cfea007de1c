"""Port parity for the slice end to end: convkan_tpu_torch.serve's
InferenceEngine (CPU, buckets (1, 4)) serving VGG16_kansmall, against JAX
normalize_batch + vggkan(...).apply(train=False) on the same uint8 images
and weights (float32, atol 1e-4) — directly, through the dynamic batcher
and over HTTP."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.train.data import normalize_batch as jax_normalize
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.serve import (InferenceEngine, build_engine,
                                     build_parser, make_server)
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax

torch.set_num_threads(1)
SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def served():
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, arch="VGG16_kansmall", kan_conv="KAN",
                    classifier_type="Linear")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE, jnp.float32),
        train=False))
    # the JAX init distributions (kaiming-uniform over the fan-in, PReLU
    # 0.25), drawn with numpy: weights much larger than these make the
    # float32 network itself ill-conditioned (InstanceNorm over the 2x2
    # planes), and JAX float32 then strays from JAX float64 by ~1e-3
    def draw(path, s):
        name = path[-1].key
        if name == "prelu":
            return np.full(s.shape, 0.25, np.float32)
        if name in ("w", "b"):          # Linear(64, 10): torch's default
            bound = 1.0 / np.sqrt(64)
        else:                           # HWIO conv weights
            bound = np.sqrt(3.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    images = rng.randint(0, 256, (3,) + SHAPE, dtype=np.uint8)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, jax_normalize(x, "CIFAR10"), train=False))(variables, images))
    assert want.dtype == np.float32

    model = vggkan(3, 10, arch="VGG16_kansmall", classifier_type="Linear",
                   device="cpu")
    model.load_state_dict(vggkan_state_dict_from_jax(variables), strict=True)
    engine = InferenceEngine(model, "CIFAR10", SHAPE, buckets=(1, 4),
                             batch_timeout_ms=20.0, device="cpu")
    yield engine, images, want
    engine.close()


def test_engine_predict_and_submit_match_jax(served):
    engine, images, want = served
    np.testing.assert_allclose(engine.predict(images), want, atol=1e-4,
                               rtol=0)
    results = [None] * 3

    def worker(i):
        results[i] = engine.submit(images[i], timeout=60)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_allclose(np.stack(results), want, atol=1e-4, rtol=0)


def test_http_predict_and_metrics(served):
    engine, images, want = served
    server = make_server(engine, "VGGKAN_Linear_KAN_VGG16_kansmall",
                         "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for batch in (images[:1], images):
            req = urllib.request.Request(
                url + "/predict",
                data=json.dumps({"instances": batch.tolist()}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            assert body["batch"] == len(batch)
            np.testing.assert_allclose(np.array(body["predictions"]),
                                       want[:len(batch)], atol=1e-4, rtol=0)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        assert metrics["requests"] >= 2 and metrics["device_batches"] >= 2
        assert metrics["device_step_ms"]["n"] == metrics["device_batches"]
        bad = urllib.request.Request(url + "/predict",
                                     data=b'{"instances": [[1, 2]]}')
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_cli_builds_seeded_engine_and_refuses_checkpoints():
    args = build_parser().parse_args(
        ["--arch", "VGG16_kansmall", "--dataset", "CIFAR10", "--init_random",
         "--device", "cpu", "--buckets", "2", "--seed", "5"])
    engine, name = build_engine(args)
    try:
        assert name == "VGGKAN_Linear_KAN_VGG16_kansmall"
        assert engine.buckets == (2,)
        out = engine.predict(np.zeros((1,) + SHAPE, np.uint8))
        assert out.shape == (1, 10) and np.isfinite(out).all()
    finally:
        engine.close()
    with pytest.raises(SystemExit):
        build_engine(build_parser().parse_args(["--device", "cpu"]))
