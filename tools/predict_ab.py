"""Serving throughput of one checkout of the port: ``InferenceEngine.predict``
at batch 1024 of the seeded VGG16_small, timed as ``chip_smoke.py``'s
``time_predict`` times it (median images/s of 10 calls, each ending in a
copy of the logits to the host; min and max beside).  Run on the GPU
machine from the repository root, once per tree, alternating:

    python3 tools/predict_ab.py --tree build/ab/parent --label parent
    python3 tools/predict_ab.py --label new

``--tree`` is the root of the checkout whose ``convkan_tpu_torch`` serves
(default: this one); ``--kan_conv`` the conv families to time (default
KAN and WavKAN: the families every tree since PR 3 carries; ChebyKAN needs
a tree from PR 14 on).  The model is phase 3's (seed 0; the (2, 2) head
for WavKAN and ChebyKAN); the tree's kernels are built first, one nvcc per
source in parallel.  Prints one JSON line per family and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--kan_conv", nargs="+", default=["KAN", "WavKAN"],
                    choices=["KAN", "WavKAN", "ChebyKAN"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import build, kan_conv2d, wav_conv2d
    from convkan_tpu_torch.models.vgg import vggkan

    set_full_f32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sources = (kan_conv2d.SOURCE, wav_conv2d.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for kan_conv in args.kan_conv:
        kw = {} if kan_conv == "KAN" else {"expected_feature_shape": (2, 2)}
        model = vggkan(3, 10, arch="VGG16_small", kan_conv=kan_conv,
                       classifier_type="Linear",
                       generator=torch.Generator().manual_seed(0),
                       device="cuda", **kw).eval()
        ips = smoke.time_predict(model, kan_conv, card)
        print(json.dumps({"label": args.label, "kan_conv": kan_conv,
                          "tree": str(Path(args.tree).resolve()),
                          "predict_images_per_s": round(ips, 1),
                          "card": card}), flush=True)
        del model


if __name__ == "__main__":
    main()
