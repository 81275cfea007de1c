"""Build and load the port's CUDA sources (``convkan_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library is built
at first use into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  ``--use_fast_math`` is
deliberately absent: the B-spline recurrence needs IEEE divides, and the
wavelets the accurate expf/sinf/cosf.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source on top of NVCC_FLAGS: the WavKAN backward, the longest
# build (its 57 kernels: 262 s alone on the H100 host, the other three
# sources 118 s at most, built beside it), optimizes in four threads: 106 s
# beside the others (two threads: 161-191 s), every kernel's SASS identical
# to the single-threaded build's
SOURCE_FLAGS = {"wav_conv2d_bwd.cu": ["-split-compile=4"]}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` when CUDA_HOME is set (or
    known to torch), else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives (the name hashes
    the source, the headers of ``csrc/`` it may include, and the flags)."""
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / source]
                   + sorted(CSRC_DIR.glob("*.cuh")))
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, [])
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists.  The compiler's
    report (registers, shared memory, spills) goes to a ``.log`` beside
    the library."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *SOURCE_FLAGS.get(source, []), "-o",
           str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
