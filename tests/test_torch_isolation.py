"""The port stands alone: nothing under convkan_tpu_torch/ and nothing in
chip_smoke.py imports jax, flax or the JAX package convkan_tpu (the
port's own convkan_tpu_torch is allowed), and importing the serving entry
point leaves jax out of sys.modules."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "convkan_tpu"}
PORT_FILES = sorted((ROOT / "convkan_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import convkan_tpu_torch.serve, sys; "
         "assert 'jax' not in sys.modules, 'jax was imported'; "
         "assert not any(m == 'convkan_tpu' or m.startswith('convkan_tpu.') "
         "for m in sys.modules), 'convkan_tpu was imported'"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
