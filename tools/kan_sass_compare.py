"""Compare the machine code (SASS) of the KAN-conv kernels of two checkouts
of the port, kernel instantiation by kernel instantiation.

    python3 tools/kan_sass_compare.py --tree build/ab/parent

builds ``csrc/kan_conv2d_fwd.cu`` and ``csrc/kan_conv2d_bwd.cu`` of this
checkout and of ``--tree`` with ``kernels/build.py``'s nvcc flags (four
compilers in parallel, into a temporary directory), disassembles each with
``cuobjdump -sass`` and, for every kernel instantiation (keyed by its
kernel name, basis and template integers, so that ``<12, 3, 0, 16>`` of a
tree without basis policies matches ``<BSpline<12, 3, 0>, 16>``), prints
both instruction counts and whether the instruction text (opcodes, operands
and branch targets, without the encodings) is identical (``--diff N``: and
the first N instructions that differ).  Needs the CUDA toolkit (nvcc,
cuobjdump) and no card.  Exits 1 if an instantiation present in both trees
differs.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SOURCES = ("kan_conv2d_fwd", "kan_conv2d_bwd")


def disassemble(csrc: Path, source: str, out: Path) -> dict:
    """{kernel name: [instruction text]} of ``csrc/<source>.cu``."""
    from convkan_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    lib = out / f"{source}.so"
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
                    str(csrc / f"{source}.cu")], check=True,
                   capture_output=True)
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(re.sub(r"\s+", " ", m.group(1)).strip())
    return funcs


def key(name: str) -> str:
    """kernel, basis and template integers of a mangled kernel name."""
    m = re.search(r"(kan_conv2d_(?:fwd|bwd_dx|bwd_dw)_kernel|ordered_sum_kernel)"
                  r"I(.*)E", name)
    if not m:
        return name
    ints = re.findall(r"L[ib](\d+)E", m.group(2))
    basis = next((b.lower() for b in ("Cheby", "Gram", "Recur3", "Bernstein",
                                      "Fourier") if b in name), "bspline")
    if m.group(1) == "ordered_sum_kernel":
        basis = "-"
    return f"{m.group(1)}[{basis}]<{', '.join(ints)}>"


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", required=True,
                   help="root of the other checkout")
    p.add_argument("--diff", type=int, default=0,
                   help="print the first N differing instructions")
    args = p.parse_args()
    trees = {"this": ROOT, "tree": Path(args.tree).resolve()}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as pool:
        jobs = {}
        for label, root in trees.items():
            for src in SOURCES:
                out = Path(tmp) / label
                out.mkdir(exist_ok=True)
                jobs[label, src] = pool.submit(
                    disassemble, root / "convkan_tpu_torch" / "csrc", src,
                    out)
        code = {label: {} for label in trees}
        for (label, _), job in jobs.items():
            code[label].update({key(k): v for k, v in job.result().items()})
    differ = 0
    for k in sorted(set(code["this"]) | set(code["tree"])):
        a, b = code["tree"].get(k), code["this"].get(k)
        if a is None or b is None:
            print(f"{k}: only in {'this' if a is None else 'the tree'} "
                  f"({len(a or b)} instructions)")
            continue
        same = a == b
        differ += not same
        print(f"{k}: tree {len(a)}, this {len(b)} instructions, "
              f"{'IDENTICAL' if same else 'DIFFERENT'}")
        shown = 0
        for i, (ia, ib) in enumerate(zip(a, b)):
            if ia != ib and shown < args.diff:
                print(f"  {i}: tree {ia} | this {ib}")
                shown += 1
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
