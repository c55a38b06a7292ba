#!/usr/bin/env python3
"""Time the float32 flash-attention kernel against another tree's build
of it, on one GPU.

    python3 tools/flash_fp32_timing.py --tree NAME=DIR [--tree ...] \\
        [--out FILE]

Builds this checkout's ``src/repro_torch/csrc/flash_attention.cu``
("new") and the same file of each ``--tree`` (another checkout, e.g. the
parent commit unpacked with ``git archive`` into an ignored directory,
as ``parent=DIR``), each into its own library with ``kernels/build.py``'s
flags, and prints each library's ptxas report and tensor-core
instruction counts.  Then, at every row of ``chip_smoke.FLASH_SHAPES``
with a float32 input, each library in turn runs
``chip_smoke.check_flash`` for that row (the same inputs, checks, timing
and printed line as ``chip_smoke.py``, the label suffixed with the
library's name): new, the trees, then the same in reverse order.  A
summary line a row gives each library's two times.  The card's name and
power limit come first; ``--out`` also writes the rows as JSON.  Exits
non-zero without a GPU, and with chip_smoke's error where a library
fails a check.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402  (puts src/ on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fp32_timing: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as OPS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    libs = {"new": FA.LIBRARY}
    for spec in args.tree:
        name, tree = spec.split("=", 1)
        src = (Path(tree).resolve() / "src" / "repro_torch" / "csrc"
               / "flash_attention.cu")
        libs[name] = BUILD.CudaLibrary(str(src), FA.LIBRARY.signatures)
    BUILD.build(*libs.values())
    for name, lib in libs.items():
        print(f"{name}: built in {lib.build_s:.1f} s; ptxas: "
              + "; ".join(r for r in CS.ptxas_summary(BUILD, lib.log)
                          if "flash_fwd_mma" not in r), flush=True)
        counts = CS.sass_mma_counts(BUILD, lib.path())
        names = CS.demangle(BUILD, counts)
        print(f"{name}: tensor-core instructions: " + "; ".join(
            f"{names[fn]}={n}" for fn, n in sorted(counts.items())
            if "flash_fwd_mma" not in fn), flush=True)

    dev = torch.device("cuda")
    order = list(libs) + list(reversed(libs))
    rows = []
    for seed, (label, *shape) in enumerate(CS.FLASH_SHAPES):
        if torch.float32 not in shape[5:7]:
            continue
        row = {"label": label, "ms": {n: [] for n in libs}, "plain_ms": [],
               "library_ms": []}
        for name in order:
            FA.LIBRARY = libs[name]
            got = CS.check_flash(OPS, dev, f"{label}:{name}", *shape, seed)
            row["ms"][name].append(got["ms"])
            row["plain_ms"].append(got["plain_ms"])
            row["library_ms"].append(got["library_ms"])
            row["bound_ms"] = got["bound_ms"]
        FA.LIBRARY = libs["new"]
        print(f"fp32_timing[{label}]: "
              + " ".join(f"{n}_ms={t!r}" for n, t in row["ms"].items())
              + f" bound_ms={row['bound_ms']!r}", flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
