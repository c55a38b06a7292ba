"""Record the JAX package's ``--mode transformer`` runs of the MoE,
Mamba and xLSTM archs for chip_smoke.py's zoo transformer path.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_zoo_reference.py

Runs ``python -m repro.launch.train --mode transformer --quiet`` at the
CLI defaults (each arch's smoke config, 100 clients -> 20 FL clients, 5
clusters, seed 0) on the CPU for ``ROUNDS`` rounds: granite-moe on the
``sequential``, ``vectorized`` and ``device`` runtimes, qwen3-moe, jamba
and xlstm on ``sequential``.  Each run keeps what
``tools/record_transformer_reference.py`` keeps (stage-1 labels, every
round's winners, ``test_loss``, ``test_acc``, ``energy_std``) and all go
with the JAX version into tools/zoo_reference.json, which chip_smoke.py
reads as JSON (no JAX import there).  About 6 minutes on one CPU.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from record_transformer_reference import record  # noqa: E402

OUT = ROOT / "tools" / "zoo_reference.json"
ROUNDS = 3
RUNS = {"granite-moe-3b-a800m": ("sequential", "vectorized", "device"),
        "qwen3-moe-235b-a22b": ("sequential",),
        "jamba-v0.1-52b": ("sequential",),
        "xlstm-1.3b": ("sequential",)}


def main() -> None:
    import jax
    t = time.time()
    runs = {arch: {rt: record(arch, rt, ROUNDS) for rt in rts}
            for arch, rts in RUNS.items()}
    OUT.write_text(json.dumps({
        "jax_version": jax.__version__,
        "args": ["--mode", "transformer", "--quiet"],
        "rounds": {arch: ROUNDS for arch in RUNS},
        "runs": runs}, indent=1) + "\n")
    print(f"wrote {OUT} in {time.time() - t:.1f} s (jax "
          f"{jax.__version__})", flush=True)


if __name__ == "__main__":
    main()
