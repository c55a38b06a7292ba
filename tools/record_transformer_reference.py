"""Record the JAX package's ``--mode transformer`` runs for chip_smoke.py's
transformer path.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_transformer_reference.py

Runs ``python -m repro.launch.train --mode transformer --quiet`` at the
CLI defaults (each arch's smoke config, 100 clients -> 20 FL clients, 5
clusters, seed 0) on the CPU: qwen2-0.5b for ``QWEN_ROUNDS`` rounds on
the ``sequential``, ``vectorized`` and ``device`` runtimes, and each
other dense arch for ``ARCH_ROUNDS`` rounds on ``sequential``.  For each
run it keeps the stage-1 cluster labels, every round's winners,
``test_loss``, ``test_acc`` and ``energy_std``, and writes them with the
JAX version to tools/transformer_reference.json, which chip_smoke.py
reads as JSON (no JAX import there).
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "tools" / "transformer_reference.json"
QWEN = "qwen2-0.5b"
QWEN_ROUNDS = 30
QWEN_RUNTIMES = ("sequential", "vectorized", "device")
OTHER_ARCHS = ("qwen1.5-4b", "qwen1.5-32b", "starcoder2-3b",
               "phi-3-vision-4.2b")
ARCH_ROUNDS = 3


def record(arch: str, runtime: str, rounds: int) -> dict:
    import numpy as np

    import repro.launch.train as JT
    servers, results = [], []

    class Recording(JT.FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    run = JT.run_transformer
    JT.FederatedServer = Recording
    JT.run_transformer = lambda args: results.append(run(args)) \
        or results[-1]
    argv = sys.argv
    sys.argv = ["train", "--mode", "transformer", "--arch", arch,
                "--runtime", runtime, "--rounds", str(rounds), "--quiet"]
    t = time.time()
    try:
        JT.main()
    finally:
        sys.argv = argv
        JT.FederatedServer = Recording.__bases__[0]
        JT.run_transformer = run
    srv, res = servers[-1], results[-1]
    out = {
        "clusters": np.asarray(srv.state.clusters).tolist(),
        "selected": [l.selected.tolist() for l in srv.logs],
        "test_loss": res["test_loss"],
        "test_acc": res["test_acc"],
        "energy_std": res["energy_std"],
    }
    print(f"# {arch} ({runtime}, {rounds} rounds): {time.time() - t:.1f} s,"
          f" final loss {out['test_loss'][-1]!r} acc "
          f"{out['test_acc'][-1]!r}", flush=True)
    return out


def main() -> None:
    import jax
    t = time.time()
    runs = {QWEN: {rt: record(QWEN, rt, QWEN_ROUNDS)
                   for rt in QWEN_RUNTIMES}}
    for arch in OTHER_ARCHS:
        runs[arch] = {"sequential": record(arch, "sequential", ARCH_ROUNDS)}
    OUT.write_text(json.dumps({
        "jax_version": jax.__version__,
        "args": ["--mode", "transformer", "--quiet"],
        "rounds": {QWEN: QWEN_ROUNDS, **{a: ARCH_ROUNDS
                                         for a in OTHER_ARCHS}},
        "runs": runs}, indent=1) + "\n")
    print(f"wrote {OUT} in {time.time() - t:.1f} s (jax "
          f"{jax.__version__})", flush=True)


if __name__ == "__main__":
    main()
