#!/usr/bin/env python3
"""The cohort mesh over every local GPU, through the training CLI.

  python3 tools/cohort_mesh_check.py        # from the root of a checkout

Runs ``python -m repro_torch.launch.train`` in process: the paper path
at the reference defaults and ``--mode transformer`` on qwen2-0.5b's
smoke config, 3 rounds each, first on ``--runtime vectorized`` (one
GPU), then on ``sharded`` and ``device`` with ``--cohort-devices 0``
(every local GPU) and their warm rounds under ``--audit-sync``.  Each
split run must select the vectorized run's clients in every round, with
its final params within 1e-4 (tests/test_sim.py's bound between
runtimes).  Prints the card's name and power limit, then per run the
data axis, the mesh, the host packing seconds and the seconds a round
(wall time less stage 1 and warm-up).  Exits non-zero without a GPU or
when a check fails.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PARAMS_TOL = 1e-4
RUNS = {"paper": ["--rounds", "3", "--quiet"],
        "transformer": ["--mode", "transformer", "--rounds", "3",
                        "--quiet"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("cohort_mesh_check: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from repro_torch import obs
    from repro_torch.launch import train as TRAIN

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    servers = []

    class Recording(TRAIN.FederatedServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    TRAIN.FederatedServer = Recording
    ok = True
    for mode, args in RUNS.items():
        ref = None
        for runtime, extra in (("vectorized", []),
                               ("sharded", ["--cohort-devices", "0",
                                            "--audit-sync"]),
                               ("device", ["--cohort-devices", "0",
                                           "--audit-sync"])):
            obs.SPANS.clear()
            result = TRAIN.main(args + ["--runtime", runtime] + extra)
            torch.cuda.synchronize()
            srv = servers[-1]
            eng = srv.runtime.engine
            loop_s = (result["wall_s"] - obs.SPANS["run/cluster"]
                      - obs.SPANS.get("run/warmup", 0.0))
            mesh = [str(d) for d in eng.mesh.devices] if eng.mesh else None
            line = (f"{mode} {runtime}: data_axis={eng.data_axis_size} "
                    f"mesh={mesh} host_pack_s={srv.runtime.host_pack_s!r} "
                    f"s_per_round={loop_s / len(result['rounds'])!r}")
            if ref is None:
                ref = (result["selected"], srv.params)
            else:
                diff = max(float((srv.params[k].float()
                                  - ref[1][k].float()).abs().max())
                           for k in ref[1])
                same = result["selected"] == ref[0]
                ok &= same and diff < PARAMS_TOL
                line += (f" winners_as_vectorized={same} "
                         f"max_abs_dparams_vs_vectorized={diff!r}")
            print(line, flush=True)
    print("cohort_mesh_check: " + ("ok" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
