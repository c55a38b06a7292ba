"""Record the JAX package's dry run for the combos whose port records
chip_smoke.py and PERF.md hold against it.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_dryrun_reference.py

For granite-moe-3b-a800m, qwen3-moe-235b-a22b, jamba-v0.1-52b,
starcoder2-3b, qwen1.5-4b and qwen1.5-32b at train_4k, and qwen2-0.5b,
xlstm-1.3b, whisper-tiny and granite-moe-3b-a800m at train_4k and
prefill_32k (qwen2's 14 heads, whisper's 6, qwen1.5's 20 and 40,
starcoder2's and granite's 24 do not divide the 16-way 'model' axis, nor
do whisper's and granite's vocabs: XLA pads each split, and so does the
port), each on the one-pod
(16 x 16) and the two-pod (2 x 16 x 16) mesh, it runs
``repro.launch.dryrun.dryrun_one`` (lower and compile on 512 placeholder
CPU devices) in a process of its own and keeps the record's ``status``,
``memory``, ``collectives``, ``n_params`` and ``lower_s``.  They go, with
the JAX version, into tools/dryrun_jax_reference.json, which chip_smoke.py
reads as JSON (no JAX import there).  ``--jobs`` combos run at once
(default 2); a combo takes seconds (xlstm) to minutes (qwen3-moe).
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tools" / "dryrun_jax_reference.json"
COMBOS = [(arch, "train_4k") for arch in (
    "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
    "xlstm-1.3b", "qwen2-0.5b", "whisper-tiny", "starcoder2-3b",
    "qwen1.5-4b", "qwen1.5-32b")] + [
    (arch, "prefill_32k") for arch in ("xlstm-1.3b", "qwen2-0.5b",
                                       "whisper-tiny",
                                       "granite-moe-3b-a800m")]
KEYS = ("status", "memory", "collectives", "n_params", "lower_s")

# one combo: repro.launch.dryrun sets its 512-device XLA flag on import
RUN = """
import json, sys
from repro.launch import dryrun as D
rec = D.dryrun_one(sys.argv[1], sys.argv[2], sys.argv[3] == "pod2")
print("RECORD " + json.dumps(rec))
"""


def run(arch: str, shape: str, mesh: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", RUN, arch, shape, mesh],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args()
    import jax
    todo = [(a, s, m) for a, s in COMBOS for m in ("pod1", "pod2")]
    records, running = {}, []
    t0 = time.time()
    while todo or running:
        while todo and len(running) < args.jobs:
            combo = todo.pop(0)
            running.append((combo, run(*combo)))
        combo, proc = running.pop(0)
        out, err = proc.communicate()
        line = next((l for l in out.splitlines()
                     if l.startswith("RECORD ")), None)
        if proc.returncode != 0 or line is None:
            sys.exit(f"{combo}: exit {proc.returncode}\n{err[-3000:]}")
        rec = json.loads(line[len("RECORD "):])
        records["__".join(combo)] = {k: rec.get(k) for k in KEYS}
        print(f"{combo}: {rec['status']}, temp "
              f"{rec['memory']['temp_size_in_bytes'] / 2**30:.2f} GiB, "
              f"collectives {rec['collectives']['total'] / 2**20:.1f} MiB, "
              f"lower {rec['lower_s']} s", flush=True)
    OUT.write_text(json.dumps({
        "jax_version": jax.__version__,
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python "
                   "tools/record_dryrun_reference.py",
        "records": dict(sorted(records.items()))}, indent=1) + "\n")
    print(f"wrote {OUT} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
