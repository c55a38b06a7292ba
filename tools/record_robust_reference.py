"""Record the JAX package's results for chip_smoke.py's robust path.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_robust_reference.py \\
      OUT.json [--cells NAME,NAME] [device vectorized sequential]
  python tools/record_robust_reference.py --merge A.json B.json ...

Runs every cell of ``chip_smoke.ROBUST_CELLS`` (the reference
benchmark's robust_agg and self_healing fleets: 32 clients, 60 rounds,
clean and selfheal 100, seed 0, and the short NaN storm) through the
JAX package's
``FederatedServer`` on the CPU, once on each named runtime (the cells'
own is ``device``), writes the records to OUT.json and the summary that
chip_smoke.py holds the port to (its ``ROBUST_WINNERS``) to
tools/robust_reference.json.  ``--merge`` writes the summary from
records written earlier.

Each cell's entry is the ``device`` run: every round's winners, the
per-round ``num_quarantined`` and ``num_screened`` (undefended: absent),
the final ban count, the watchdog's rollbacks, snapshots and rollback
events, and the final test accuracy.  ``spread`` adds what the JAX
package's own runtimes give for the same cell, which differ only in the
order of float sums: each runtime's final accuracy, screened total and
ban count, and ``agree_through``, the number of leading rounds in which
every runtime picks the same winners and screens the same count (None:
all of them).  At these settings (lr 0.1, 2 local epochs) two runs
whose params differ in the last place drift apart by about 1e-5 after
one round and 1e-3 after three, so where a cell's selection reads the
trained params (the adaptive band's strikes) or its accuracy is read
once at the end, the runtimes disagree with each other.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as SMOKE                                  # noqa: E402

RUNTIMES = ("device", "vectorized", "sequential")


def record(name: str, kw: dict, train, test, runtime: str) -> dict:
    from repro import obs
    from repro.configs.base import FLConfig
    from repro.core.adapters import cnn_adapter
    from repro.core.server import FederatedServer
    from repro.data.partition import partition_clients
    cfg = FLConfig(**dict(SMOKE.ROBUST_BASE, **kw, runtime=runtime))
    clients = partition_clients(train.y, cfg, seed=cfg.seed)
    obs.OBS.reset()
    mem = obs.OBS.configure(memory=True)
    srv = FederatedServer(cfg, cnn_adapter(SMOKE.ROBUST_DATASET),
                          train.x, train.y, clients,
                          {"x": test.x[:SMOKE.ROBUST_TEST],
                           "y": test.y[:SMOKE.ROBUST_TEST]})
    t = time.time()
    logs = srv.run(rounds=SMOKE.robust_rounds(name))
    obs.OBS.flush()
    rows = [e for e in mem.events if e["kind"] == "round"]
    out = {
        "selected": [l.selected.tolist() for l in logs],
        "final_acc": float(logs[-1].test_acc),
        "eval_acc": {l.round: float(l.test_acc) for l in logs
                     if not l.eval_skipped},
    }
    if srv.defended:
        out["num_quarantined"] = [int(r["num_quarantined"]) for r in rows]
        out["num_screened"] = [int(r["num_screened"]) for r in rows]
        out["num_banned_final"] = srv.defense_totals["banned_final"]
    if cfg.watchdog_enabled:
        out["rollbacks"] = srv.watchdog_totals["rollbacks"]
        out["snapshots"] = srv.watchdog_totals["snapshots"]
        out["rollback_events"] = [
            (e["round"], e["restored_round"], e["reason"])
            for e in mem.events
            if e["kind"] == "watchdog" and e.get("name") == "rollback"]
    print(f"# {name} ({runtime}): {time.time() - t:.1f} s, final acc "
          f"{out['final_acc']!r}", file=sys.stderr, flush=True)
    return out


def _agree_through(runs) -> object:
    """Leading rounds in which every run has the same winners and screen
    count; None when that is all of them."""
    base = runs[0]
    n = len(base["selected"])
    for t in range(n):
        for r in runs[1:]:
            if (r["selected"][t] != base["selected"][t]
                    or r.get("num_screened", [0] * n)[t]
                    != base.get("num_screened", [0] * n)[t]):
                return t
    return None


def late_acc(eval_acc: dict) -> float:
    """The mean accuracy of a run's last three evals."""
    rounds = sorted(eval_acc, key=int)[-3:]
    return sum(eval_acc[r] for r in rounds) / len(rounds)


def summarize(per_runtime: dict) -> dict:
    """ROBUST_WINNERS: the device records plus each cell's spread over
    the recorded runtimes."""
    out = {}
    for name, rec in per_runtime["device"].items():
        runs = {rt: per_runtime[rt][name] for rt in RUNTIMES
                if rt in per_runtime}
        entry = {k: v for k, v in rec.items() if k != "eval_acc"}
        entry["spread"] = {
            "final_acc": {rt: r["final_acc"] for rt, r in runs.items()},
            "late_acc": {rt: late_acc(r["eval_acc"]) for rt, r in
                         runs.items()},
            "screened": {rt: sum(r.get("num_screened", [])) for rt, r in
                         runs.items()},
            "banned": {rt: r.get("num_banned_final", 0) for rt, r in
                       runs.items()},
            "rollbacks": {rt: r.get("rollbacks", 0) for rt, r in
                          runs.items()},
            "agree_through": _agree_through(list(runs.values())),
        }
        out[name] = entry
    return out


def main() -> None:
    args = sys.argv[1:]
    per_runtime = {}
    if args[0] == "--merge":
        for path in args[1:]:
            for rt, cells in json.loads(Path(path).read_text()).items():
                per_runtime.setdefault(rt, {}).update(cells)
    else:
        from repro.data.synthetic import make_image_dataset
        out, args = args[0], args[1:]
        cells = list(SMOKE.ROBUST_CELLS)
        if args[:1] == ["--cells"]:
            cells, args = args[1].split(","), args[2:]
        train, test = make_image_dataset(
            SMOKE.ROBUST_DATASET, n_train=SMOKE.ROBUST_POOL,
            n_test=SMOKE.ROBUST_TEST, seed=SMOKE.ROBUST_BASE["seed"])
        per_runtime = {rt: {name: record(name, SMOKE.ROBUST_CELLS[name],
                                         train, test, rt)
                            for name in cells}
                       for rt in (args or RUNTIMES)}
        Path(out).write_text(json.dumps(per_runtime))
        if set(cells) != set(SMOKE.ROBUST_CELLS):
            return
    summary = summarize(per_runtime)
    lines = ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}"
                        for k, v in summary.items())
    SMOKE.ROBUST_REFERENCE.write_text("{\n" + lines + "\n}\n")
    print(f"wrote {SMOKE.ROBUST_REFERENCE}", file=sys.stderr)


if __name__ == "__main__":
    main()
