"""Tell float drift from a fault in the port's self-healing cell.

At lr 0.1 and 2 local epochs, two runs whose params differ in the last
place drift apart within a few rounds, and once the adaptive band's
screens read the trained params they pick other clients.  Three modes
separate that drift from a fault of the port, all on the CPU (the
records in tools/ were made single-threaded: XLA_FLAGS=
"--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"),
and a fourth summarises the first:

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/robust_drift.py \\
      sample {jax,port} CELL RUNTIME ROUNDS SEED [SEED ...] > OUT.jsonl

runs chip_smoke.py's cell CELL in one package once per SEED, its initial
params moved by NUDGE of their size with a sign drawn from SEED (SEED 0:
unmoved) -- less than two runtimes differ by after one round -- and
prints one JSON line a run: every round's winners, screen, quarantine
and ban counts, the evals, the final strikes and the adversary mask.

  ... tools/robust_drift.py lockstep CELL RUNTIME ROUNDS > OUT.jsonl

runs the JAX package's cell and, before every round, loads its state
into the port's server (the JAX checkpoint, which the port resumes):
each line compares one round of each from the same state -- winners,
screen, quarantine and ban counts and strikes exactly, the params'
largest difference against the size of the round's own step, and every
leaf of the state the next round reads (the checkpoint tree).

  ... tools/robust_drift.py anchors CELL OUTDIR T [T ...]

runs the JAX package's cell on its ``device`` runtime and writes its
checkpoints before rounds T and T+1, and round T's winners and counts
with the cell's config (anchors.json), to OUTDIR; chip_smoke.py and
tests/test_torch_selfheal.py resume the port from each T for one round
and hold it to JAX's decisions and to the state after the round.

  python tools/robust_drift.py envelope CELL OUT.jsonl [...]

summarises ``sample`` lines: per package, the runs' ban counts and
screened totals after 60 rounds and at the end, rollbacks, learning
onsets and final evals, and writes CELL's ranges of the JAX runs into
tools/robust_drift.json, which chip_smoke.py holds the card's totals
to.
"""
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as SMOKE                                  # noqa: E402

DRIFT = ROOT / "tools" / "robust_drift.json"
# a sample's relative move of the initial params: about 8 units in the
# last place, less than one round of two runtimes from the same state
# differs by (up to 4e-5 absolute on params of about 0.2, ``lockstep``)
NUDGE = 1e-6
# a JAX checkpoint restores into the port by its flattened keys
warnings.filterwarnings("ignore", "checkpoint treedef mismatch")


def _cfg_kw(cell: str, runtime: str) -> dict:
    return dict(SMOKE.ROBUST_BASE, **dict(SMOKE.ROBUST_CELLS[cell],
                                          runtime=runtime))


def _data():
    from repro.data.synthetic import make_image_dataset
    train, test = make_image_dataset(
        SMOKE.ROBUST_DATASET, n_train=SMOKE.ROBUST_POOL,
        n_test=SMOKE.ROBUST_TEST, seed=SMOKE.ROBUST_BASE["seed"])
    return train, {"x": test.x[:SMOKE.ROBUST_TEST],
                   "y": test.y[:SMOKE.ROBUST_TEST]}


def jax_server(cell: str, runtime: str, data):
    from repro.configs.base import FLConfig
    from repro.core.adapters import cnn_adapter
    from repro.core.server import FederatedServer
    from repro.data.partition import partition_clients
    train, test = data
    cfg = FLConfig(**_cfg_kw(cell, runtime))
    clients = partition_clients(train.y, cfg, seed=cfg.seed)
    return FederatedServer(cfg, cnn_adapter(SMOKE.ROBUST_DATASET), train.x,
                           train.y, clients, test)


def port_server(cell: str, runtime: str, data):
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.adapters import cnn_adapter
    from repro_torch.core.server import FederatedServer
    from repro_torch.data.partition import partition_clients
    torch.set_num_threads(1)
    train, test = data
    cfg = FLConfig(**_cfg_kw(cell, runtime))
    clients = partition_clients(np.asarray(train.y), cfg, seed=cfg.seed)
    return FederatedServer(cfg, cnn_adapter(SMOKE.ROBUST_DATASET, "cpu"),
                           np.asarray(train.x), np.asarray(train.y), clients,
                           {k: np.asarray(v) for k, v in test.items()},
                           device="cpu")


def nudge(params: dict, seed: int, to_array) -> dict:
    """Every param moved by NUDGE of its size up or down, the sign drawn
    from ``seed`` over the sorted keys (the same in both packages)."""
    rs = np.random.default_rng(seed)
    out = {}
    for k in sorted(params):
        p = np.asarray(params[k], np.float32)
        sign = np.where(rs.random(p.shape) < 0.5, 1.0, -1.0)
        out[k] = to_array((p + NUDGE * np.abs(p) * sign).astype(np.float32))
    return out


def _record(srv, mem, logs) -> dict:
    rows = [e for e in mem.events if e["kind"] == "round"]
    strikes = np.asarray(srv.state.strikes, np.float32)
    return {
        "selected": [np.asarray(l.selected).tolist() for l in logs],
        "num_screened": [int(r.get("num_screened", 0)) for r in rows],
        "num_quarantined": [int(r.get("num_quarantined", 0)) for r in rows],
        "num_banned": [int(r.get("num_banned", 0)) for r in rows],
        "evals": {int(l.round): float(l.test_acc) for l in logs
                  if not l.eval_skipped},
        "strikes": strikes.tolist(),
        "adversaries": np.flatnonzero(np.asarray(srv._adv_mask)).tolist(),
        "rollbacks": srv.watchdog_totals["rollbacks"]
        if srv.cfg.watchdog_enabled else 0,
    }


def sample(pkg: str, cell: str, runtime: str, rounds: int, seeds) -> None:
    data = _data()
    for seed in seeds:
        if pkg == "jax":
            import jax.numpy as jnp
            from repro import obs
            srv = jax_server(cell, runtime, data)
            to_array = jnp.asarray
        else:
            import torch
            from repro_torch import obs
            srv = port_server(cell, runtime, data)
            to_array = torch.from_numpy
        if seed:
            srv.params = nudge(srv.params, seed, to_array)
        obs.OBS.reset()
        mem = obs.OBS.configure(memory=True)
        t0 = time.time()
        logs = srv.run(rounds=rounds)
        obs.OBS.flush()
        out = dict(_record(srv, mem, logs), pkg=pkg, cell=cell,
                   runtime=runtime, rounds=rounds, seed=seed,
                   seconds=time.time() - t0)
        print(json.dumps(out), flush=True)


def lockstep(cell: str, runtime: str, rounds: int) -> None:
    from repro import obs as JOBS
    from repro_torch import obs as TOBS
    data = _data()
    js = jax_server(cell, runtime, data)
    ts = port_server(cell, runtime, data)
    js.cluster()
    ts.cluster()
    same = np.array_equal(np.asarray(js.state.clusters),
                          ts.state.clusters.numpy())
    print(json.dumps({"clusters_equal": bool(same)}), flush=True)
    for s in (js, ts):
        warm = getattr(s.runtime, "warmup", None)
        if warm is not None:
            warm(s.params)
    jmem = JOBS.OBS.configure(memory=True)
    tmem = TOBS.OBS.configure(memory=True)
    work = ROOT / "build" / "robust_drift"
    work.mkdir(parents=True, exist_ok=True)
    for t in range(rounds):
        path = str(work / "lockstep_ck")
        js.save_checkpoint(path, t)
        ts.load_checkpoint(path)
        before = {k: np.asarray(v) for k, v in js.params.items()}
        for s in (js, ts):
            s._dispatch_round(t, s._eval_due(t, final=t == rounds - 1))
            s._flush_pending()
        jr = [e for e in jmem.events if e["kind"] == "round"][-1]
        tr = [e for e in tmem.events if e["kind"] == "round"][-1]
        step = max(float(np.abs(np.asarray(js.params[k]) - before[k]).max())
                   for k in before)
        diff = max(float(np.abs(np.asarray(js.params[k])
                                - ts.params[k].numpy()).max())
                   for k in before)
        line = {
            "round": t,
            "winners_equal": (np.asarray(js.logs[-1].selected).tolist()
                              == ts.logs[-1].selected.tolist()),
            "strikes_equal": bool(np.array_equal(
                np.asarray(js.state.strikes, np.float32),
                ts.state.strikes.numpy())),
            "params_max_abs_diff": diff, "params_round_step": step,
        }
        for k in ("num_screened", "num_quarantined", "num_banned"):
            line[k] = [int(jr.get(k, 0)), int(tr.get(k, 0))]
        # the whole carried state after the round (what the next round
        # reads), leaf by leaf: integer leaves exact, the largest float
        # difference of every other leaf
        js.save_checkpoint(path + "_j", t + 1)
        ts.save_checkpoint(path + "_t", t + 1)
        with np.load(path + "_j.npz") as a, np.load(path + "_t.npz") as b:
            line["state_keys_equal"] = sorted(a.files) == sorted(b.files)
            line["state_int_equal"] = all(
                np.array_equal(a[k], b[k]) for k in a.files
                if not np.issubdtype(a[k].dtype, np.floating))
            line["state_float_diff"] = {
                k: float(np.abs(a[k] - b[k]).max()) for k in a.files
                if np.issubdtype(a[k].dtype, np.floating)
                and not k.startswith("params")
                and not np.array_equal(a[k], b[k])}
        print(json.dumps(line), flush=True)


def anchors(cell: str, outdir: str, ts) -> None:
    from repro import obs
    rounds = max(ts) + 2         # the last anchor's next state is saved
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    srv = jax_server(cell, "device", _data())
    keep = set(ts) | {t + 1 for t in ts}
    dispatch = srv._dispatch_round
    obs.OBS.reset()
    mem = obs.OBS.configure(memory=True)

    def hooked(t, eval_now, final=False):
        if t in keep:
            srv._flush_pending()
            srv.save_checkpoint(str(out / f"round{t}"), t)
        dispatch(t, eval_now, final=final)
        if t in ts:
            srv._flush_pending()
    srv._dispatch_round = hooked
    logs = srv.run(rounds=rounds)
    obs.OBS.flush()
    rows = {e["round"]: e for e in mem.events if e["kind"] == "round"}
    meta = {}
    for t in ts:
        log = next(l for l in logs if l.round == t)
        meta[str(t)] = {
            "selected": np.asarray(log.selected).tolist(),
            "num_screened": int(rows[t].get("num_screened", 0)),
            "num_quarantined": int(rows[t].get("num_quarantined", 0)),
            "num_banned": int(rows[t].get("num_banned", 0))}
    (out / "anchors.json").write_text(json.dumps(
        {"cell": cell, "config": _cfg_kw(cell, "device"),
         "dataset": SMOKE.ROBUST_DATASET, "pool": SMOKE.ROBUST_POOL,
         "test": SMOKE.ROBUST_TEST, "anchors": meta}, indent=1) + "\n")
    print(f"wrote {len(ts)} anchors to {out}", file=sys.stderr)


def _stats(runs, r60: int, threshold: float) -> dict:
    """Sorted per-run values: ban count and screened total after 60
    rounds and at the end, rollbacks, the first eval round at 0.5 or
    more (the learning onset), the final eval, and the adversaries whose
    strikes end at the ban threshold or above."""
    out = {}
    for n in sorted({r60, runs[0]["rounds"]}):
        out[f"banned_{n}"] = sorted(r["num_banned"][n - 1] for r in runs)
        out[f"screened_{n}"] = sorted(sum(r["num_screened"][:n])
                                      for r in runs)
    out["rollbacks"] = sorted(r["rollbacks"] for r in runs)
    out["onset"] = sorted(min((int(t) for t, a in r["evals"].items()
                               if a >= 0.5), default=-1) for r in runs)
    out["final_acc"] = sorted(r["evals"][max(r["evals"], key=int)]
                              for r in runs)
    out["adversaries_banned"] = sorted(
        int(sum(r["strikes"][i] >= threshold for i in r["adversaries"]))
        for r in runs)
    return out


def envelope(cell: str, paths) -> None:
    from repro_torch.configs.base import FLConfig
    runs = [json.loads(line) for p in paths
            for line in Path(p).read_text().splitlines() if line.strip()]
    by = {}
    for r in runs:
        by.setdefault(r["pkg"], []).append(r)
    threshold = FLConfig().strike_threshold
    summary = {pkg: dict(_stats(rs, SMOKE.ROBUST_ROUNDS, threshold),
                         runs=len(rs),
                         runtimes=sorted({r["runtime"] for r in rs}))
               for pkg, rs in sorted(by.items())}
    for pkg, st in summary.items():
        print(pkg, json.dumps(st))
    drift = json.loads(DRIFT.read_text()) if DRIFT.exists() else {}
    jx = summary["jax"]
    drift[cell] = {"runs": jx["runs"], "runtimes": jx["runtimes"],
                   **{k: [v[0], v[-1]] for k, v in jx.items()
                      if k.startswith(("banned_", "screened_"))
                      or k == "rollbacks"}}
    DRIFT.write_text(json.dumps(drift, indent=1) + "\n")
    print(f"wrote {DRIFT}", file=sys.stderr)


def main() -> None:
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "sample":
        sample(args[0], args[1], args[2], int(args[3]),
               [int(s) for s in args[4:]])
    elif mode == "lockstep":
        lockstep(args[0], args[1], int(args[2]))
    elif mode == "anchors":
        anchors(args[0], args[1], [int(t) for t in args[2:]])
    elif mode == "envelope":
        envelope(args[0], args[1:])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
