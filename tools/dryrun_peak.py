"""Break down the peak of the port's dry-run memory tally: at the op where
the live bytes of ``temp_size_in_bytes`` peak, which tensors are live,
by the line of the port that made them.

  PYTHONPATH=src python tools/dryrun_peak.py --arch xlstm-1.3b \\
      --shape train_4k [--multi-pod] [--device cpu] [--layers N] \\
      [--out peak.json]

It runs ``launch.dryrun.dryrun_one`` with a tally that notes, for each
storage it counts, the innermost frame of ``src/repro_torch/models/``
(else of ``src/repro_torch/``) that dispatched it and whether it was
made in the forward, in remat's recompute or in the backward; a storage
made by a backward node that runs no Python of the port is named by its
node and the forward line that made the node (autograd's anomaly
metadata, without its NaN checks).  Whenever the live bytes pass the
last snapshot by 0.5 % it snapshots the live storages, so the last
snapshot is within 0.5 % of the peak.  It prints the record's headline,
the op at the peak, the live bytes by site and the largest live
tensors, and writes them as JSON with ``--out``.  It also lists every
collective whose group spans the ``pod`` mesh dimension (the record's
``cross_pod``), by kind, operand type and the port's line that issued
it, beside what ``launch.dryrun._pod_mean`` must move: the sum over the
parameters of each local shard's bytes in the gradient's type.
``--layers`` cuts
the arch's depth (a multiple of its cycle), for a quick look on a small
host; the full-size shapes are for the card's host.
"""
import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402

STEP = 1.005              # a snapshot when the live bytes pass the last by 0.5 %


def _site():
    """(the innermost frame of the port's models, else of the port, as
    'path:line (function)', or None; whether remat's recompute is on the
    stack)."""
    f, fallback, recompute = sys._getframe(2), None, False
    found = None
    while f is not None:
        name = f.f_code.co_filename
        recompute |= name.endswith("torch/utils/checkpoint.py")
        if found is None and "repro_torch" in name \
                and "tools/dryrun_peak" not in name:
            where = (f"{name.rsplit('src/', 1)[-1]}:{f.f_lineno} "
                     f"({f.f_code.co_name})")
            if "repro_torch/models/" in name:
                found = (where, f.f_code.co_name)
            elif fallback is None and "launch/dryrun" not in name:
                fallback = (where, f.f_code.co_name)
        f = f.f_back
    return found or fallback or (None, None), recompute


def _node_site():
    """The running backward node's name and the forward line of the port
    that made it."""
    node = torch._C._current_autograd_node()
    if node is None:
        return "backward (no node)"
    trace = node.metadata.get("traceback_") or []
    lines = "".join(trace).splitlines() if isinstance(trace, list) \
        else str(trace).splitlines()
    ours = [re.search(r'(repro_torch/models/[^"]+)", line (\d+), in (\S+)',
                      l) for l in lines]
    ours = [m for m in ours if m]
    fwd = "{}:{} ({})".format(*ours[-1].groups()) if ours else "?"
    return f"{node.name()} of {fwd}"


def _caller():
    """The innermost frame of the port (its launch code included, the
    tally's own frames not) as 'path:line (function)'."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not (
                name.endswith("launch/dryrun.py")
                and f.f_code.co_name in ("dispatch", "_collective")):
            return (f"{name.rsplit('src/', 1)[-1]}:{f.f_lineno} "
                    f"({f.f_code.co_name})")
        f = f.f_back
    return "?"


def make_mode(base):
    class PeakMode(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.meta = {}
            self.snap_at = 0
            self.snapshot = None
            self.cross = []

        def _collective(self, func, args):
            before = self.coll["cross_pod"]
            super()._collective(func, args)
            moved = self.coll["cross_pod"] - before
            if moved:
                t = DR._tensors(args[0])[0]
                self.cross.append({
                    "kind": DR._KINDS[func._schema.name.partition("::")[2]
                                      .rstrip("_")],
                    "shape": list(t.shape), "dtype": str(t.dtype),
                    "bytes": moved, "site": _caller()})

        def _storage(self, out):
            before = set(self._storages)
            super()._storage(out)
            new = [k for k in self._storages if k not in before]
            if not new or not self.counting:
                return
            backward = torch._C._current_graph_task_id() != -1
            (site, fn), recompute = _site()
            if not backward:
                phase = "forward"
            elif recompute:
                phase = "recompute"
            else:
                # a custom Function's own backward, else a node of autograd
                phase = "backward"
                if fn != "backward":
                    site = _node_site()
            shapes = {id(t.untyped_storage()): (tuple(t.shape), str(t.dtype))
                      for t in DR._tensors(out)}
            for k in new:
                self.meta[k] = (site, phase, *shapes.get(k, ((), "?")))
            if self.live > self.snap_at * STEP:
                self.snap_at = self.live
                self._snap(site, phase)

        def _free(self, key):
            super()._free(key)
            self.meta.pop(key, None)

        def _snap(self, site, phase):
            by_site = defaultdict(int)
            rows = []
            for k, nbytes in self._storages.items():
                if not nbytes:
                    continue
                s, ph, shape, dtype = self.meta.get(k, ("before the step",
                                                        "args", (), "?"))
                by_site[f"{ph}: {s}"] += nbytes
                rows.append((nbytes, ph, s, shape, dtype))
            rows.sort(reverse=True)
            self.snapshot = {
                "live_bytes": self.live, "at": f"{phase}: {site}",
                "by_site": dict(sorted(by_site.items(),
                                       key=lambda kv: -kv[1])),
                "largest": [{"bytes": b, "phase": ph, "site": s,
                             "shape": list(sh), "dtype": dt}
                            for b, ph, s, sh, dt in rows[:25]]}

    return PeakMode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers (0: all)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    base = DR._make_tally_mode
    modes = []

    def patched():
        mode = make_mode(base())
        return lambda *a, **k: modes.append(mode(*a, **k)) or modes[-1]

    DR._make_tally_mode = patched
    pod_mean, owed = DR._pod_mean, []

    def counted_pod_mean(mesh):
        sync = pod_mean(mesh)

        def counted(grads, params):
            owed.append(sum(params[k].to_local().numel() * g.element_size()
                            for k, g in grads.items()))
            return sync(grads, params)
        return counted

    DR._pod_mean = counted_pod_mean
    torch.autograd.set_detect_anomaly(True, check_nan=False)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    rec = DR.dryrun_one(args.arch, args.shape, args.multi_pod,
                        device=args.device, cfg=cfg)
    tally = modes[-1]
    snap = tally.snapshot
    print(DR.headline(rec), flush=True)
    print(f"peak {tally.peak} B ({tally.peak / 2**30:.2f} GiB); the last "
          f"snapshot {snap['live_bytes']} B, taken at {snap['at']}")
    print("live bytes by site (GiB):")
    for site, b in list(snap["by_site"].items())[:args.top]:
        print(f"  {b / 2**30:8.3f}  {site}")
    print("largest live tensors:")
    for r in snap["largest"][:args.top]:
        print(f"  {r['bytes'] / 2**20:9.1f} MiB {r['dtype']} {r['shape']} "
              f"{r['phase']}: {r['site']}")
    cross = defaultdict(lambda: [0, 0])
    for c in tally.cross:
        row = cross[f"{c['kind']} {c['dtype']} at {c['site']}"]
        row[0] += 1
        row[1] += c["bytes"]
    listed = sum(c["bytes"] for c in tally.cross)
    print(f"cross-pod collectives: {len(tally.cross)} ops, {listed} B "
          f"(the record's cross_pod {rec['collectives']['cross_pod']} B; "
          f"_pod_mean's parameter shards in the gradients' types "
          f"{sum(owed)} B)")
    for where, (n, b) in sorted(cross.items(), key=lambda kv: -kv[1][1]):
        print(f"  {b / 2**20:10.2f} MiB in {n:4d} ops: {where}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"record": rec, "peak": tally.peak, "snapshot": snap,
             "cross_pod": tally.cross, "pod_mean_owed": sum(owed)},
            indent=1) + "\n")


if __name__ == "__main__":
    main()
