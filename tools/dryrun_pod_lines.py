"""The collectives of the JAX package's dry run that cross pods, line by
line, and XLA's temp bytes, on the one-pod (16 x 16) and the two-pod
(2 x 16 x 16) mesh.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_pod_lines.py \\
      [--arch qwen2-0.5b] [--shape train_4k] [--top 12] [--out pod.json]

It lowers and compiles the combo on both meshes as
tools/record_dryrun_reference.py does (``repro.launch.dryrun.dryrun_one``
on 512 placeholder CPU devices) and keeps the compiled HLO.  For every
collective whose replica groups mix the two pods (the JAX package's own
``_crosses_pods`` test, which its ``cross_pod`` tally counts) it gives
the op, the operand shapes, the bytes of one execution, the trips of the
loops around it (the layer scan), the phase (forward, backward, or
remat's recompute, from the op's ``op_name``), the replica groups, and
what the operand is: a shard of a parameter (or, in the backward, of its
gradient), the batch (integer operands), a scalar, or an activation (in
the backward, an activation or its gradient).  A shard of a parameter
is an operand whose dims divide the parameter's, each by a power of two
(a leading layer dim dropped inside the scan).  It also lists the
largest buffers the HLO defines, which is where XLA's temp goes, and
counts the SPMD partitioner's "Involuntary full rematerialization"
warnings (a tensor XLA replicates because it finds no cheaper
resharding), with the ops they name.  About
30 s for qwen2-0.5b's train_4k on 8 CPU cores; nothing of the JAX package
is edited.
"""
import argparse
import contextlib
import json
import os
import re
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# repro.launch.dryrun sets its 512-device XLA flag on import: first
from repro.launch import dryrun as D  # noqa: E402

import jax  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.launch import specs as SP  # noqa: E402

_INTS = {"s8", "s16", "s32", "s64", "u8", "u16", "u32", "u64", "pred"}
_OP_NAME_RE = re.compile(r'op_name="([^"]*)"')
_GROUPS_RE = re.compile(r"replica_groups=(\[[^\s]*|\{\{[^}]*\}[^\s]*)")


def _dims(text: str):
    return [(dt, tuple(int(d) for d in dims.split(",") if d))
            for dt, dims in D._SHAPE_RE.findall(text)]


def param_shapes(arch: str):
    """The parameter leaves' shapes, and the same without their leading
    layer dim (the shape inside the layer scan)."""
    out = set()
    for leaf in jax.tree_util.tree_leaves(SP.params_shape(get_config(arch))):
        out.add(tuple(leaf.shape))
        if len(leaf.shape) > 1:
            out.add(tuple(leaf.shape[1:]))
    return out


def _is_shard(dims, shapes) -> bool:
    for p in shapes:
        if len(p) == len(dims) and all(
                d and g % d == 0 and (g // d) & (g // d - 1) == 0
                for g, d in zip(p, dims)):
            return True
    return False


def phase_of(op_name: str) -> str:
    if "rematted_computation" in op_name:
        return "recompute"
    return "backward" if "transpose(" in op_name else "forward"


def operand_kind(operands, phase: str, shapes) -> str:
    dt, dims = operands[0]
    if dt in _INTS:
        return "batch"
    if not dims:
        return "scalar"
    if all(_is_shard(d, shapes) for _, d in operands):
        return "parameter gradient" if phase == "backward" else "parameter"
    return ("activation or its gradient" if phase == "backward"
            else "activation")


def collectives(hlo: str, shapes):
    """Every collective of the compiled HLO, loop trips applied: dicts of
    op, operands, bytes, trips, phase, kind, groups, op_name, crosses."""
    comps, entry = D._split_computations(hlo)
    rows = []

    def visit(comp, trips, stack=()):
        if comp not in comps or comp in stack:
            return
        lines = comps[comp]
        types = {}
        for line in lines:
            m = D._DEF_RE.match(line)
            if m:
                types[m.group(1)] = m.group(2)
        sizes = {k: D._parse_type_bytes(v) for k, v in types.items()}
        for line in lines:
            wm = D._WHILE_RE.search(line)
            if wm:
                cond, body = wm.groups()
                visit(body, trips * D._trip_count(comps.get(cond, [])),
                      stack + (comp,))
                continue
            for op in D._COLLECTIVES:
                if f"{op}-done" in line or not re.search(
                        rf"\b{op}(?:-start)?\(", line):
                    continue
                nbytes = D._line_operand_bytes(line, op, sizes)
                args = line[re.search(rf"\b{op}(?:-start)?\(", line).end():]
                names = D._OPND_RE.findall(args.split(")", 1)[0])
                operands = [x for n in names for x in _dims(types.get(n, ""))]
                name = _OP_NAME_RE.search(line)
                name = name.group(1) if name else ""
                phase = phase_of(name)
                groups = _GROUPS_RE.search(line)
                rows.append({
                    "op": op, "crosses_pods": D._crosses_pods(line),
                    "operands": [f"{dt}[{','.join(map(str, d))}]"
                                 for dt, d in operands],
                    "bytes": nbytes, "trips": trips,
                    "total_bytes": nbytes * trips, "phase": phase,
                    "operand": operand_kind(operands or [("f32", ())], phase,
                                            shapes),
                    "groups": groups.group(1)[:80] if groups else "",
                    "op_name": name})
                break

    visit(entry, 1)
    return rows


def largest_buffers(hlo: str, top: int):
    """The largest distinct array shapes the HLO defines, as bytes."""
    sizes = {}
    for m in re.finditer(r"%[\w.\-]+ = ([a-z0-9]+)\[([0-9,]*)\]", hlo):
        dt, dims = m.groups()
        if dt in D._DTYPE_BYTES:
            sizes[f"{dt}[{dims}]"] = D._tensor_bytes(dt, dims)
    return sorted(sizes.items(), key=lambda kv: -kv[1])[:top]


@contextlib.contextmanager
def stderr_lines(into: list):
    """The lines written to file descriptor 2 inside the block (XLA's C++
    log), still passed on to it after."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile(mode="w+") as f:
        os.dup2(f.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            f.seek(0)
            text = f.read()
            sys.stderr.write(text)
            into.extend(text.splitlines())


def remat_warnings(lines):
    """(op_name, the HLO op) of each involuntary full rematerialization."""
    out = []
    for line in lines:
        if "Involuntary full rematerialization" not in line:
            continue
        name = _OP_NAME_RE.search(line)
        op = re.search(r"HLO operation %[\w.\-]+ = (\S+ [\w\-]+)\(", line)
        out.append({"op_name": name.group(1) if name else "",
                    "op": op.group(1) if op else ""})
    return out


def one_mesh(arch: str, shape: str, multi_pod: bool, top: int) -> dict:
    hlos, log = [], []
    tally = D.collective_bytes
    D.collective_bytes = lambda hlo: (hlos.append(hlo), tally(hlo))[1]
    try:
        with stderr_lines(log):
            rec = D.dryrun_one(arch, shape, multi_pod)
    finally:
        D.collective_bytes = tally
    rows = collectives(hlos[-1], param_shapes(arch))
    cross = [r for r in rows if r["crosses_pods"]]
    by_kind = defaultdict(int)
    for r in cross:
        by_kind[f"{r['op']} of {r['operand']} ({r['phase']})"] += \
            r["total_bytes"]
    assert sum(r["total_bytes"] for r in cross) == \
        rec["collectives"]["cross_pod"], "the listing misses a collective"
    return {"mesh": rec["mesh"], "memory": rec["memory"],
            "collectives": rec["collectives"],
            "cross_pod_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "cross_pod": sorted(cross, key=lambda r: -r["total_bytes"]),
            "largest_buffers": largest_buffers(hlos[-1], top),
            "involuntary_remat": remat_warnings(log)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = {"jax_version": jax.__version__, "arch": args.arch,
           "shape": args.shape}
    gib, mib = 2 ** 30, 2 ** 20
    for mesh in ("pod1", "pod2"):
        r = out[mesh] = one_mesh(args.arch, args.shape, mesh == "pod2",
                                 args.top)
        c = r["collectives"]
        print(f"{args.arch} x {args.shape} x {r['mesh']}: temp "
              f"{r['memory']['temp_size_in_bytes'] / gib:.2f} GiB, argument "
              f"{r['memory']['argument_size_in_bytes'] / mib:.2f} MiB; "
              f"collectives {c['total'] / mib:,.0f} MiB (all-gather "
              f"{c['all-gather'] / mib:,.0f}, all-reduce "
              f"{c['all-reduce'] / mib:,.0f}, collective-permute "
              f"{c['collective-permute'] / mib:,.0f}, all-to-all "
              f"{c['all-to-all'] / mib:,.0f}); across pods "
              f"{c['cross_pod'] / mib:,.0f} MiB in {len(r['cross_pod'])} ops",
              flush=True)
        for kind, b in r["cross_pod_by_kind"].items():
            print(f"  {b / mib:12,.1f} MiB  {kind}")
        for row in r["cross_pod"]:
            print(f"    {row['total_bytes'] / mib:10,.1f} MiB = "
                  f"{row['bytes'] / mib:,.1f} x {row['trips']:>2} "
                  f"{row['op']} {' '.join(row['operands'][:2])}"
                  f"{' ...' if len(row['operands']) > 2 else ''} "
                  f"[{row['operand']}, {row['phase']}] "
                  f"groups {row['groups'][:40]}")
        print("  largest buffers: " + ", ".join(
            f"{k} {b / gib:.2f} GiB" for k, b in r["largest_buffers"][:6]))
        print(f"  involuntary full rematerializations: "
              f"{len(r['involuntary_remat'])}")
        for w in r["involuntary_remat"]:
            print(f"    {w['op']} at {w['op_name']}")
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
