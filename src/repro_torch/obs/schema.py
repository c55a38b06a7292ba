"""Event-stream schema + validator for the obs JSONL log: the port's own
copy of the JAX package's ``repro/obs/schema.py`` (the same kinds,
required fields and checks, so a stream either package writes passes
both validators; tests/test_torch_obs.py holds the two together).

The schema is deliberately small: every event is one flat JSON object
with a ``kind`` and a monotonic ``ts``; per-kind required fields are
listed in :data:`REQUIRED`.  :func:`validate_events` checks structural
validity plus the three pipeline invariants the CI smoke step cares
about (see .github/workflows/ci.yml):

  * **every round present** — with ``rounds=T``, exactly one ``round``
    series event and one ``round/dispatch`` span per round in [0, T);
  * **spans nested correctly** — unique ids, non-negative durations,
    each child's [t0, t0+dur] inside its parent's window, child depth =
    parent depth + 1;
  * **eval cadence respected** — with ``eval_every=k``, ``test_acc`` /
    ``test_loss`` are numbers exactly on due rounds (multiples of k and
    the final round) and null on skipped ones (NaN sanitizes to null in
    the file sinks).

With ``scheme_select`` (the run's control-plane selection scheme,
repro_torch.core.schemes) the validator additionally checks the scheme-tagged
scalar series: every round row must carry a numeric
``fairness_hist_std`` (all schemes emit it), and scheme_state-bearing
schemes (:data:`STATEFUL_SCHEMES`) must log their budget ledger
(``budget_spent`` / ``budget_remaining``) every round — a stateful
scheme whose budget scalars are missing is a broken metrics drain, not
a valid stream.

CLI (used by CI):

    python -m repro_torch.obs.schema events.jsonl --rounds 6 --eval-every 2 \
        --scheme-select longterm_auction
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

KINDS = ("meta", "round", "span", "counter", "gauge", "jax_stats", "log",
         "dynamics", "defense", "watchdog")

REQUIRED: Dict[str, tuple] = {
    "round": ("round", "test_acc", "test_loss", "energy_std", "mean_bid",
              "vds_gap"),
    "span": ("name", "id", "parent", "depth", "t0", "dur_s"),
    "counter": ("name", "value"),
    "gauge": ("name", "value"),
    "log": ("msg",),
    # fleet-dynamics events (round/empty, buffer/fold) — see
    # repro_torch.core.server and DESIGN.md §Fleet dynamics
    "dynamics": ("name",),
    # defended-aggregation events (quarantine, band_screen,
    # round/diverged) — see the JAX package's core/aggregation.py and
    # DESIGN.md
    # §Threat model
    "defense": ("name",),
    # divergence-watchdog events: a ``rollback`` event additionally
    # carries round / restored_round / reason (checked below — the
    # self-healing CI smoke asserts at least one)
    "watchdog": ("name",),
}

_EPS = 5e-3   # span clock tolerance (perf_counter rounding at 1e-6 + loop)

# schemes that thread a scheme_state pytree and therefore MUST log their
# budget scalars every round.  A literal, not an import: this module
# deliberately imports nothing of the port (it validates logs anywhere),
# so the registry can't be consulted here — tests/test_torch_obs.py
# asserts this tuple equals repro_torch.core.schemes
# .stateful_scheme_names() and the JAX package's copy.
STATEFUL_SCHEMES = ("longterm_auction",)

# scalar series every scheme-tagged stream must carry per round row
_SCHEME_SCALARS = ("fairness_hist_std",)
# …plus these for STATEFUL_SCHEMES (the carried budget ledger)
_BUDGET_SCALARS = ("budget_spent", "budget_remaining")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_events(events: List[Dict[str, Any]],
                    rounds: Optional[int] = None,
                    eval_every: Optional[int] = None,
                    scheme_select: Optional[str] = None,
                    reputation_mode: Optional[str] = None,
                    min_rollbacks: Optional[int] = None) -> List[str]:
    """Return a list of human-readable schema violations (empty = valid).

    ``reputation_mode="price"`` additionally requires every round row to
    carry the numeric trust-score scalars (``trust_mean`` /
    ``trust_min`` in (0, 1]); ``min_rollbacks=n`` requires at least n
    well-formed ``watchdog`` rollback events (the self-healing smoke's
    assertion that the watchdog actually fired)."""
    errs: List[str] = []
    spans: Dict[int, Dict[str, Any]] = {}
    round_rows: Dict[int, Dict[str, Any]] = {}
    dispatch_rounds: List[int] = []
    n_drains = 0
    n_rollbacks = 0

    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        kind = e.get("kind")
        if kind not in KINDS:
            errs.append(f"event {i}: unknown kind {kind!r}")
            continue
        if not _is_num(e.get("ts")) or e["ts"] < 0:
            errs.append(f"event {i} ({kind}): bad ts {e.get('ts')!r}")
        for f in REQUIRED.get(kind, ()):
            if f not in e:
                errs.append(f"event {i} ({kind}): missing field {f!r}")
        if kind == "watchdog" and e.get("name") == "rollback":
            ok_rb = True
            for f in ("round", "restored_round"):
                if not _is_num(e.get(f)):
                    errs.append(f"event {i} (watchdog rollback): "
                                f"non-numeric {f!r}: {e.get(f)!r}")
                    ok_rb = False
            if not isinstance(e.get("reason"), str):
                errs.append(f"event {i} (watchdog rollback): missing "
                            f"string 'reason', got {e.get('reason')!r}")
                ok_rb = False
            if ok_rb:
                n_rollbacks += 1
        if kind == "round" and _is_num(e.get("round")):
            r = int(e["round"])
            if r in round_rows:
                errs.append(f"round {r}: duplicate series row")
            round_rows[r] = e
        if kind == "span" and _is_num(e.get("id")):
            sid = int(e["id"])
            if sid in spans:
                errs.append(f"span id {sid}: duplicate")
            spans[sid] = e
            if e.get("name") == "round/dispatch":
                dispatch_rounds.append(int(e.get("round", -1)))
            if e.get("name") == "round/drain":
                n_drains += 1

    # span nesting
    for sid, s in spans.items():
        if not (_is_num(s.get("dur_s")) and s["dur_s"] >= 0):
            errs.append(f"span {s.get('name')} ({sid}): bad dur_s "
                        f"{s.get('dur_s')!r}")
            continue
        parent = s.get("parent")
        if parent is None:
            if s.get("depth") != 0:
                errs.append(f"span {s.get('name')} ({sid}): no parent but "
                            f"depth {s.get('depth')}")
            continue
        p = spans.get(int(parent))
        if p is None:
            errs.append(f"span {s.get('name')} ({sid}): parent {parent} "
                        "not in stream")
            continue
        if s.get("depth") != p.get("depth", -2) + 1:
            errs.append(f"span {s.get('name')} ({sid}): depth "
                        f"{s.get('depth')} under parent depth "
                        f"{p.get('depth')}")
        if s["t0"] < p["t0"] - _EPS or \
                s["t0"] + s["dur_s"] > p["t0"] + p["dur_s"] + _EPS:
            errs.append(f"span {s.get('name')} ({sid}): window "
                        f"[{s['t0']}, {s['t0'] + s['dur_s']}] escapes "
                        f"parent {p.get('name')} "
                        f"[{p['t0']}, {p['t0'] + p['dur_s']}]")

    # every round present
    if rounds is not None:
        want = set(range(int(rounds)))
        got = set(round_rows)
        if got != want:
            errs.append(f"round series: missing {sorted(want - got)}, "
                        f"unexpected {sorted(got - want)}")
        missing_d = want - set(dispatch_rounds)
        if missing_d:
            errs.append("round/dispatch spans missing for rounds "
                        f"{sorted(missing_d)}")
        if n_drains == 0:
            errs.append("no round/drain span in stream")

    # eval cadence (file sinks sanitize NaN -> null; the in-memory sink
    # keeps the raw float — both spell "no eval this round").  Rows that
    # carry the explicit ``eval_skipped`` flag are checked against it
    # directly: a null/NaN acc with eval_skipped=false is a DIVERGED
    # eval (the eval ran and came back non-finite), which is legal here
    # — the inference "null means skipped" only holds for older logs
    # that predate the flag.
    if rounds is not None and eval_every is not None:
        for r, e in sorted(round_rows.items()):
            due = eval_every <= 1 or r % eval_every == 0 \
                or r == int(rounds) - 1
            acc = e.get("test_acc")
            null_acc = acc is None or (isinstance(acc, float) and acc != acc)
            if "eval_skipped" in e:
                skipped = bool(e["eval_skipped"])
                if skipped and not null_acc:
                    errs.append(f"round {r}: eval_skipped but "
                                f"test_acc={acc!r}")
                if due and skipped:
                    errs.append(f"round {r}: eval due but skipped")
            else:
                skipped = null_acc
                if due and (skipped or not _is_num(acc)):
                    errs.append(f"round {r}: eval due but test_acc={acc!r}")
            if not due and not skipped:
                errs.append(f"round {r}: eval off-cadence but "
                            f"test_acc={acc!r} (expected null)")

    # scheme-tagged scalar series (see module docstring)
    if scheme_select is not None:
        want = _SCHEME_SCALARS + (
            _BUDGET_SCALARS if scheme_select in STATEFUL_SCHEMES else ())
        for r, e in sorted(round_rows.items()):
            for f in want:
                if not _is_num(e.get(f)):
                    errs.append(
                        f"round {r}: scheme {scheme_select!r} requires "
                        f"numeric {f!r}, got {e.get(f)!r}")

    # reputation-pricing scalar series: the continuous trust score must
    # be logged every round, and it lives in (0, 1] by construction
    if reputation_mode == "price":
        for r, e in sorted(round_rows.items()):
            for f in ("trust_mean", "trust_min"):
                v = e.get(f)
                if not _is_num(v):
                    errs.append(f"round {r}: reputation_mode='price' "
                                f"requires numeric {f!r}, got {v!r}")
                elif not 0.0 < v <= 1.0:
                    errs.append(f"round {r}: {f}={v!r} outside (0, 1]")

    # watchdog rollback floor (self-healing smoke)
    if min_rollbacks is not None and n_rollbacks < int(min_rollbacks):
        errs.append(f"watchdog: {n_rollbacks} well-formed rollback "
                    f"event(s), expected >= {min_rollbacks}")
    return errs


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: invalid JSON: {e}") from e
    return events


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Validate an obs JSONL event log against the schema.")
    ap.add_argument("path")
    ap.add_argument("--rounds", type=int, default=None,
                    help="assert one round row + dispatch span per round "
                         "in [0, N)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="assert the eval NaN/number cadence")
    ap.add_argument("--scheme-select", default=None,
                    help="assert the scheme-tagged scalar series: every "
                         "round row carries fairness_hist_std, and "
                         "stateful schemes (longterm_auction) their "
                         "budget_spent/budget_remaining ledger")
    ap.add_argument("--reputation-mode", default=None,
                    help="'price' asserts every round row carries the "
                         "numeric trust_mean/trust_min scalars in (0, 1]")
    ap.add_argument("--min-rollbacks", type=int, default=None,
                    help="assert at least N well-formed watchdog "
                         "rollback events")
    args = ap.parse_args()
    events = load_jsonl(args.path)
    errs = validate_events(events, rounds=args.rounds,
                           eval_every=args.eval_every,
                           scheme_select=args.scheme_select,
                           reputation_mode=args.reputation_mode,
                           min_rollbacks=args.min_rollbacks)
    if errs:
        for e in errs:
            print(f"SCHEMA: {e}", file=sys.stderr)
        sys.exit(1)
    n_spans = sum(e.get("kind") == "span" for e in events)
    n_rounds = sum(e.get("kind") == "round" for e in events)
    print(f"{args.path}: {len(events)} events ok "
          f"({n_rounds} round rows, {n_spans} spans)")


if __name__ == "__main__":
    main()
