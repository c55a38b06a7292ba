"""FL training entry point of the port: ``--mode paper``, ``--mode
transformer`` and ``--mode selection``.

  * ``--mode paper``: the paper-faithful simulation — N edge clients with
    CNNs on a synthetic non-IID/imbalanced image dataset, clustering and
    per-cluster selection under any ``--scheme`` (the paper's auction and
    its three baselines) and any ``--scheme-select`` of the registry,
    FedAvg/FedProx aggregation and energy accounting, on the
    ``sequential``, ``vectorized`` or ``device`` runtime (``sharded``
    raises ``NotImplementedError``).
  * ``--mode transformer``: the same FL plane over a registry LM
    (``--arch``, at its smoke config, as the JAX CLI trains it):
    next-token training on topic-conditional token sequences
    (``make_token_dataset``), partitioned non-IID by topic.  The dense
    archs run (qwen2-0.5b, qwen1.5-4b, qwen1.5-32b, starcoder2-3b,
    phi-3-vision-4.2b without its image prefix); the others raise
    ``NotImplementedError``.
  * ``--mode selection``: the selection-only simulation — the per-round
    auction and energy dynamics without training, over a synthetic fleet
    (``core/rounds.simulate_rounds``), at up to a million clients.  It
    runs twice: ``rounds_per_s`` is the second (warm) run's rate, and
    ``compile_s`` the first run's seconds less the second's.  Eager
    PyTorch compiles nothing, so here that is the first use's overhead
    (kernel loading, allocator growth); ``--no-warm-rerun`` skips the
    second run and reports the first.

Fleet dynamics (``--churn``, ``--deadline``, ``--straggler-profile``,
``--aggregation buffered``, ``--buffer-goal``, ``--buffer-timeout``), the
Byzantine-tolerant path (``--adversary-frac``, ``--attack``,
``--attack-scale``, ``--defense``, ``--defense-mode``,
``--reputation-mode``) and the divergence watchdog (``--watchdog``,
``--watchdog-ring``), checkpoints (``--checkpoint-every``,
``--checkpoint-path``, ``--resume``) and the event stream
(``--log-jsonl``, ``--log-csv``, validated by ``python -m
repro_torch.obs.schema``; ``--audit-sync``, ``--profile-dir``) run as in
the JAX package.

It takes the JAX CLI's flags with the same defaults (``python -m
repro.launch.train``), plus ``--device``:

  python -m repro_torch.launch.train --mode paper              # on cuda
  python -m repro_torch.launch.train --mode paper --device cpu
  python -m repro_torch.launch.train --mode paper --runtime device
  python -m repro_torch.launch.train --mode paper --scheme random
  python -m repro_torch.launch.train --mode transformer --arch starcoder2-3b
  python -m repro_torch.launch.train --mode selection --clients 1000000
  python -m repro_torch.launch.train --mode paper --runtime vectorized \
      --churn 0.1 --deadline 1.5 --aggregation buffered \
      --log-jsonl runs/events.jsonl --audit-sync
  python -m repro_torch.launch.train --mode paper --runtime device \
      --adversary-frac 0.3 --attack sub_clip --defense clip \
      --defense-mode adaptive --reputation-mode price --watchdog on

The run is on the GPU unless ``--device cpu`` is given; ``cuda`` with no
GPU raises.  TF32 is switched off for matmuls and cuDNN, so float32 stays
float32.  A flag whose feature is not ported yet is still parsed, and a
non-default value raises ``NotImplementedError`` (ROADMAP.md, queue 1:
the sharded runtime and ``--cohort-devices``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs, rng
from repro_torch.configs.base import FLConfig
from repro_torch.core import rounds as RND
from repro_torch.core.adapters import cnn_adapter, transformer_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import partition_clients
from repro_torch.data.synthetic import make_image_dataset, make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.sim import dynamics as DYN

# flags of the JAX CLI whose features the port does not have yet
UNPORTED_FLAGS = ("cohort_devices",)


def set_float32_precision() -> None:
    """Full float32 everywhere: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_paper(args, device: torch.device, assign_fn=None) -> dict:
    cfg = FLConfig(
        num_clients=args.clients, num_clusters=args.clusters,
        select_ratio=args.select_ratio, rounds=args.rounds,
        local_epochs=args.local_epochs, lr=args.lr,
        non_iid_level=args.nu, scheme=args.scheme,
        scheme_select=args.scheme_select,
        fedcs_deadline=args.fedcs_deadline, aggregator=args.aggregator,
        init_energy_mode=args.energy_mode, runtime=args.runtime,
        eval_every=args.eval_every, seed=args.seed,
        churn=args.churn, deadline=args.deadline,
        straggler_profile=args.straggler_profile,
        aggregation=args.aggregation, buffer_goal=args.buffer_goal,
        buffer_timeout=args.buffer_timeout,
        adversary_frac=args.adversary_frac, attack=args.attack,
        attack_scale=args.attack_scale, defense=args.defense,
        defense_mode=args.defense_mode,
        reputation_mode=args.reputation_mode,
        watchdog=args.watchdog, watchdog_ring=args.watchdog_ring)
    train, test = make_image_dataset(args.dataset, n_train=args.pool,
                                     n_test=args.pool // 6, seed=args.seed,
                                     device=device)
    clients = partition_clients(train.y, cfg, seed=args.seed)
    adapter = cnn_adapter(args.dataset, device)
    ntest = min(1000, len(test.x))
    srv = FederatedServer(cfg, adapter, train.x, train.y, clients,
                          {"x": test.x[:ntest], "y": test.y[:ntest]},
                          assign_fn=assign_fn, device=device)
    t0 = time.time()
    logs = srv.run(verbose=not args.quiet, audit_sync=args.audit_sync,
                   checkpoint_every=args.checkpoint_every,
                   checkpoint_path=args.checkpoint_path,
                   resume=args.resume)
    out = {
        "mode": "paper", "scheme": args.scheme,
        "scheme_select": args.scheme_select, "nu": args.nu,
        "aggregator": args.aggregator, "dataset": args.dataset,
        "runtime": args.runtime, "device": str(device),
        "rounds": [l.round for l in logs],
        "test_acc": [l.test_acc for l in logs],
        "test_loss": [l.test_loss for l in logs],
        "energy_std": [l.energy_std for l in logs],
        "mean_bid": [l.mean_bid for l in logs],
        "server_reward": [l.server_reward for l in logs],
        "client_reward_sum": [l.client_reward_sum for l in logs],
        "vds_gap": [l.vds_gap for l in logs],
        "selected": [l.selected.tolist() for l in logs],
        "num_selected": [int(l.selected.size) for l in logs],
        "params_finite": all(bool(torch.isfinite(v).all())
                             for v in srv.params.values()),
        "wall_s": time.time() - t0,
    }
    if srv.dynamics:
        codes = (np.concatenate(srv.outcome_log) if srv.outcome_log
                 else np.zeros((0,), np.int32))
        out["dynamics"] = {
            "churn": cfg.churn, "deadline": cfg.deadline,
            "aggregation": cfg.aggregation,
            "num_completed": int((codes == DYN.COMPLETED).sum()),
            "num_late": int((codes == DYN.LATE).sum()),
            "num_dropped": int((codes == DYN.DROPPED).sum()),
        }
    if srv.defended:
        out["defense"] = {
            "attack": cfg.attack, "adversary_frac": cfg.adversary_frac,
            "defense": cfg.defense, "defense_mode": cfg.defense_mode,
            "reputation_mode": cfg.reputation_mode,
            "num_adversaries": int(srv._adv_mask.sum()),
            "num_quarantined": srv.defense_totals["quarantined"],
            "num_screened": srv.defense_totals["screened"],
            "num_banned_final": srv.defense_totals["banned_final"],
        }
    if cfg.watchdog_enabled:
        out["watchdog"] = {
            "ring": cfg.watchdog_ring,
            "rollbacks": srv.watchdog_totals["rollbacks"],
            "snapshots": srv.watchdog_totals["snapshots"],
        }
    return out


def run_transformer(args, device: torch.device) -> dict:
    """FL over ``--arch``'s smoke config: the JAX CLI's FLConfig (a fifth
    of ``--clients``, at least 10; 5 clusters; a fifth selected), token
    data and 64-sequence test set."""
    from repro_torch.configs.registry import get_smoke_config
    mcfg = get_smoke_config(args.arch)
    adapter = transformer_adapter(mcfg, device)     # refuses unported archs
    cfg = FLConfig(
        num_clients=max(10, args.clients // 5), num_clusters=5,
        select_ratio=0.2, rounds=args.rounds, lr=args.lr,
        non_iid_level=args.nu, scheme=args.scheme, num_classes=10,
        scheme_select=args.scheme_select,
        fedcs_deadline=args.fedcs_deadline,
        sample_window=8, cluster_resamples=2, runtime=args.runtime,
        cohort_mesh_devices=args.cohort_devices,
        eval_every=args.eval_every, seed=args.seed,
        churn=args.churn, deadline=args.deadline,
        straggler_profile=args.straggler_profile,
        aggregation=args.aggregation, buffer_goal=args.buffer_goal,
        buffer_timeout=args.buffer_timeout)
    toks, topics = make_token_dataset(
        num_topics=10, vocab=mcfg.vocab_size, seq_len=32,
        n=cfg.num_clients * 40, seed=args.seed)
    clients = partition_clients(topics, cfg, seed=args.seed)
    test_n = min(64, len(toks))
    srv = FederatedServer(cfg, adapter, toks, topics, clients,
                          {"x": toks[:test_n], "y": topics[:test_n]},
                          device=device)
    t0 = time.time()
    logs = srv.run(verbose=not args.quiet, audit_sync=args.audit_sync)
    return {
        "mode": "transformer", "arch": args.arch, "scheme": args.scheme,
        "scheme_select": args.scheme_select, "runtime": args.runtime,
        "device": str(device),
        "rounds": [l.round for l in logs],
        "test_loss": [l.test_loss for l in logs],
        "test_acc": [l.test_acc for l in logs],
        "energy_std": [l.energy_std for l in logs],
        "selected": [l.selected.tolist() for l in logs],
        "wall_s": time.time() - t0,
    }


def log_summaries(result: dict) -> None:
    """The JAX CLI's closing ``defense ...`` and ``watchdog: ...`` lines,
    word for word."""
    if "defense" in result:
        d = result["defense"]
        obs.log(f"defense {d['defense']!r} ({d['defense_mode']}, "
                f"reputation={d['reputation_mode']}) vs attack "
                f"{d['attack']!r}: adversaries={d['num_adversaries']} "
                f"quarantined={d['num_quarantined']} "
                f"screened={d['num_screened']} "
                f"banned={d['num_banned_final']}", always=True)
    if "watchdog" in result:
        w = result["watchdog"]
        obs.log(f"watchdog: rollbacks={w['rollbacks']} "
                f"snapshots={w['snapshots']} (ring={w['ring']})",
                always=True)


def run_selection(args, device: torch.device) -> dict:
    """Selection-only round dynamics at scale: every round's metrics stay
    on the device and are fetched in one copy after the run."""
    cfg = FLConfig(
        num_clients=args.clients, num_clusters=args.clusters,
        select_ratio=args.select_ratio, rounds=args.rounds,
        scheme=args.scheme, scheme_select=args.scheme_select,
        fedcs_deadline=args.fedcs_deadline,
        init_energy_mode=args.energy_mode, seed=args.seed)
    key = rng.PRNGKey(args.seed)
    state = RND.synthetic_fleet(cfg, key, device=device)
    kr = rng.fold_in(key, 1)
    t0 = time.time()
    with obs.span("selection/cold"):
        final, metrics, _ = RND.simulate_rounds(state, cfg, kr, args.rounds)
        names = list(metrics)
        # one counted device-to-host copy for all T rounds (int metrics
        # are exact in float64)
        host = (obs.device_get(torch.stack([metrics[k].double()
                                            for k in names]))
                if names else None)
        metrics = {k: host[i] for i, k in enumerate(names)}
    cold = time.time() - t0
    if args.no_warm_rerun:
        warm, compile_s = cold, None
    else:
        t1 = time.time()
        with obs.span("selection/warm"):
            RND.simulate_rounds(state, cfg, kr, args.rounds)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        warm = time.time() - t1
        compile_s = max(cold - warm, 0.0)
    out = {
        "mode": "selection", "scheme": args.scheme,
        "scheme_select": args.scheme_select,
        "clients": args.clients, "clusters": args.clusters,
        "device": str(device),
        "rounds": list(range(args.rounds)),
        "energy_std": [float(v) for v in metrics["energy_std"]],
        "mean_bid": [float(v) for v in metrics["mean_bid"]],
        "server_reward": [float(v) for v in metrics["server_reward"]],
        "client_reward_sum": [float(v)
                              for v in metrics["client_reward_sum"]],
        "num_winners": [int(v) for v in metrics["num_winners"]],
        "final_energy_mean": float(final.residual.mean()),
        "rounds_per_s": args.rounds / warm,
        "compile_s": compile_s,
        # one simulation, the first use included (the warm re-run is not)
        "wall_s": cold,
    }
    timing = "incl. first use" if compile_s is None \
        else f"warm; compile={compile_s:.2f}s"
    # mirror the fetched metric columns into the obs round series (host
    # floats already in hand: no extra device traffic)
    if obs.OBS.enabled:
        for t in range(args.rounds):
            obs.OBS.record_round(
                t, energy_std=out["energy_std"][t],
                mean_bid=out["mean_bid"][t],
                server_reward=out["server_reward"][t],
                client_reward_sum=out["client_reward_sum"][t],
                num_winners=out["num_winners"][t],
                fairness_hist_std=float(metrics["fairness_hist_std"][t]),
                **{k: float(metrics[k][t]) for k in
                   ("budget_spent", "budget_remaining", "budget_queue")
                   if k in metrics})
        obs.flush()
    obs.log(f"selection-only: N={args.clients} T={args.rounds} "
            f"{out['rounds_per_s']:.1f} rounds/s ({timing}) "
            f"final_energy_std={out['energy_std'][-1]:.3f}", always=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="paper",
                    choices=["paper", "transformer", "selection"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes (cuda raises without a "
                         "GPU; there is no silent CPU fallback)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "fmnist", "cifar"])
    ap.add_argument("--scheme", default="gradient_cluster_auction")
    ap.add_argument("--scheme-select", default="paper",
                    choices=["paper", "random", "fedcs",
                             "longterm_auction"])
    ap.add_argument("--fedcs-deadline", type=float, default=1.5)
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "fedprox"])
    ap.add_argument("--runtime", default="sequential",
                    choices=["sequential", "vectorized", "sharded",
                             "device"])
    ap.add_argument("--cohort-devices", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--clusters", type=int, default=10)
    ap.add_argument("--select-ratio", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--nu", type=float, default=1.0)
    ap.add_argument("--pool", type=int, default=12000)
    ap.add_argument("--energy-mode", default="normal",
                    choices=["full", "normal"])
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--straggler-profile", default="energy",
                    choices=["energy", "uniform", "lognormal", "none"])
    ap.add_argument("--aggregation", default="sync",
                    choices=["sync", "buffered"])
    ap.add_argument("--buffer-goal", type=int, default=4)
    ap.add_argument("--buffer-timeout", type=int, default=4)
    ap.add_argument("--adversary-frac", type=float, default=0.0)
    ap.add_argument("--attack", default="none",
                    choices=["none", "nan", "scale", "signflip", "noise",
                             "sub_clip", "alie", "on_off"])
    ap.add_argument("--attack-scale", type=float, default=25.0)
    ap.add_argument("--defense", default="none",
                    choices=["none", "clip", "trimmed", "median"])
    ap.add_argument("--defense-mode", default="static",
                    choices=["static", "adaptive"])
    ap.add_argument("--reputation-mode", default="ban",
                    choices=["ban", "price"])
    ap.add_argument("--watchdog", default="off", choices=["off", "on"])
    ap.add_argument("--watchdog-ring", type=int, default=3)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-path", default=None, metavar="PATH")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-warm-rerun", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--log-jsonl", default=None, metavar="PATH")
    ap.add_argument("--log-csv", default=None, metavar="PATH")
    ap.add_argument("--profile-dir", default=None, metavar="DIR")
    ap.add_argument("--audit-sync", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None, *, assign_fn=None) -> dict:
    """Run the CLI on ``argv``.  ``assign_fn`` (a caller's hook, no flag)
    overrides stage 1's k-means assignment, as ``FederatedServer``'s
    ``assign_fn`` does."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest in UNPORTED_FLAGS:
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet "
                "(ROADMAP.md, queue 1: the sharded runtime and "
                "--cohort-devices); leave it at its default")
    set_float32_precision()
    device = resolve_device(args.device)
    attached = obs.OBS.sinks
    obs.configure(jsonl=args.log_jsonl, csv=args.log_csv, quiet=args.quiet)
    try:
        with obs.maybe_profile(args.profile_dir):
            if args.mode == "selection":
                result = run_selection(args, device)
            elif args.mode == "transformer":
                result = run_transformer(args, device)
            else:
                result = run_paper(args, device, assign_fn)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
            obs.log(f"wrote {args.out}", always=True)
        if result.get("test_acc"):
            obs.log(f"final acc={result['test_acc'][-1]:.3f} "
                    f"energy_std={result['energy_std'][-1]:.3f} "
                    f"wall={result['wall_s']:.0f}s", always=True)
        log_summaries(result)
    finally:
        # flush, and close the sinks this call attached (a caller's stay)
        obs.OBS.close_sinks(keep=attached)
    return result


if __name__ == "__main__":
    main()
