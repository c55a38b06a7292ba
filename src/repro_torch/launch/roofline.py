"""Roofline analysis over the dry-run records (``repro.launch.roofline``).

For every (arch x shape x mesh) record written by repro_torch.launch.dryrun
this derives the three roofline terms (seconds per step, per card, with
an NVIDIA H100 SXM's constants from ``launch.mesh``):

    compute    = FLOPs_per_card            / 989.4e12 (dense bf16 FLOP/s)
    memory     = HBM_bytes_per_card        / 3.35e12  (HBM3 bytes/s)
    collective = collective_bytes_per_card / 450e9    (NVLink 4, a
                                                       direction)

The collective term is a floor: a 256-card mesh spans several hosts,
whose links are slower than NVLink.

Sources:
  * collective bytes — the operand bytes of every collective the dry
    run's fake step issued on rank 0 (all-gather, all-reduce,
    reduce-scatter, all-to-all), as recorded, the layer loop included;
  * compute & memory — the ANALYTIC napkin model below, the JAX
    package's term for term.  The dry run's own ``cost.flops`` (the
    matrix products of rank 0's local shards) is kept beside it;
  * temp bytes — the peak of the fake step's live storage on rank 0,
    for the fits-in-HBM check.

Analytic model (per device, bytes/flops):
  train  : FLOPs = kappa * [2·A·T + attn_quad + mixer_scan], kappa = 5
           (1 fwd + 2 bwd + 2 remat-recomputed fwd — nested remat),
           HBM = 6·P_dev (read shard fwd/bwd/remat + grad write + opt rw)
                 + 2·2·carry_saves + 12·L·B_dev·S_dev·D·b (block act rw)
                 + xent chunk logits rw
  prefill: kappa = 1, HBM = P_dev + act write
  decode : FLOPs = 2·A_tok·B + attn cache dot; HBM = P_dev + cache rw

MODEL_FLOPS = 6·N_active·D_tokens (train) or 2·N_active per token;
useful_ratio = MODEL_FLOPS / (analytic_flops x cards) exposes
remat/causal/padding waste.

Run:  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod1]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch import obs
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "runs", "dryrun_torch")


def load_records(mesh: str = "pod1", suffix: str = "",
                 results_dir: str = RESULTS_DIR) -> List[Dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(
            results_dir, f"*__{mesh}{suffix}.json"))):
        name = os.path.basename(f)
        if suffix == "" and name.count("__") != 2:
            continue   # skip suffixed variants when loading baselines
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


# ----------------------------------------------------------------------
# analytic napkin model
# ----------------------------------------------------------------------

def _param_counts(cfg):
    """(total, active, embed) parameter counts (active: MoE top-k only)."""
    from repro_torch.launch import specs as SP
    from repro_torch.models.model import flatten_params
    total = active = embed = 0
    for key, leaf in flatten_params(SP.params_shape(cfg)).items():
        n = 1
        for s in leaf.shape:
            n *= s
        ps = key.replace(".", "/")
        total += n
        if "embed" in ps:
            embed += n
            continue
        if "ffn/w_" in ps and cfg.num_experts:
            n = n * cfg.experts_per_token // cfg.num_experts
        active += n
    return total, active, embed


def analytic_terms(cfg, shape, n_dev: int, axis=(16, 16)) -> Dict:
    nd, nm = axis
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    L = cfg.num_layers
    n_attn = sum(b.mixer == "attn" for b in cfg.cycle) * cfg.num_groups \
        + cfg.encoder_layers
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    total, active, embed = _param_counts(cfg)
    pbytes = 2  # bf16

    B_dev = max(B // nd, 1)
    P_dev = total * pbytes / n_dev

    if shape.kind == "decode":
        T = B                         # one token per sequence
        win = cfg.sliding_window or S
        cache_tok = min(S, win)
        flops = 2 * active * T
        flops += 4 * B * cache_tok * H * hd * n_attn     # q·K and p·V
        # recurrent mixers: state update ~ d_inner*d_state per token
        n_rec = sum(b.mixer in ("mamba", "mlstm", "slstm")
                    for b in cfg.cycle) * cfg.num_groups
        flops += 6 * B * cfg.mamba_d_inner * cfg.mamba_d_state * n_rec
        flops_dev = flops / n_dev
        kv_itemsize = {"int8": 1, "bfloat16": 2, "float16": 2,
                       "float32": 4}.get(cfg.resolved_kv_cache_dtype, 2)
        cache_bytes = 2 * n_attn * B * cache_tok * cfg.num_kv_heads * hd \
            * kv_itemsize
        hbm_dev = P_dev + cache_bytes / n_dev * 2 + 2 * B_dev * D * L * 4
        kappa_desc = "decode"
    else:
        T = B * S
        fwd = 2 * active * T
        fwd += 4 * B * S * S * H * hd * n_attn           # full-block flash
        n_mamba = sum(b.mixer == "mamba" for b in cfg.cycle) * cfg.num_groups
        fwd += 10 * T * cfg.mamba_d_inner * cfg.mamba_d_state * n_mamba
        n_mlstm = sum(b.mixer == "mlstm" for b in cfg.cycle) * cfg.num_groups
        fwd += 4 * B * S * 256 * D * n_mlstm             # chunkwise quad
        if shape.kind == "train":
            kappa = 5.0   # fwd + 2x bwd + 2x remat recompute
            kappa_desc = "train(k=5)"
        else:
            kappa = 1.0
            kappa_desc = "prefill"
        flops_dev = kappa * fwd / n_dev
        # HBM traffic
        act = 12 * L * B_dev * (S // (nm if shape.kind == "train" else 1)) \
            * D * pbytes
        carry = 2 * 2 * L * B_dev * max(S // nm, 1) * D * pbytes
        xent = 2 * 2 * B_dev * S * (cfg.vocab_size / nm) * 4 \
            if shape.kind == "train" else 0
        hbm_dev = (6 if shape.kind == "train" else 1) * P_dev \
            + act + carry + xent

    return {
        "analytic_flops_dev": flops_dev,
        "analytic_hbm_dev": hbm_dev,
        "kappa": kappa_desc,
        "params_total": total,
        "params_active": active,
    }


def model_flops(cfg, shape) -> float:
    total, active, _ = _param_counts(cfg)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    # fwd-only shapes (prefill, decode) do 2·A·T useful FLOPs; training 6·A·T
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


# ----------------------------------------------------------------------

def roofline_terms(rec: Dict) -> Dict:
    if rec.get("status") != "ok":
        return {"status": rec.get("status", "missing"),
                "reason": rec.get("reason", rec.get("error", ""))[:100]}
    cfg = get_config(rec["arch"])
    if rec.get("kv_dtype"):
        cfg = cfg.replace(kv_cache_dtype=rec["kv_dtype"])
    shape = SHAPES_BY_NAME[rec["shape"]]
    n_dev = rec.get("n_devices", 256)
    ana = analytic_terms(cfg, shape, n_dev)
    coll = rec.get("collectives", {}).get("total", 0)
    t_comp = ana["analytic_flops_dev"] / PEAK_FLOPS_BF16
    t_mem = ana["analytic_hbm_dev"] / HBM_BW
    t_coll = coll / NVLINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / (ana["analytic_flops_dev"] * n_dev)
    step_s = max(terms.values())
    return {
        "status": "ok",
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "useful_ratio": useful,
        "mfu": (mf / n_dev / PEAK_FLOPS_BF16) / max(step_s, 1e-12),
        "temp_gib": rec.get("memory", {}).get("temp_size_in_bytes", 0) / 2**30,
        "collective_mib": coll / 2**20,
        "fake_flops_dev": rec.get("cost", {}).get("flops", 0),
    }


def format_row(rec: Dict, t: Dict) -> str:
    """One line of the table: the record's terms, or its status."""
    if t.get("status") != "ok":
        return (f"{rec['arch']:22s} {rec['shape']:12s} "
                f"-- {t['status']}: {t.get('reason', '')}")
    return (f"{rec['arch']:22s} {rec['shape']:12s} "
            f"{t['compute_s']*1e3:8.2f}m {t['memory_s']*1e3:8.2f}m "
            f"{t['collective_s']*1e3:9.2f}m {t['dominant']:>10s} "
            f"{t['useful_ratio']:7.2%} {t['mfu']:7.2%} "
            f"{t['temp_gib']:8.2f}")


HEADER = (f"{'arch':22s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
          f"{'collective':>10s} {'dominant':>10s} {'useful':>7s} "
          f"{'MFU':>7s} {'tempGiB':>8s}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--suffix", default="")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where the dry run wrote its records")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    obs.configure(quiet=args.quiet)

    recs = load_records(args.mesh, args.suffix, args.results_dir)
    rows = []
    obs.log(HEADER)
    obs.log("-" * len(HEADER))
    for rec in recs:
        t = roofline_terms(rec)
        rows.append({"arch": rec["arch"], "shape": rec["shape"],
                     "mesh": rec["mesh"], **t})
        obs.log(format_row(rec, t))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
