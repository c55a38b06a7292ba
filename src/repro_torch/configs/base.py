"""Config system of the port: copies of the JAX package's two families.

* :class:`ModelConfig` — architecture description for the model zoo
  (dense / moe / ssm / hybrid / encdec(audio) / vlm), with its layer
  ``cycle`` of (mixer, ffn) block kinds, plus :class:`ShapeConfig` and
  ``INPUT_SHAPES``.  Field for field and default for default the JAX
  package's, so one config drives both packages; the port's model code
  runs the dense ``("attn", "mlp")`` cycles and refuses the rest (see
  ``repro_torch.models.model``).
* :class:`FLConfig` — the paper's federated-learning system knobs
  (Table I defaults).  The port runs only the slice of these knobs its
  modules implement; every other value is refused where it would be used
  (see ``repro_torch.core.server``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# Block kinds usable in a cycle. mixer: how tokens mix along the sequence;
# ffn: the per-token channel mixer.
MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


@dataclass(frozen=True)
class BlockSpec:
    """One position in an architecture's layer cycle."""

    mixer: str = "attn"
    ffn: str = "mlp"

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Shapes follow the assignment table."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0     # 0 -> no RoPE (see learned_pos)
    learned_pos: bool = False        # learned absolute positions (whisper)
    sliding_window: int = 0          # 0 -> full attention
    mlp_kind: str = "swiglu"         # swiglu | gelu

    # --- layer cycle (heterogeneous stacks) ---
    cycle: Tuple[BlockSpec, ...] = (BlockSpec("attn", "mlp"),)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0             # expert hidden size (may differ from d_ff)
    moe_capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # --- Mamba (selective SSM) ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # --- xLSTM ---
    xlstm_num_heads: int = 4

    # --- encoder-decoder (whisper-style audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stub frame-embedding count

    # --- multimodal prefix (vlm) ---
    num_prefix_tokens: int = 0       # patch embeddings occupying first slots

    # --- numerics / misc ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # parameter / activation dtype
    tie_embeddings: bool = False
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    kv_cache_dtype: str = "auto"     # auto (= dtype) | bfloat16 | int8
    # "auto" inherits the model dtype: a float32 model quietly caching K/V
    # in bfloat16 loses ~3 decimal digits per slot, which discrete MoE
    # routing amplifies into expert flips (decode no longer matches the
    # forward pass). int8 stays an explicit serving opt-in.
    attn_impl: str = "chunked"       # chunked (blockwise torch) | naive |
    # pallas: the hand-written CUDA flash_attention (the name is the JAX
    # package's, where it selects the Pallas TPU kernel)
    remat: bool = True               # activation checkpointing over blocks
    remat_policy: str = "nothing"    # nothing | save_block_out: keep each
    # block's (seq-sharded) output so the backward pass skips the recompute
    # forward — trades ~2 x L x B x S/16 x D bytes for one whole forward's
    # FLOPs AND collectives (hillclimb lever, EXPERIMENTS.md §Perf).
    fsdp_gather_weights: bool = False  # gather FSDP weight shards on use
    # instead of computing sharded contractions (which all-reduces the much
    # larger activations). Hillclimb lever — see EXPERIMENTS.md §Perf.
    source: str = ""                 # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def cycle_len(self) -> int:
        return len(self.cycle)

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.cycle_len == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"cycle length {self.cycle_len}")
        return self.num_layers // self.cycle_len

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def resolved_kv_cache_dtype(self) -> str:
        return self.dtype if self.kv_cache_dtype == "auto" \
            else self.kv_cache_dtype

    def supports_long_context(self) -> bool:
        """True if decode state is sub-quadratic in context (prompt rule for
        long_500k): recurrent mixers or bounded (sliding-window) KV."""
        has_full_attn = any(b.mixer == "attn" for b in self.cycle)
        if not has_full_attn:
            return True                      # pure SSM / xLSTM
        if self.sliding_window > 0:
            return True                      # bounded KV window
        # hybrid: a minority of full-attn layers still needs full KV, but the
        # state is dominated by the recurrent layers; jamba runs 256k context
        # in practice -> allow when attn layers are a strict minority.
        n_attn = sum(b.mixer == "attn" for b in self.cycle)
        return self.family == "hybrid" and n_attn * 2 < self.cycle_len

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


# ----------------------------------------------------------------------
# Federated-learning system config (the paper, Table I defaults)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class FLConfig:
    """Auction-based clustered FL system parameters (paper Table I)."""

    num_clients: int = 100
    num_clusters: int = 10           # J
    select_ratio: float = 0.10       # K / N
    local_epochs: int = 1            # I
    local_momentum: float = 0.0      # client-side SGD momentum
    rounds: int = 100                # T
    lr: float = 0.05

    # clustering stage
    sample_window: int = 50          # s_mm
    cluster_resamples: int = 5       # T0
    cluster_feature_dim: int = 256   # projected gradient feature size

    # energy model
    energy_per_100_samples: float = 0.2   # rho
    energy_rx: float = 0.01               # E^re per round (receive global model)
    energy_tx: float = 0.01               # E^se per round (send local model)
    init_energy_mode: str = "full"        # full | normal  (case1 / case2)
    init_energy_mean: float = 0.75
    init_energy_std: float = 0.10
    init_energy_low: float = 0.50
    init_energy_high: float = 1.00

    # cost function (Table I)
    phi: float = 0.5        # resource-cost base, 0<phi<1
    vartheta: float = 0.5   # service-cost sample base
    chi: float = 0.7        # weight of sample term in Cs
    zeta: float = 0.3       # weight of history term in Cs (chi+zeta=1)
    log_a: float = 2.0      # log base in history term
    alpha: float = 0.7      # weight of service cost in c
    gamma: float = 0.3      # weight of resource cost in c (alpha+gamma=1)
    history_verbatim: bool = False  # eq 13 exactly as printed (see auction.py)

    # reward model
    reward_model: str = "bid_share"   # per-sample share (eq 15) | bid_share (eq 16)
    total_reward: float = 100.0       # Rg
    target_rounds: int = 100          # Nr

    # aggregation
    aggregator: str = "fedavg"        # fedavg | fedprox
    fedprox_mu: float = 0.01

    # fleet dynamics (repro.sim.dynamics) — all off by default so the
    # round-synchronous paper repro stays bit-identical; any churn or a
    # positive deadline turns the fault model on (dynamics_enabled).
    churn: float = 0.0          # per-round dropout prob (availability +
    #                             mid-round); 0 disables the churn process
    rejoin_prob: float = 0.5    # per-round arrival prob of an unavailable
    #                             client (the churn process's return edge)
    deadline: float = 0.0       # FedCS-style round deadline in units of
    #                             the fleet-mean compute+network latency;
    #                             0 = no deadline (nobody is ever late)
    straggler_profile: str = "energy"   # energy | uniform | lognormal |
    #   none — how per-client latency scale is sampled. 'energy' ties the
    #   slowdown to the residual-energy heterogeneity profile (low-energy
    #   clients are up to ~3x slower), the paper-consistent default.
    aggregation: str = "sync"   # sync | buffered. 'sync' re-weights the
    #   FedAvg over deadline survivors each round; 'buffered' additionally
    #   lands late updates in a device-resident buffer folded FedBuff-
    #   style (staleness-weighted) at goal-count or timeout boundaries.
    buffer_goal: int = 4        # fold the late buffer when this many
    #                             updates have arrived...
    buffer_timeout: int = 4     # ...or when the oldest arrived entry has
    #                             waited this many rounds, whichever first
    staleness_alpha: float = 0.5   # staleness discount exponent: a late
    #   update folded tau rounds after dispatch is scaled by
    #   (1 + tau) ** -alpha (FedBuff's 1/sqrt(1+tau) at the default)
    replace_dropped: bool = True   # retry-or-replace: resample a dropped
    #   winner's slot from its cluster's available non-winners

    @property
    def dynamics_enabled(self) -> bool:
        """True when the client-dynamics fault model is active.  The
        guard the churn-0 bit-identity regression rests on: with no
        churn and no deadline every dynamics code path is skipped and
        the round programs are the exact pre-dynamics traces."""
        return self.churn > 0.0 or self.deadline > 0.0

    # Byzantine robustness (repro.sim.dynamics corruption model +
    # repro.core.aggregation screened FedAvg) — all off by default so
    # the paper repro stays bit-identical to the pre-defense traces.
    adversary_frac: float = 0.0   # fixed fraction of the fleet that is
    #   Byzantine: round(frac * N) clients drawn once per run from the
    #   dedicated adversary PRNG chain corrupt every update they send
    attack: str = "none"          # none | nan | scale | signflip | noise
    #   | sub_clip | alie | on_off — how an adversary perturbs its param
    #   delta after local training (on device, before aggregation); the
    #   last three are ADAPTIVE attacks that observe the defense's
    #   running state (sub_clip sits just under the clip EMA threshold,
    #   alie hides inside the honest coordinate spread, on_off alternates
    #   clean/dirty phases to farm reputation); see
    #   dynamics.corrupt_updates
    attack_scale: float = 25.0    # magnitude knob: multiplier for
    #   scale/signflip, noise-std multiple of the cohort RMS for noise
    sub_clip_margin: float = 0.9  # sub_clip: the attacker targets this
    #   fraction of the STATIC clip threshold (clip_mult x clip EMA) so
    #   a fixed-threshold clip defense never touches it
    alie_z: float = 1.0           # alie: colluders move to honest mean
    #   minus z x per-coordinate honest std (small z stays inside the
    #   trimmed-mean band)
    onoff_period: int = 2         # on_off: attack for this many rounds,
    #   then behave for as many (strike decay farms reputation back)
    defense: str = "none"         # none | clip | trimmed | median —
    #   robust aggregation applied to the per-update matrix: all three
    #   non-none defenses first QUARANTINE non-finite rows (excluded
    #   from the weighted sum, survivor weights renormalized), then
    #   'clip' l2-clips each row to clip_mult x a running median norm,
    #   'trimmed'/'median' replace the weighted mean coordinate-wise
    defense_mode: str = "static"  # static | adaptive. 'static' keeps the
    #   original fixed thresholds (clip_mult, trim_frac).  'adaptive'
    #   auto-tunes the screen from device-resident running statistics:
    #   a survivor-norm median/MAD band (norms above
    #   median + k_eff x MAD are screened out and struck), where k_eff
    #   tightens as the quarantine/outlier pressure EMA rises and
    #   relaxes back as it falls — see aggregation.DefenseState
    adapt_k: float = 3.0          # adaptive screen: base MAD multiplier
    #   of the outlier band (k_eff = adapt_k / (1 + adapt_gain * press))
    adapt_gain: float = 4.0       # how hard attack pressure tightens k
    pressure_beta: float = 0.2    # EMA rate of the pressure statistic
    adapt_mad_floor: float = 0.05  # MAD floor as a fraction of the
    #   running median norm (a zero-spread cohort must not ban everyone)
    outlier_strike: float = 0.5   # reputation strikes earned per
    #   adaptive-screen exclusion (quarantine always strikes 1.0)
    clip_mult: float = 2.0        # clip threshold = clip_mult * running
    #                               median of per-update l2 norms
    clip_beta: float = 0.3        # EMA rate of that running median
    trim_frac: float = 0.3        # trimmed mean: ceil(frac * V) rows
    #                               trimmed from EACH tail per coordinate
    strike_threshold: float = 2.0  # auction reputation: a client with
    #   this many (decayed) quarantine strikes loses eligibility
    strike_decay: float = 0.98    # per-round multiplicative strike decay
    #   (banned clients eventually fall below threshold and get re-probed)
    reputation_mode: str = "ban"  # ban | price. 'ban' is the original hard
    #   gate (strikes >= strike_threshold lose auction eligibility,
    #   bit-identical traces).  'price' keeps every client eligible but
    #   multiplies the reputation penalty into the effective bid the
    #   winner ranking sees (auction.effective_bids): a tainted client
    #   must bid cheaper to win, and recovers as strikes decay
    rep_price_gain: float = 1.0   # price mode: effective bid =
    #   bid * (1 + gain * strikes); rewards still pay the TRUE bid

    # divergence watchdog (repro.core.server): ring of the last K healthy
    # snapshots + a detector on the drained eval stream (non-finite eval,
    # loss spike vs EMA, accuracy collapse); a trigger restores the
    # newest healthy snapshot, tightens the defense, decays the server
    # step scale and resumes on a perturbed key chain.  'off' (default)
    # keeps every code path and trace untouched.
    watchdog: str = "off"          # off | on
    watchdog_ring: int = 3         # snapshots kept in the rollback ring
    watchdog_loss_mult: float = 2.5  # trigger: loss > mult * loss EMA
    watchdog_acc_drop: float = 0.25  # trigger: acc < peak acc - drop
    watchdog_lr_decay: float = 0.5   # server step scale multiplier per
    #   rollback (device scalar — never retraces); 1.0 disables
    watchdog_tighten: float = 1.5    # defense tightening per rollback:
    #   the screen thresholds divide by this cumulative factor

    @property
    def adversary_enabled(self) -> bool:
        """True when corrupted-update injection is active."""
        return self.adversary_frac > 0.0 and self.attack != "none"

    @property
    def watchdog_enabled(self) -> bool:
        """True when the divergence watchdog (snapshot ring + detector +
        rollback policy) is active.  False is the guard the watchdog-off
        bit-identity regression rests on: no ring, no detector, no
        server step scale — the pre-watchdog code path runs untouched."""
        return self.watchdog == "on"

    @property
    def defended(self) -> bool:
        """True when the server must route stage-3 through the
        per-update screened-aggregation path (repro.core.aggregation)
        instead of the runtimes' fused FedAvg.  False is the guard the
        defense-off bit-identity regression rests on: with no defense
        and no adversary the pre-defense code path runs untouched."""
        return self.defense != "none" or self.adversary_enabled

    # data heterogeneity (paper §V-A)
    non_iid_level: float = 1.0        # nu: fraction of a client's data w/ one label
    imbalance_low: float = 1.0 / 6.0  # local size in [varpi/6, 2*varpi]
    imbalance_high: float = 2.0
    num_classes: int = 10

    # selection scheme under test
    scheme: str = "gradient_cluster_auction"
    # gradient_cluster_auction | gradient_cluster_random |
    # weights_cluster_random  | random

    # control-plane selection scheme (repro.core.schemes registry):
    # which per-round winner-pick program the fused round control plane
    # compiles.  'paper' routes through selection.select_round exactly
    # as before (itself dispatching on cfg.scheme above — the paper's
    # own four baselines), so the default stays bit-identical to the
    # pre-registry traces; the competitors are 'random' (uniform
    # per-cluster, availability-aware), 'fedcs' (deadline-feasibility
    # gating on predicted latency at bid time, arXiv:1804.08333) and
    # 'longterm_auction' (inter-round budget/payment state threaded as
    # SelectionState.scheme_state, arXiv:2508.09181).
    scheme_select: str = "paper"
    # fedcs: predicted-latency feasibility bound (in fleet-mean round
    # times, same units as cfg.deadline) used at bid time when
    # cfg.deadline == 0; a positive cfg.deadline takes precedence so the
    # auction gates on the same deadline the fault model enforces
    fedcs_deadline: float = 1.5

    # cohort execution backend (repro.sim): 'sequential' runs the
    # reference per-client loop; 'vectorized' runs whole cohorts as one
    # compiled vmap/scan program per size bucket; 'sharded' additionally
    # maps each bucket's client axis over the cohort mesh's 'data' axis
    # (shard_map, replicated params, psum FedAvg); 'device' keeps the
    # whole fleet's data resident on device in static capacity-class
    # tensors — per-round cohort assembly is an on-device gather and
    # nothing retraces after warm-up (see DESIGN.md
    # §Round pipeline).
    runtime: str = "sequential"
    # evaluate test accuracy/loss every this many rounds (1 = every
    # round, the paper's cadence; the final round always evaluates,
    # skipped rounds log NaN). Evaluation results are fetched only at
    # logging boundaries, so together with the device-buffered round
    # metrics this sets the async dispatch depth of FederatedServer.run.
    eval_every: int = 1
    # devices on the cohort mesh's data axis for runtime='sharded';
    # 0 = all local devices. Degrades to the 1-device debug mesh.
    cohort_mesh_devices: int = 0
    # client-axis vmap width inside one compiled cohort program; chunks of
    # this width run under lax.map so the per-chunk working set stays
    # cache-resident on CPU (full-width vmap thrashes; measured 1.4-2x
    # slower). Must be a power of two.
    cohort_vmap_width: int = 4

    seed: int = 0

    def replace(self, **kw) -> "FLConfig":
        return dataclasses.replace(self, **kw)
