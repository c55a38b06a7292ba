"""Multi-pod dry run (``repro.launch.dryrun``): prove the distribution
config is coherent without the cards.  For every (architecture x input
shape x mesh) this runs the real train / serve / FL-round step once on
the production mesh (``launch.mesh.make_production_mesh``: a
``DeviceMesh`` over a fake process group of 256 or 512 ranks, this
process rank 0), with the parameters, batch and caches as DTensors
placed by the port's rules (``sharding.rules``) over *fake* local
shards (``FakeTensorMode``: shapes, dtypes and devices, no memory, no
arithmetic).  The model's ``maybe_constrain`` points redistribute
activations as the JAX package's constraints do (``sharding.constrain``).
What rank 0 dispatches on its local shards is tallied:

  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``,
    the local shards' bytes of the step's inputs and outputs, exact;
    ``temp_size_in_bytes``, the peak of the live bytes of the storages
    the step made (the outputs' included while they live);
  * ``cost.flops``: the matrix products of the local shards, by
    ``torch.utils.flop_counter``'s formulas (elementwise work is not
    counted);
  * ``collectives``: operand bytes of every all-gather, all-reduce,
    reduce-scatter and all-to-all the step issued, by kind, with
    ``count``, ``total`` and ``cross_pod``: the bytes of those whose
    group spans the ``pod`` mesh dimension (``collective-permute`` stays
    0: DTensor issues none);
  * ``model_flops``, ``n_params``, ``n_devices``, and ``lower_s``, the
    seconds of the fake run (placement included).

The JAX record's XLA-only keys are left out: ``hlo_bytes``,
``generated_code_size_in_bytes``, ``static_total`` and ``compile_s``.

A combo whose fake run raises is recorded as ``error`` and makes the
CLI exit 1.  Records go to ``runs/dryrun_torch/``.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
          --shape train_4k [--multi-pod] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import INPUT_SHAPES, SHAPES_BY_NAME
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import RESULTS_DIR, _param_counts
from repro_torch.launch.steps import (make_fl_round_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import model as MD
from repro_torch.sharding import rules as R
from repro_torch.sharding.constrain import tally_loops, use_mesh

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# _c10d_functional ops (DTensor's collectives) by kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors."""
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _make_tally_mode():
    """A FakeTensorMode that tallies what rank 0 dispatches on its local
    shards (DTensor ops reach it only as their local ops)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry

    class TallyMode(FakeTensorMode):
        def __init__(self, pod_of):
            # DeviceMesh keeps real rank tables: let them in
            super().__init__(allow_non_fake_inputs=True)
            self.pod_of = pod_of        # rank -> pod index, or None
            self.counting = False
            self.muted = False
            self.flops = 0
            self.coll = {k: 0 for k in _COLLECTIVES}
            self.coll.update(count=0, cross_pod=0)
            self.live = self.peak = 0
            self._storages: Dict[int, int] = {}
            self._in_product = False
            self._groups: Dict[str, bool] = {}

        def dispatch(self, func, types, args=(), kwargs=None):
            if self.muted or any(issubclass(t, DTensor) for t in types):
                # a DTensor op (its local ops come here on their own), or
                # DTensor's shape inference on global-shaped fakes
                return super().dispatch(func, types, args, kwargs)
            kwargs = kwargs or {}
            product = (self.counting and not self._in_product
                       and func.overloadpacket in flop_registry)
            self._in_product |= product
            try:
                out = super().dispatch(func, types, args, kwargs)
            finally:
                if product:
                    self._in_product = False
            if product:
                self.flops += flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
            if self.counting:
                self._collective(func, args)
            self._storage(out)
            return out

        @contextlib.contextmanager
        def trips(self, n: int):
            """What one trip of a loop dispatches, counted ``n`` times
            (``constrain.loop_trips``)."""
            flops, coll = self.flops, dict(self.coll)
            yield
            self.flops += (self.flops - flops) * (n - 1)
            for k, v in coll.items():
                self.coll[k] += (self.coll[k] - v) * (n - 1)

        def _storage(self, out):
            for t in _tensors(out):
                st = t.untyped_storage()
                key = id(st)
                if key in self._storages:
                    continue
                nbytes = st.nbytes() if self.counting else 0
                self._storages[key] = nbytes
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)

        def _free(self, key):
            self.live -= self._storages.pop(key, 0)

        def _collective(self, func, args):
            ns, _, name = func._schema.name.partition("::")
            kind = _KINDS.get(name.rstrip("_"))
            if ns != "_c10d_functional" or kind is None:
                return
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(args[0]))
            group = next(a for a in reversed(args) if isinstance(a, str))
            self.coll[kind] += nbytes
            self.coll["count"] += 1
            if self._crosses_pods(group):
                self.coll["cross_pod"] += nbytes

        def _crosses_pods(self, group: str) -> bool:
            if self.pod_of is None:
                return False
            if group not in self._groups:
                ranks = dist.get_process_group_ranks(
                    _resolve_process_group(group))
                self._groups[group] = len({self.pod_of(r)
                                           for r in ranks}) > 1
            return self._groups[group]

    return TallyMode


@contextlib.contextmanager
def _dtensor_patches(tally):
    """Two adjustments of DTensor's internals for the fake run:
      * it infers an op's output from a run on global-shaped fakes,
        which the tally must not count (``tally.muted``);
      * it computes a strided shard's local offsets with a small
        ``arange`` and ``tolist``, which under FakeTensorMode would hold
        no values, so that runs unfaked."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    offsets = _StridedShard.local_shard_size_and_offset
    meta = ShardingPropagator._propagate_tensor_meta_non_cached

    def unfaked(self, *a, **k):
        with unset_fake_temporarily():
            return offsets(self, *a, **k)

    def muted(self, *a, **k):
        prev, tally.muted = tally.muted, True
        try:
            return meta(self, *a, **k)
        finally:
            tally.muted = prev

    _StridedShard.local_shard_size_and_offset = unfaked
    ShardingPropagator._propagate_tensor_meta_non_cached = muted
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = offsets
        ShardingPropagator._propagate_tensor_meta_non_cached = meta


def _place(meta: torch.Tensor, spec, mesh, device) -> torch.Tensor:
    """A DTensor of ``meta``'s shape and dtype placed by ``spec`` (which
    divides every dim it shards), its local shard a fresh (fake) tensor
    on ``device``."""
    from torch.distributed.tensor import DTensor
    pl = R.placements(spec, mesh)
    local = list(meta.shape)
    for md, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(md)
    t = torch.empty(local, dtype=meta.dtype, device=device)
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _place_all(flat: Dict, specs: Dict, mesh, device, axis_sizes) -> Dict:
    specs = R.sanitize_specs(specs, flat, axis_sizes)
    return {k: _place(v, specs[k], mesh, device) for k, v in flat.items()}


def _place_tree(tree, specs: Dict, mesh, device, axis_sizes):
    """``tree`` (nested) with each leaf placed by the spec of its flat
    key (``models.model.flatten_params``), the nesting kept."""
    from torch.utils._pytree import tree_map
    flat = MD.flatten_params(tree)
    placed = _place_all(flat, specs, mesh, device, axis_sizes)
    key_of = {id(v): k for k, v in flat.items()}
    return tree_map(lambda leaf: placed[key_of[id(leaf)]], tree)


def _pod_mean(mesh):
    """The gradient sync of a train step on one pod's (data, model) mesh,
    as hybrid-sharded data parallelism does it: each gradient placed as
    its parameter (reduced within the pod), then that local shard
    all-reduced over 'pod' in the gradient's dtype and divided by the
    pod count."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    dim = mesh.mesh_dim_names.index("pod")
    pods = mesh.size(dim)

    def sync(grads, params):
        out = {}
        for k, g in grads.items():
            g = g.redistribute(g.device_mesh, params[k].placements)
            local = funcol.wait_tensor(funcol.all_reduce(
                g.to_local(), "sum", (mesh, dim))) / pods
            out[k] = DTensor.from_local(local, g.device_mesh, g.placements,
                                        run_check=False, shape=g.shape,
                                        stride=g.stride())
        return out

    return sync


def model_flops(cfg, shape):
    """(6 * N_active * D analytical training FLOPs, 2ND for fwd-only
    decode; N_total)."""
    total, active, embed = _param_counts(cfg)
    active += embed    # the dry run counts the embeddings as active
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 2.0 if shape.is_decode else 6.0
    return mult * active * tokens, total


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               kv_dtype: Optional[str] = None,
               remat: Optional[bool] = None,
               fsdp_gather: bool = False,
               remat_policy: Optional[str] = None,
               fl_local_steps: int = 0, *, device="cuda", mesh=None,
               cfg=None, shape=None) -> Dict:
    """One combo's record.  ``mesh``, ``cfg`` and ``shape`` replace the
    production mesh, ``arch``'s config and ``shape_name``'s shape (the
    tests' small meshes and smoke configs)."""
    cfg = cfg or get_config(arch)
    if kv_dtype:
        cfg = cfg.replace(kv_cache_dtype=kv_dtype)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if fsdp_gather:
        cfg = cfg.replace(fsdp_gather_weights=True)
    if remat_policy:
        cfg = cfg.replace(remat_policy=remat_policy)
    shape = shape or SHAPES_BY_NAME[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind, "kv_dtype": kv_dtype,
                 "fsdp_gather": fsdp_gather}

    if shape.name == "long_500k" and not cfg.supports_long_context():
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention architecture: 500k decode "
                         "requires sub-quadratic state (DESIGN.md skip rule)")
        return rec

    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device=device)
    names = mesh.mesh_dim_names
    rec["mesh"] = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    axis_sizes = R.mesh_axis_sizes(mesh)
    n_dev = mesh.size()
    pod_of = None
    if "pod" in names:
        per_pod = n_dev // axis_sizes["pod"]
        pod_of = (lambda r: r // per_pod) if names[0] == "pod" else None
    dev = torch.device(mesh.device_type)
    tally = _make_tally_mode()(pod_of)
    t0 = time.time()

    pflat = MD.flatten_params(SP.params_shape(cfg))
    pspecs = R.param_specs(cfg, pflat)
    fl = bool(fl_local_steps and shape.kind == "train" and "pod" in names)
    # 'pod' as hybrid-sharded data parallelism: outside the FL round each
    # pod runs the step on the (data, model) mesh over its share of the
    # batch, and a train step all-reduces its gradients over 'pod'
    step_mesh, pods = mesh, 1
    if "pod" in names and not fl:
        pods = axis_sizes["pod"]
        step_mesh = mesh[tuple(n for n in names if n != "pod")]
    B = shape.global_batch
    B_step = B // pods if B % pods == 0 else B
    sizes = R.mesh_axis_sizes(step_mesh)
    with tally, _dtensor_patches(tally), use_mesh(step_mesh), \
            tally_loops(tally.trips):
        if fl:
            # the paper's I local rounds per aggregation (eq 5-8) mapped
            # onto pods-as-cohorts: I per-pod SGD steps, then ONE
            # cross-pod FedAvg all-reduce
            n_cohorts = axis_sizes["pod"]
            rstep = make_fl_round_step(cfg, local_steps=fl_local_steps,
                                       n_cohorts=n_cohorts)
            bmeta = {k: SP.sds((n_cohorts, fl_local_steps,
                                v.shape[0] // n_cohorts) + v.shape[1:],
                               v.dtype)
                     for k, v in SP.train_input_specs(cfg, shape).items()}
            bspecs = {k: ("pod", None, *s) for k, s in
                      R.train_batch_specs(cfg, multi_pod=False).items()}
            cmeta = {k: SP.sds((n_cohorts,) + v.shape, v.dtype)
                     for k, v in pflat.items()}
            cspecs = {k: ("pod", *s) for k, s in R.sanitize_specs(
                pspecs, pflat, axis_sizes).items()}
            args = (MD.nested_params(_place_all(cmeta, cspecs, mesh, dev,
                                                axis_sizes)),
                    _place_all(bmeta, bspecs, mesh, dev, axis_sizes))
            fn = rstep
            rec["fl_local_steps"] = fl_local_steps
        elif shape.kind in ("train", "prefill"):
            params = MD.nested_params(_place_all(pflat, pspecs, step_mesh,
                                                 dev, sizes))
            bmeta = {k: SP.sds((B_step,) + v.shape[1:], v.dtype) for k, v in
                     SP.train_input_specs(cfg, shape).items()}
            batch = _place_all(bmeta, R.train_batch_specs(cfg), step_mesh,
                               dev, sizes)
            if shape.kind == "train":
                train_step, opt_init = make_train_step(
                    cfg, grad_sync=_pod_mean(mesh) if pods > 1 else None)
                args = (params, opt_init(params), batch)
                fn = train_step
            else:
                args = (params, batch)
                fn = lambda p, b: MD.loss_fn(cfg, p, b)      # noqa: E731
        else:
            params = MD.nested_params(_place_all(pflat, pspecs, step_mesh,
                                                 dev, sizes))
            stree = MD.init_decode_state(cfg, B_step, shape.seq_len,
                                         device=SP.META)
            sspecs = R.decode_state_specs(cfg, MD.flatten_params(stree),
                                          B_step, sizes)
            state = _place_tree(stree, sspecs, step_mesh, dev, sizes)
            toks = _place_all({"tokens": SP.sds((B_step,), torch.int32)},
                              R.decode_batch_specs(cfg, B_step), step_mesh,
                              dev, sizes)["tokens"]
            # the position: the cache's last slot
            args = (params, state, toks, shape.seq_len - 1)
            fn = make_serve_step(cfg)
        arg_bytes = _local_bytes(args)
        tally.counting = True
        out = fn(*args)
        tally.counting = False
        out_bytes = _local_bytes(out)
    lower_s = time.time() - t0
    mf, n_params = model_flops(cfg, shape)
    coll = dict(tally.coll)
    coll["total"] = sum(coll[k] for k in _COLLECTIVES)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": tally.peak}
    rec.update(
        status="ok",
        device=dev.type,
        n_devices=int(n_dev),
        lower_s=round(lower_s, 2),
        memory=mem,
        cost={"flops": float(tally.flops)},
        collectives=coll,
        model_flops=mf,
        n_params=int(n_params),
    )
    obs.log(headline(rec))
    return rec


def headline(rec: Dict) -> str:
    """The record's two headline numbers, as the JAX dry run logs them."""
    return (f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}] "
            f"fake run ok in {rec['lower_s']:.1f}s; "
            f"temp={rec['memory']['temp_size_in_bytes']/2**30:.2f} GiB/dev; "
            f"flops={rec['cost']['flops']:.3g}; "
            f"collective={rec['collectives']['total']/2**20:.1f} MiB/dev")


def result_path(arch: str, shape_name: str, multi_pod: bool,
                suffix: str = "", results_dir: str = RESULTS_DIR) -> str:
    mesh = "pod2" if multi_pod else "pod1"
    os.makedirs(results_dir, exist_ok=True)
    return os.path.join(
        results_dir, f"{arch}__{shape_name}__{mesh}{suffix}.json")


def _combo_cost(combo) -> float:
    """A rough ordering of combos by run time: layers times the
    attention block pairs of the shape (prefill_32k's 32k tokens)."""
    arch, shp, _ = combo
    cfg = get_config(arch)
    per_layer = {"train": 8.0, "prefill": 16.0, "decode": 0.1}
    return (cfg.num_layers + cfg.encoder_layers) \
        * per_layer[SHAPES_BY_NAME[shp].kind]


def _combo_cmd(args, arch, shp, mp):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shp, "--suffix", args.suffix,
           "--device", args.device, "--results-dir", args.results_dir]
    if mp:
        cmd.append("--multi-pod")
    if args.kv_dtype:
        cmd += ["--kv-dtype", args.kv_dtype]
    if args.remat:
        cmd += ["--remat", args.remat]
    if args.fsdp_gather:
        cmd.append("--fsdp-gather")
    if args.remat_policy:
        cmd += ["--remat-policy", args.remat_policy]
    if args.fl_local_steps:
        cmd += ["--fl-local-steps", str(args.fl_local_steps)]
    if args.quiet:
        cmd.append("--quiet")
    return cmd


# the tests' small meshes: each arch's smoke config (remat on, as the
# production configs run) at B 4 x S 32 through the train, prefill and
# decode steps on a 2 x 2 (data, model) mesh, and through the FL round
# (2 local steps, one sequence a device) on 2 x 2 x 2 (pod, data, model)
SMALL_CASES = ("train", "prefill", "decode", "fl_round")
SMALL_B, SMALL_S, SMALL_FL_STEPS = 4, 32, 2
# two more smoke configs whose heads the 2-way 'model' axis does not
# divide (and whisper's vocab too): the heads and vocab padded to it
SMALL_VARIANTS = {
    "qwen2-0.5b-3h": ("qwen2-0.5b", {"num_heads": 3, "num_kv_heads": 1,
                                     "d_model": 96}),
    "whisper-tiny-3h": ("whisper-tiny", {"num_heads": 3, "num_kv_heads": 3,
                                         "d_model": 96, "vocab_size": 255}),
}
SMALL_ARCHS = (*ARCH_IDS, *SMALL_VARIANTS)


def small_config(name: str):
    """The small meshes' config of ``name`` (SMALL_ARCHS): its arch's
    smoke config, remat on, with a SMALL_VARIANTS entry's overrides."""
    from repro_torch.configs.registry import get_smoke_config
    arch, over = SMALL_VARIANTS.get(name, (name, {}))
    return get_smoke_config(arch).replace(remat=True, **over)


def small_mesh_record(arch: str, case: str, device="cuda") -> Dict:
    """One case of SMALL_CASES for ``arch`` (one of SMALL_ARCHS); a raise
    is recorded as ``error`` with the innermost frame of the port
    (``site``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import fake_mesh
    cfg = small_config(arch)
    fl = case == "fl_round"
    shape = ShapeConfig("small", SMALL_S, SMALL_B, "train" if fl else case)
    try:
        if fl:
            mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"), device)
        else:
            mesh = fake_mesh((2, 2), ("data", "model"), device)
        rec = dryrun_one(arch, "small", fl, device=device, mesh=mesh,
                         cfg=cfg, shape=shape,
                         fl_local_steps=SMALL_FL_STEPS if fl else 0)
    except Exception as e:  # noqa: BLE001
        frames = traceback.extract_tb(e.__traceback__)
        ours = [f for f in frames if "repro_torch" in f.filename]
        site = ours[-1] if ours else frames[-1]
        rec = {"arch": arch, "shape": "small", "status": "error",
               "error": repr(e)[:2000],
               "site": f"{site.filename.rsplit('src/', 1)[-1]}:"
                       f"{site.lineno} ({site.name})",
               "traceback": traceback.format_exc()[-4000:]}
    rec["case"] = case
    return rec


def small_mesh_sweep(archs, device, results_dir) -> int:
    """Every case of SMALL_CASES for each of ``archs``, one after
    another in this process; the count of failed ones."""
    failed = 0
    for arch in archs:
        for case in SMALL_CASES:
            rec = small_mesh_record(arch, case, device)
            with open(result_path(arch, f"small_{case}", False, "",
                                  results_dir), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] != "ok":
                failed += 1
                obs.log(f"[{arch} x small {case}] FAILED at {rec['site']}: "
                        f"{rec['error'][:300]}", always=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id, a comma-separated list, or 'all'")
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in INPUT_SHAPES] + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--remat", default=None, choices=["on", "off"])
    ap.add_argument("--fsdp-gather", action="store_true")
    ap.add_argument("--remat-policy", default=None,
                    choices=["nothing", "save_block_out"])
    ap.add_argument("--fl-local-steps", type=int, default=0,
                    help="run the FL round step (pods=cohorts, I local "
                         "steps, one cross-pod FedAvg); needs --multi-pod")
    ap.add_argument("--suffix", default="", help="result filename suffix")
    ap.add_argument("--subprocess-per-combo", action="store_true",
                    help="isolate each combo in a fresh process")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --subprocess-per-combo: combos run at once")
    ap.add_argument("--combo-timeout", type=float, default=0,
                    help="with --subprocess-per-combo: seconds after which "
                         "a combo is stopped and recorded as an error "
                         "(0: none)")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (default cuda; "
                         "cpu on a host without a GPU)")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--small-meshes", action="store_true",
                    help="instead of the shapes: each arch's smoke config "
                         "(and SMALL_VARIANTS') on the tests' small meshes "
                         "(SMALL_CASES)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-combo progress lines")
    args = ap.parse_args(argv)
    obs.configure(quiet=args.quiet)

    archs = ARCH_IDS if args.arch in (None, "all") \
        else args.arch.split(",")
    if args.small_meshes:
        archs = SMALL_ARCHS if args.arch in (None, "all") else archs
        failed = small_mesh_sweep(archs, args.device, args.results_dir)
        obs.log(f"small meshes: {failed} of {len(archs) * len(SMALL_CASES)}"
                " cases failed", always=True)
        sys.exit(1 if failed else 0)
    shapes = ([s.name for s in INPUT_SHAPES]
              if args.shape in (None, "all") else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    combos = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if args.subprocess_per_combo and args.jobs > 1:
        combos.sort(key=_combo_cost, reverse=True)    # longest first

    failures = []
    if args.subprocess_per_combo:
        running = []

        def reap():
            for item in list(running):
                proc, combo, t, out, err = item
                late = args.combo_timeout and \
                    time.time() - t > args.combo_timeout
                if proc.poll() is None and not late:
                    continue
                timed_out = late and proc.poll() is None
                if timed_out:
                    proc.kill()
                    proc.wait()
                    rec = {"arch": combo[0], "shape": combo[1],
                           "mesh": "2x16x16" if combo[2] else "16x16",
                           "status": "error", "error":
                           f"timed out after {args.combo_timeout} s"}
                    with open(result_path(*combo, args.suffix,
                                          args.results_dir), "w") as f:
                        json.dump(rec, f, indent=1)
                    obs.log(f"[{combo[0]} x {combo[1]}] FAILED: "
                            f"{rec['error']}")
                for fh in (out, err):
                    fh.seek(0)
                sys.stdout.write(out.read())
                sys.stdout.flush()
                if proc.returncode != 0:
                    failures.append((*combo, rec["error"] if timed_out
                                     else err.read()[-2000:]))
                out.close()
                err.close()
                running.remove(item)

        for combo in combos:
            while len(running) >= max(args.jobs, 1):
                time.sleep(0.5)
                reap()
            out, err = tempfile.TemporaryFile("w+"), \
                tempfile.TemporaryFile("w+")
            running.append((subprocess.Popen(
                _combo_cmd(args, *combo), stdout=out, stderr=err,
                text=True), combo, time.time(), out, err))
        while running:
            time.sleep(0.5)
            reap()
    else:
        for arch, shp, mp in combos:
            out = result_path(arch, shp, mp, args.suffix, args.results_dir)
            try:
                rec = dryrun_one(arch, shp, mp, kv_dtype=args.kv_dtype,
                                 remat=(None if args.remat is None
                                        else args.remat == "on"),
                                 fsdp_gather=args.fsdp_gather,
                                 remat_policy=args.remat_policy,
                                 fl_local_steps=args.fl_local_steps,
                                 device=args.device)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shp,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                failures.append((arch, shp, mp, repr(e)))
                obs.log(f"[{arch} x {shp}] FAILED: {e!r}")
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        obs.log(f"\n{len(failures)} dry-run failures:", always=True)
        for f4 in failures:
            obs.log(f"   {f4[:3]} {f4[3][:200]}", always=True)
        sys.exit(1)
    obs.log("\nall dry-runs ok")


if __name__ == "__main__":
    main()
