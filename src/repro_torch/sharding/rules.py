"""Cohort sharding rules (``repro.sharding.rules``' cohort part): for
each argument of the engine's round-training functions, whether it is
replicated on every shard or split on axis 0 over the mesh's ``data``
axis (repro_torch.launch.mesh).

Stage-3 local training is pure data parallelism over the cohort: the
packed bucket tensors (xb, yb, step_mask, weights, each with a leading
client axis) split over ``data``, the global params are replicated in,
and the shards' float32 FedAvg partials are summed into the aggregate.
The packer pads the client axis to a multiple of the data-axis size
(weight-0 rows), so the split is always even.

A spec is :data:`REPLICATED` or :data:`DATA`.  :func:`shard_of` applies
one: a replicated argument comes as one entry per shard (each on its
shard's device), a split one as a whole array whose axis 0 is cut into
contiguous blocks.

The LM rules of the dry run (``launch.dryrun``) map the parameter, cache
and batch trees of a transformer onto the production mesh
(``launch.mesh.make_production_mesh``):

  * ``model`` axis — tensor parallel: attention heads / d_ff / experts /
    vocab;
  * ``data``  axis — FSDP: the d_model ("reduction") dimension of every
    large matrix is sharded over ``data``;
  * ``pod``   axis — pure data parallel across FL cohorts: parameters are
    REPLICATED across pods; the cross-pod all-reduce happens once per FL
    round, at aggregation.

Batch dims shard over ("pod", "data"); decode caches shard batch over
``data`` when the batch is large enough, otherwise the sequence/state
dim.  A spec is the JAX package's ``PartitionSpec`` as a tuple, one
entry per leading dimension: ``None``, an axis name, or a tuple of
names (that dimension split over each of them, the first major).  The
rules read the flat view of a tree (``models.model.flatten_params``:
keys joined with ``.``) and give a flat dict of specs with the same
keys; :func:`placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

REPLICATED = "replicated"
DATA = "data"


def cohort_param_spec() -> str:
    """Global params in, aggregated params out: replicated."""
    return REPLICATED


def cohort_bucket_specs() -> Tuple[str, ...]:
    """(xb, yb, step_mask, weights): client axis over ``data``."""
    return (DATA, DATA, DATA, DATA)


def cohort_stacked_spec() -> str:
    """Per-client stacked outputs keep their leading client axis on
    ``data``."""
    return DATA


def fleet_class_specs() -> Tuple[str, ...]:
    """The ``device`` runtime's ``(class_x, class_y, rows, plans,
    step_mask, weights)``: the class store is replicated (every shard
    gathers its own winners' rows out of the whole store), the
    per-invocation index and weight arrays split their client axis over
    ``data`` (the store pads every tier to a multiple of the data-axis
    size)."""
    return (REPLICATED, REPLICATED, DATA, DATA, DATA, DATA)


def shard_of(spec: str, value, shard: int, shards: int):
    """Shard ``shard`` of ``shards``'s part of ``value`` under ``spec``.
    REPLICATED: ``value`` holds one entry per shard, and the shard's is
    taken.  DATA: rows ``[shard * c / shards, (shard + 1) * c / shards)``
    of axis 0 (a view, for numpy arrays and tensors alike)."""
    if spec == REPLICATED:
        return value[shard]
    if spec != DATA:
        raise ValueError(f"unknown cohort sharding spec {spec!r}")
    c = value.shape[0]
    if c % shards:
        raise ValueError(f"client axis of {c} rows does not split into "
                         f"{shards} equal shards")
    n = c // shards
    return value[shard * n:(shard + 1) * n]


# ----------------------------------------------------------------------
# the LM rules of the dry run
# ----------------------------------------------------------------------

D, M = "data", "model"

# (regex, {rank: spec}) — first match wins.  Stacked block params have a
# leading num_groups dim -> specs here are written for the *unstacked*
# rank and get None prepended when the leaf lives under blocks/.
_PARAM_RULES = [
    (r"tok_embed$",            {2: (M, D)}),
    (r"lm_head$",              {2: (D, M)}),
    (r"pos_embed$",            {2: (None, None)}),
    # attention
    (r"(mixer|cross)/w[qkv]$", {2: (D, M)}),
    (r"(mixer|cross)/wo$",     {2: (M, D)}),
    (r"(mixer|cross)/b[qkv]$", {1: (M,)}),
    # dense mlp
    (r"ffn/w_(gate|up)$",      {2: (D, M)}),
    (r"ffn/w_down$",           {2: (M, D)}),
    (r"ffn/b_up$",             {1: (M,)}),
    (r"ffn/b_down$",           {1: (None,)}),
    # moe
    (r"ffn/router$",           {2: (D, None)}),
    (r"ffn/w_(gate|up)$",      {3: (M, D, None)}),
    (r"ffn/w_down$",           {3: (M, None, D)}),
    # mamba
    (r"mixer/w_in$",           {2: (D, M)}),
    (r"mixer/conv_w$",         {2: (None, M)}),
    (r"mixer/conv_b$",         {1: (M,)}),
    (r"mixer/w_x_dbc$",        {2: (M, None)}),
    (r"mixer/w_dt$",           {2: (None, M)}),
    (r"mixer/b_dt$",           {1: (M,)}),
    (r"mixer/a_log$",          {2: (M, None)}),
    (r"mixer/d_skip$",         {1: (M,)}),
    (r"mixer/w_out$",          {2: (M, D)}),
    # mlstm / slstm
    (r"mixer/w[zifo]$",        {2: (D, M)}),
    (r"mixer/wo_proj$",        {2: (M, D)}),
    (r"mixer/r[zifo]$",        {3: (None, None, None)}),
    (r"mixer/w[if]$",          {2: (D, None)}),
    (r"mixer/b[if]$",          {1: (None,)}),
    # norms & anything else: replicate (fallback)
]


def _path(key: str) -> str:
    """A flat key as the JAX package's tree path (``/``-joined)."""
    return key.replace(".", "/")


def _match_spec(path: str, rank: int) -> Tuple:
    """First rule whose pattern matches AND lists this rank wins (MoE
    expert tensors share names with dense mlp weights; rank
    disambiguates)."""
    for pat, by_rank in _PARAM_RULES:
        if re.search(pat, path) and rank in by_rank:
            return by_rank[rank]
    return (None,) * rank


def param_specs(cfg, params_shape: Mapping) -> Dict[str, Tuple]:
    """params_shape: the flat view of the parameters (tensors of any
    device, ``launch.specs.params_shape``'s meta ones included)."""
    out = {}
    for key, leaf in params_shape.items():
        ps = _path(key)
        rank = len(leaf.shape)
        stacked = "blocks/" in ps
        spec = _match_spec(ps, rank - 1 if stacked else rank)
        out[key] = (None, *spec) if stacked else spec
    return out


def _n_shards(entry, axis_sizes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for e in entry:
            n *= axis_sizes.get(e, 1)
        return n
    return axis_sizes.get(entry, 1)


def sanitize_specs(spec_tree: Mapping, shape_tree: Mapping,
                   axis_sizes: dict) -> Dict[str, Tuple]:
    """Drop every per-dim assignment that does not divide its dim evenly
    (whisper's vocab 51865 over 16, GQA kv=2 heads over 16), and pad
    each spec to its leaf's rank."""
    out = {}
    for key, spec in spec_tree.items():
        dims = shape_tree[key].shape
        entries = tuple(spec) + (None,) * (len(dims) - len(spec))
        out[key] = tuple(
            entry if dim % _n_shards(entry, axis_sizes) == 0 else None
            for dim, entry in zip(dims, entries))
    return out


def mesh_axis_sizes(mesh) -> dict:
    """Axis sizes by name of a ``DeviceMesh`` (or a ``CohortMesh``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def placements(spec: Tuple, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dim d names its axis (alone or
    in a tuple, as (``pod``, ``data``) splits one dim over both), else
    ``Replicate()``.  Names the mesh lacks are ignored."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


# ----------------------------------------------------------------------
# batch / cache / opt-state specs
# ----------------------------------------------------------------------

def batch_axis(multi_pod: bool):
    return ("pod", D) if multi_pod else D


def train_batch_specs(cfg, multi_pod: bool = False) -> Dict[str, Tuple]:
    b = batch_axis(multi_pod)
    specs = {"tokens": (b, None), "labels": (b, None), "mask": (b, None)}
    if cfg.num_prefix_tokens:
        specs["prefix_embeddings"] = (b, None, None)
    if cfg.is_encdec:
        specs["encoder_frames"] = (b, None, None)
    return specs


def _cache_leaf_spec(path: str, shape, *, batch_sharded: bool,
                     axis_sizes: dict) -> Tuple:
    """Decode caches: leading num_groups dim, then batch.  Shard batch
    over 'data' when possible, otherwise the state/sequence dim.  For KV
    caches, the kv-head dim goes to 'model' when it divides evenly;
    otherwise the *sequence* dim takes 'model' (GQA kv counts like 2, 4,
    8 don't divide a 16-way axis but 32k/500k sequences always do)."""
    rank = len(shape)
    bdim = D if batch_sharded else None
    nm = axis_sizes.get(M, 1)
    nd = axis_sizes.get(D, 1)
    if re.search(r"(^|/)(k|v)$", path) and rank == 5:     # (n,B,S,kv,hd)
        _, B, S, KV, _ = shape
        if KV % nm == 0:
            sdim = None if batch_sharded else (D if S % nd == 0 else None)
            return (None, bdim, sdim, M, None)
        sq = M if S % nm == 0 else None
        return (None, bdim, sq, None, None) if batch_sharded else \
            (None, None, (D, M) if S % (nd * nm) == 0 else sq, None, None)
    if re.search(r"(k|v)_scale$", path) and rank == 4:    # (n,B,S,kv)
        _, B, S, KV = shape
        if KV % nm == 0:
            return (None, bdim, None, M)
        return (None, bdim, M if S % nm == 0 else None, None)
    if re.search(r"conv$", path) and rank == 4:           # (n,B,dc-1,di)
        return (None, bdim, None, M)
    if re.search(r"ssm$", path) and rank == 4:            # (n,B,di,ds)
        return (None, bdim, M, None)
    if re.search(r"C$", path) and rank == 5:              # (n,B,h,dk,dv)
        return (None, bdim, None, None, M)
    if rank == 4:                                         # mlstm/slstm (n,B,h,dh)
        return (None, bdim, None, M)
    if rank == 3:                                         # (n,B,h)
        return (None, bdim, None)
    return (None,) * rank


def decode_state_specs(cfg, state_shape: Mapping, global_batch: int,
                       axis_sizes: dict) -> Dict[str, Tuple]:
    """state_shape: the flat view of the decode state."""
    batch_sharded = global_batch % max(axis_sizes.get(D, 1), 1) == 0 \
        and global_batch >= axis_sizes.get(D, 1)
    return {key: _cache_leaf_spec(_path(key), leaf.shape,
                                  batch_sharded=batch_sharded,
                                  axis_sizes=axis_sizes)
            for key, leaf in state_shape.items()}


def decode_batch_specs(cfg, global_batch: int, multi_pod: bool = False
                       ) -> Dict[str, Tuple]:
    b = batch_axis(multi_pod)
    n = (2 if multi_pod else 1) * 16
    tok = (b,) if global_batch >= n else (None,)
    return {"tokens": tok}


def opt_state_specs(pspecs):
    """Optimizer state mirrors parameter sharding (momentum/adam
    moments)."""
    return pspecs
