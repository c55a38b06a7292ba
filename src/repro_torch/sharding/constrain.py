"""Sharding-constraint helper usable from model code
(``repro.sharding.constrain``).

``maybe_constrain(x, axis0, axis1, ...)`` redistributes a DTensor to the
named placements when an ambient mesh (set with :func:`use_mesh`, as the
dry run does) carries the named axes; outside one it returns ``x``
itself, so the same model code runs unchanged on plain tensors in the
serving and training paths and in the 512-rank dry run.  Axis entries
may be None, a name, or a tuple of names.

Inside the mesh, plain tensors that the model makes (RoPE's angles,
masks, accumulators) join DTensor arithmetic as replicated ones
(``implicit_replication``), as a value without a sharding is
replicated under XLA's partitioner.
"""
from __future__ import annotations

import contextlib
import types

import torch

# process-wide, not thread-local: the autograd engine runs a cuda
# backward (and remat's recompute) on a thread of its own, which must see
# the mesh the forward ran under
_STATE = types.SimpleNamespace(mesh=None, forbidden=frozenset(),
                               loop_tally=None)


def current_mesh():
    """The ambient ``DeviceMesh`` of :func:`use_mesh`, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (``jax.sharding.set_mesh``): model
    constraints apply on it, and plain tensors mixed with DTensors are
    taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _STATE.mesh = prev


@contextlib.contextmanager
def forbid_axes(*axes):
    """Named axes that model-internal constraints must NOT use.  The
    FL-round step runs each cohort on its 'pod' slice; inner activation
    constraints mentioning 'pod' would force cross-pod resharding of
    per-cohort tensors."""
    prev = _STATE.forbidden
    _STATE.forbidden = prev | set(axes)
    try:
        yield
    finally:
        _STATE.forbidden = prev


@contextlib.contextmanager
def tally_loops(hook):
    """Let ``hook(trips)``, a context manager, count the trips of the
    model's long loops (:func:`loop_trips`): the dry run's tally, which
    runs one trip and counts what it dispatched ``trips`` times."""
    prev = _STATE.loop_tally
    _STATE.loop_tally = hook
    try:
        yield
    finally:
        _STATE.loop_tally = prev


@contextlib.contextmanager
def loop_trips(trips: int):
    """Around a loop of ``trips`` trips that each do the same work on
    tensors of the same shapes.  Under :func:`tally_loops` inside the
    mesh it yields ``once(fn, *args)``, which runs ``fn(*args)`` (a tuple
    of tensors) as the one trip and has the tally count its forward and
    its backward ``trips`` times each, as the JAX dry run counts a while
    body by its trip count; elsewhere, a real run, None."""
    hook = _STATE.loop_tally
    if hook is None or current_mesh() is None or trips <= 1:
        yield None
        return
    yield lambda fn, *args: _Trip.apply(
        hook, trips, fn, torch.is_grad_enabled()
        and any(a.requires_grad for a in args), *args)


def _same(t):
    return t


class _Trip(torch.autograd.Function):
    """One trip of a loop run under ``hook(trips)``, its backward too.
    The backward trip runs in the forward, where no other backward work
    can be taken into the count: a nested ``autograd.grad`` inside a
    backward on a cuda device thread would run the outer graph's ready
    nodes too.  A forward recomputed inside a backward (remat) counts
    its forward only.  Every float input takes a gradient, as an inner
    trip's carried state does; the gradients given back are zeros (the
    fake run has no values)."""

    @staticmethod
    def forward(ctx, hook, trips, fn, grad, *args):
        # the shapes only: a reference would keep the inputs' storages
        # (the loop's whole sequence) alive as long as the graph
        ctx.like = [(a.shape, a.dtype, a.device) if a.requires_grad
                    else None for a in args]
        if not grad or torch._C._current_graph_task_id() != -1:
            # no gradient, or remat's recompute inside a backward: the
            # forward alone, with no graph (one left by a recompute
            # outlives its block's backward)
            with hook(trips):
                return fn(*args)
        args = [a.detach().requires_grad_(a.is_floating_point())
                for a in args]
        # the trip's own graph keeps its saved tensors: under remat's
        # hooks its backward would recompute the whole block
        with torch.enable_grad(), hook(trips), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            out = fn(*args)
            torch.autograd.grad(
                out, [a for a in args if a.requires_grad],
                [torch.ones_like(o) for o in out], allow_unused=True)
        return tuple(o.detach() for o in out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None,
                *(None if a is None else torch.zeros(a[0], dtype=a[1],
                                                     device=a[2])
                  for a in ctx.like))


def _filter_entry(mesh_axes, entry):
    """Keep only axis names present in the mesh (tuples are filtered
    element-wise, e.g. ('pod','data') -> 'data' on the single-pod mesh)."""
    if entry is None:
        return None
    if isinstance(entry, tuple):
        kept = tuple(e for e in entry if e in mesh_axes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return entry if entry in mesh_axes else None


def maybe_constrain(x, *axes):
    """``x`` redistributed to ``axes`` (one entry per leading dim) inside
    the mesh, a plain ``x`` taken as replicated first; ``x`` itself
    outside it."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.rules import (_n_shards, mesh_axis_sizes,
                                            placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    names = set(mesh.mesh_dim_names)
    names -= _STATE.forbidden
    spec = tuple(_filter_entry(names, a) for a in axes)
    # only even splits: XLA pads an uneven one, but DTensor's views
    # refuse it and its batched products reshard it at every step
    sizes = mesh_axis_sizes(x.device_mesh)
    spec = tuple(e if x.shape[d] % _n_shards(e, sizes) == 0 else None
                 for d, e in enumerate(spec))
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def _gather(x, drop):
    """DTensor ``x`` with each placement that ``drop(mesh_dim,
    placement)`` selects made Replicate; ``x`` itself outside the mesh
    or when none is selected."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if drop(i, p) else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _gather_uneven(x, dims, sizes):
    """``x`` with each shard of one of ``dims`` over a mesh axis that
    does not divide ``sizes`` (the dim's size before a split or after a
    merge) gathered: DTensor cannot view an uneven shard, where XLA pads
    it (qwen2's 14 heads, or 2 KV heads, over a 16-way 'model')."""
    return _gather(x, lambda i, p: any(
        p.is_shard(d) and n % x.device_mesh.size(i)
        for d, n in zip(dims, sizes)))


def _split(x, n: int, d: int):
    x = _gather_uneven(x, (x.ndim - 1,), (n,))
    return x.reshape(*x.shape[:-1], n, d)


def _merge(x):
    # an uneven split of the outer dim, and any split of the inner one
    # (its shards would interleave), are gathered
    x = _gather_uneven(x, (x.ndim - 2, x.ndim - 1), (x.shape[-2], 1))
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


class _Heads(torch.autograd.Function):
    """(..., n*d) <-> (..., n, d) inside the mesh, the uneven shards
    gathered both ways (the backward views the gradient back)."""

    @staticmethod
    def forward(ctx, x, n, d, split):
        ctx.n, ctx.d, ctx.split = n, d, split
        return _split(x, n, d) if split else _merge(x)

    @staticmethod
    def backward(ctx, g):
        return (_merge(g) if ctx.split else _split(g, ctx.n, ctx.d),
                None, None, None)


def padded_to_model(n: int) -> int:
    """``n`` rounded up to a multiple of the ambient mesh's 'model' axis,
    as GSPMD pads an uneven split of an intermediate (qwen2's 14 heads
    to 16); ``n`` itself outside the mesh."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names \
            or "model" in _STATE.forbidden:
        return n
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    return -(-n // m) * m


def pad_split(w, dim: int, unit: int, real: int, padded: int,
              source=None):
    """``w``'s dim ``dim``, taken as units of ``unit`` elements (heads of
    head_dim columns, or vocab columns), rebuilt as ``padded`` units split
    over 'model', ``padded / n`` whole units a rank: unit j < ``real`` is
    ``w``'s unit ``source(j)`` (j itself by default), the rest zeros.
    GSPMD's padding of an uneven split, made where the split is: a
    product with the padded weight gives its output already split by
    whole units.  Each rank builds only its own units from ``w`` gathered
    over 'model'; the gradient goes back to its sources as a partial sum
    over 'model', reduced to ``w``'s placements.  ``w``: a DTensor inside
    the mesh."""
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    md = mesh.mesh_dim_names.index("model")
    per = padded // mesh.size(md)
    first = mesh.get_local_rank(md) * per
    mine = [source(j) if source else j
            for j in range(first, min(first + per, real))]
    dim %= w.ndim
    w = _gather(w, lambda i, p: i == md)
    assert not any(p.is_shard(dim) for p in w.placements), w.placements
    pl = [Shard(dim) if i == md else p for i, p in enumerate(w.placements)]

    def block(t):
        units = t.unflatten(dim, (t.shape[dim] // unit, unit))
        start = mine[0] if mine else 0
        if mine == list(range(start, start + len(mine))):
            got = units.narrow(dim, start, len(mine))       # a view
        else:
            got = units.index_select(dim, torch.tensor(mine,
                                                       device=t.device))
        if len(mine) < per:
            shape = list(units.shape)
            shape[dim] = per - len(mine)
            got = torch.cat([got, units.new_zeros(shape)], dim)
        return got.flatten(dim, dim + 1)

    return on_local_shards(block, pl, w)


def split_last(x, n: int, d: int):
    """x (..., n*d) -> (..., n, d)."""
    if current_mesh() is None:
        return x.reshape(*x.shape[:-1], n, d)
    return _Heads.apply(x, n, d, True)


def merge_last(x):
    """x (..., n, d) -> (..., n*d)."""
    if current_mesh() is None:
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _Heads.apply(x, x.shape[-2], x.shape[-1], False)


def gather_inner(x):
    """x (..., D) with its inner dims (all but the first and the last)
    gathered inside the mesh, so that ``x @ w`` or a reshape can fold the
    leading dims: DTensor cannot flatten a sharded inner dim (the
    sequence, sharded over 'model' between blocks).  Megatron's sequence
    parallelism gathers the sequence before a column-parallel product
    likewise.  Outside the mesh ``x`` itself."""
    if x.ndim < 3:
        return x
    return _gather(x, lambda i, p: any(p.is_shard(d)
                                       for d in range(1, x.ndim - 1)))


def on_local_shards(fn, placements, *args):
    """``fn`` over the local shards of the DTensors among ``args`` (other
    arguments passed as they are), for a computation each shard does
    alone: batch and heads split, nothing summed across shards, as in
    tensor-parallel attention.  Each tensor output comes back a DTensor
    on their mesh with ``placements``.  An argument replicated over a
    mesh dim that ``placements`` shards gets its gradient there as a
    partial sum: each shard's slice of the output adds its part (a
    weight shared by the token groups, gates shared by the D-slices)."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))

    def local(a):
        if not isinstance(a, DTensor):
            return a
        grad = [Partial() if p.is_replicate() and o.is_shard() else p
                for p, o in zip(a.placements, placements)]
        return a.to_local(grad_placements=grad)

    out = fn(*map(local, args))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, placements, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor inside the mesh."""
    if current_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Fold(torch.autograd.Function):
    """``x.reshape(shape)`` on a DTensor, its inner dims gathered first,
    and the gradient's gathered before it is reshaped back."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return gather_inner(x).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g).reshape(ctx.shape), None


def fold(x, *shape):
    """``x.reshape(shape)`` for a reshape that merges or splits the
    leading (batch, sequence) dims; inside the mesh it gathers a sharded
    sequence both ways, which DTensor cannot fold."""
    if not is_distributed(x):
        return x.reshape(*shape)
    return _Fold.apply(x, shape)
