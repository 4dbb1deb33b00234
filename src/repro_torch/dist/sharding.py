"""Logical-axis sharding rules and the sharding context, as the reference's
``repro.dist.sharding``.

The models annotate tensors with *logical* axis names only
(``constrain(h, "batch", None, None)``); which mesh axis, if any, a logical
name lands on is decided here, per execution mode, by the reference's rule
tables. Resolution is permissive by construction: a logical name that is not
in the table, a mesh axis the mesh does not have, a mesh axis already used
by an earlier dimension, or one that does not divide the dimension all
resolve to "replicated", so smoke-scale configs run under the production
rules unchanged.

Where the reference hands a ``PartitionSpec`` to XLA, the port turns the
same spec into DTensor placements on a ``torch.distributed`` DeviceMesh
(``placements``): a dimension mapped to mesh axes is ``Shard(dim)`` on each
of them, every other mesh axis ``Replicate()``. A mesh is either a
``DeviceMesh`` with dimension names or a shape-only ``AbstractMesh``, which
is enough to compute specs without ranks. ``constrain`` is the identity
outside a ``shard_ctx`` and on a plain tensor; on a DTensor inside one it
redistributes to the resolved placements (the reference's
``with_sharding_constraint``), an all-gather, a local slice or nothing, and
puts the gradient in the same placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import threading

import torch

__all__ = ["make_rules", "shard_ctx", "current_ctx", "sharded", "constrain",
           "named_sharding", "pspec", "placements", "mesh_shape", "axis_size",
           "shard_map", "spec_of", "unflatten", "flatten", "write_along",
           "split_along", "split_product", "join_along", "reduce_like",
           "is_sharded", "logical_spec", "AbstractMesh", "NamedSharding",
           "PartitionSpec", "LOGICAL_AXES"]

# Every logical axis name the model zoo uses, in one place (the reference's
# table): param axes from the Initializer annotations in models/, activation
# axes from the ``constrain`` calls, cache axes from lm.init_decode_cache.
LOGICAL_AXES = (
    # batch-like (data-parallel) axes; gnn_nodes is the node dim of a
    # subgraph batch (models/gnn.py forward_int activations)
    "batch", "moe_group", "cache_batch", "gnn_nodes",
    # tensor-parallel param axes
    "vocab", "qkv", "mlp", "embed2", "heads", "kv_heads",
    "experts", "expert_mlp", "expert_embed",
    # tensor-parallel activation axes
    "vocab_act", "qkv_compute", "mlp_compute", "mlp_act",
    "embed2_compute", "experts_act",
    # sequence / replicated-by-default axes
    "cache_seq", "embed", "norm", "layers", "enc_layers",
)


def make_rules(mode: str, *, multi_pod: bool = False,
               context_parallel: bool = False,
               zero3: bool = False) -> dict:
    """Logical-name -> mesh-axis table for one execution mode.

    mode             "train" or "serve"
    multi_pod        data parallelism spans ("pod", "data") instead of "data"
    context_parallel long-context serving: the KV/cache sequence dim also
                     splits over "model" (split-KV)
    zero3            train only: additionally shard the non-TP dim of every
                     2-D weight over "data" (ZeRO-3 compute layout)

    Every name in :data:`LOGICAL_AXES` has an entry: a mesh axis name, a
    tuple of mesh axis names, or None (replicated).
    """
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    dp = ("pod", "data") if multi_pod else "data"
    return {
        # data parallelism
        "batch": dp,
        "moe_group": dp,
        "cache_batch": dp,
        "gnn_nodes": dp,
        # megatron TP: shard the "compute" dim of each projection pair
        "vocab": "model",
        "vocab_act": "model",
        "qkv": "model",
        "qkv_compute": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "mlp_compute": "model",
        "mlp_act": "model",
        "embed2": "model",
        "embed2_compute": "model",
        # expert parallelism: experts over "data" (all_to_all within a pod),
        # expert FFN weights keep megatron TP over "model"
        "experts": "data",
        "experts_act": "data",
        "expert_mlp": "model",
        "expert_embed": None,
        # replicated by default
        "embed": "data" if (zero3 and mode == "train") else None,
        "cache_seq": "model" if context_parallel else None,
        "norm": None,
        "layers": None,
        "enc_layers": None,
    }


# -------------------------------------------------------------------- meshes

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes and sizes, with no ranks behind it: enough for
    the spec functions (the reference's ``jax.sharding.AbstractMesh``)."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh_axis_names(mesh), mesh.shape))


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, a mesh axis name, or a tuple of
    mesh axis names (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def pspec(*axes) -> PartitionSpec:
    """Build a raw spec: the one sanctioned constructor outside dist/ and
    launch/ (the lint rule ``sharding-spec-layering`` holds code elsewhere
    to it)."""
    return PartitionSpec(*axes)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis in the
    mesh's order: ``Shard(d)`` on each mesh axis of more than one rank that
    dimension ``d`` maps to, ``Replicate()`` on the rest. A dimension mapped
    to several axes (``("pod", "data")``) is split over them major to minor,
    as in JAX. A shard over an axis of one rank is the whole dimension, so
    it is ``Replicate()``: the same layout, which older DTensor releases can
    reshape where they refuse to merge a "sharded" dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else tuple(entry)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        seen: set = set()
        for entry in self.spec:
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                if a in seen:
                    raise ValueError(
                        f"a spec maps each mesh axis to at most one "
                        f"dimension, but {self.spec!r} has duplicate "
                        f"entries for {a!r}")
                seen.add(a)

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def distribute(self, x: torch.Tensor):
        """``x`` (the same global tensor on every rank) as a DTensor of this
        sharding, each rank keeping its shard with no communication; a
        DTensor is redistributed."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


# ------------------------------------------------------------------ context

class _CtxStack(threading.local):
    def __init__(self):
        self.stack: list = []


_CTX = _CtxStack()


@contextlib.contextmanager
def shard_ctx(mesh, rules):
    """Install (mesh, rules) as the active sharding context.

    Inside the context, :func:`constrain` redistributes DTensors and
    :func:`current_ctx` returns ``(mesh, rules)``; contexts nest (innermost
    wins).
    """
    _CTX.stack.append((mesh, rules))
    try:
        yield (mesh, rules)
    finally:
        _CTX.stack.pop()


def current_ctx():
    """The innermost active ``(mesh, rules)``, or None outside any."""
    return _CTX.stack[-1] if _CTX.stack else None


@contextlib.contextmanager
def sharded(mesh, rules):
    """The context a sharded step runs in: ``shard_ctx(mesh, rules)``, and
    plain tensors the model makes (positions, masks) taken as replicated
    where they meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    with shard_ctx(mesh, rules), implicit_replication():
        yield


# --------------------------------------------------------------- resolution

def axis_size(mesh, axes) -> int:
    """The number of ranks along a spec entry: 1 for None, a mesh axis's
    size, or the product of a tuple of axes' sizes."""
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in
                     ((axes,) if isinstance(axes, str) else axes))


def _resolve_one(mesh, rules, name, dim: int | None, used: set):
    """One logical name -> the mesh-axis entry of a spec.

    Drops mesh axes the mesh does not have, axes already used by an earlier
    dim of the same spec, and (when ``dim`` is known) mappings whose
    combined size does not divide the dimension.
    """
    if name is None:
        return None
    ax = rules.get(name)
    if ax is None:
        return None
    names = mesh_axis_names(mesh)
    cand = (ax,) if isinstance(ax, str) else tuple(ax)
    cand = tuple(a for a in cand if a in names and a not in used)
    if not cand:
        return None
    if dim is not None and dim % axis_size(mesh, cand) != 0:
        return None
    used.update(cand)
    return cand if len(cand) > 1 else cand[0]


def _spec_for(mesh, rules, names, shape=None) -> PartitionSpec:
    used: set = set()
    return PartitionSpec(*[
        _resolve_one(mesh, rules, n, None if shape is None else shape[i], used)
        for i, n in enumerate(names)])


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def spec_of(x) -> PartitionSpec:
    """The spec of a DTensor's layout: for each dimension the mesh axes that
    shard it, major to minor (None throughout for a plain tensor)."""
    entries: list = [[] for _ in range(x.ndim)]
    if is_sharded(x):
        from torch.distributed.tensor import Shard

        for a, p in zip(mesh_axis_names(x.device_mesh), x.placements):
            if isinstance(p, Shard):
                entries[p.dim].append(a)
    return PartitionSpec(*[None if not e else e[0] if len(e) == 1
                           else tuple(e) for e in entries])


def logical_spec(mesh, rules, names, shape) -> PartitionSpec:
    """The spec the rules give logical ``names`` for a tensor of
    ``shape`` on ``mesh`` (what ``constrain`` resolves to)."""
    return _spec_for(mesh, rules, names, tuple(shape))


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``target`` (or ``x`` itself), whose backward
    redistributes the gradient to the same ``target``: the transpose of the
    reference's ``with_sharding_constraint``, which puts the constraint on
    the cotangent too."""

    @staticmethod
    def forward(x, target):
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.target = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        if is_sharded(grad) and tuple(grad.placements) != ctx.target:
            grad = grad.redistribute(grad.device_mesh, ctx.target)
        return grad, None


def constrain(x: torch.Tensor, *logical_axes):
    """Apply the active sharding rules to ``x`` (one name or None per dim).

    The identity outside a :func:`shard_ctx` and on a plain tensor. On a
    DTensor inside one, each logical name is resolved through the context's
    rule table (dims whose mesh axis does not divide their size stay
    replicated) and ``x`` is redistributed to those placements on its own
    mesh. As the reference's ``with_sharding_constraint``, the constraint
    holds for the gradient too: under autograd the gradient that comes
    back is redistributed to the same placements, whatever layout DTensor
    gave it.
    """
    ctx = current_ctx()
    if ctx is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain: got {len(logical_axes)} logical axes for a "
            f"{x.ndim}-d tensor (shape {tuple(x.shape)})")
    if not is_sharded(x):
        return x
    mesh, rules = ctx
    spec = _spec_for(mesh, rules, logical_axes, tuple(x.shape))
    target = placements(x.device_mesh, spec)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, target)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def reduce_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x``, a DTensor partial sum (a row-parallel product), reduced into
    ``like``'s layout by DTensor's own redistribution: a reduce-scatter
    where ``like`` is split over the summed mesh axes. Its backward hands
    the gradient back whole over those axes (the transpose of a
    reduce-scatter is an all-gather), where ``constrain`` to the same
    layout would hand it back split. The identity on plain tensors and
    where the layouts are equal."""
    if not (is_sharded(x) and is_sharded(like)) or \
            tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(x.device_mesh, like.placements)


def named_sharding(mesh, axes, rules) -> NamedSharding:
    """Logical axes tuple -> NamedSharding on ``mesh`` (no shape knowledge;
    for the shape-aware version see launch.steps.param_shardings)."""
    return NamedSharding(mesh, _spec_for(mesh, rules, axes))


def _sharded_along(x, dim: int) -> list:
    """Sizes of the mesh axes a DTensor ``x`` is sharded over along
    ``dim`` (empty for a plain tensor)."""
    if not is_sharded(x):
        return []
    from torch.distributed.tensor import Shard

    return [x.device_mesh.size(i) for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.

    A DTensor whose ``dim`` is sharded over mesh axes that do not divide
    ``sizes[0]`` (8 kv heads on a 16-way "model" axis) is first gathered
    along it: DTensor cannot split a dim unevenly, where XLA reshards at
    the reshape.
    """
    dim = dim % x.ndim
    along = _sharded_along(x, dim)
    if along and sizes[0] % math.prod(along):
        from torch.distributed.tensor import Replicate, Shard

        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements])
    return x.unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """``x.flatten(dim, dim + 1)`` whose backward splits the gradient with
    :func:`unflatten`: a gradient sharded along the merged dim over mesh
    axes that do not divide ``x.shape[dim]`` is gathered first."""

    @staticmethod
    def forward(x, dim):
        return x.flatten(dim, dim + 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim = inputs
        ctx.sizes = tuple(x.shape[ctx.dim:ctx.dim + 2])

    @staticmethod
    def backward(ctx, grad):
        return unflatten(grad, ctx.dim, ctx.sizes), None


def flatten(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim, dim + 1)`` (heads and head dim into one).

    On a DTensor the gradient may come back sharded along the merged dim
    over mesh axes that do not divide ``x.shape[dim]`` (20 heads and a
    16-way "model" axis, from a row-parallel product): its split gathers
    first, as :func:`unflatten` does.
    """
    dim = dim % x.ndim
    if not is_sharded(x):
        return x.flatten(dim, dim + 1)
    return _Flatten.apply(x, dim)


def _split_axis(x, dim: int, sizes) -> str | None:
    """The one mesh axis a DTensor ``x`` is sharded over along ``dim``
    (whole shards, in rank order), where its size divides every one of
    ``sizes``; None for a plain tensor and for any other layout."""
    if not is_sharded(x):
        return None
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    if len(on) != 1 or type(x.placements[on[0]]) is not Shard:
        return None
    m = mesh.size(on[0])
    if m == 1 or any(s % m for s in sizes):
        return None
    return mesh_axis_names(mesh)[on[0]]


@functools.lru_cache(maxsize=64)
def _group_plan(sizes: tuple, m: int, r: int) -> tuple:
    """Rank ``r``'s side of the all-to-all between two layouts of a dim made
    of segments of ``sizes``, split over ``m`` ranks: the natural one (rank
    r holds [r w, (r + 1) w), w = sum(sizes) / m) and the grouped one (rank
    r holds the r-th of the m equal pieces of every segment, in the
    segments' order). Returns (``order``: the rank's natural local indices
    as it sends them, grouped by the rank they go to, ascending within
    each; its inverse permutation; ``send``: how many go to each rank;
    ``recv``: how many come from each)."""
    w = sum(sizes) // m
    pieces = [(o, s // m) for o, s in
              zip(itertools.accumulate((0,) + sizes[:-1]), sizes)]

    def spans(lo: int, hi: int, j: int) -> list:
        """The columns of [lo, hi) in rank j's pieces, ascending."""
        out = [(max(lo, o + j * q), min(hi, o + (j + 1) * q))
               for o, q in pieces]
        return [(a, b) for a, b in out if b > a]

    lo = r * w
    order, send = [], []
    for j in range(m):
        s = spans(lo, lo + w, j)
        order += [c - lo for a, b in s for c in range(a, b)]
        send.append(sum(b - a for a, b in s))
    recv = [sum(b - a for a, b in spans(i * w, (i + 1) * w, r))
            for i in range(m)]
    inv = sorted(range(w), key=order.__getitem__)
    return tuple(order), tuple(inv), tuple(send), tuple(recv)


def _regroup(x, dim: int, sizes: tuple, m: int, r: int, group,
             inverse: bool):
    """One rank's shard ``x`` along ``dim`` moved from the natural layout
    to the grouped one (``inverse``: back), by one all-to-all with uneven
    splits, whose backward is the reverse exchange."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd

    order, inv, send, recv = _group_plan(sizes, m, r)
    if not inverse:
        x = x.index_select(dim, torch.tensor(order, device=x.device))
    else:
        send, recv = recv, send
    y = all_to_all_single_autograd(x.movedim(dim, 0).contiguous(),
                                   list(recv), list(send), group)
    y = y.movedim(0, dim)
    if inverse:
        y = y.index_select(dim, torch.tensor(inv, device=x.device))
    return y


def _along(xs, dim: int, sizes: tuple, axis: str, fn, n_out=None):
    """``fn(*local shards, dim, sizes, m, r, group)`` on each rank ``r`` of
    the ``m`` along ``axis``, the mesh axis that shards ``xs[0]`` along
    ``dim``, through :func:`shard_map`: every input and output (one, or
    ``n_out``) laid out as ``xs[0]``."""
    mesh, spec = xs[0].device_mesh, spec_of(xs[0])
    local = functools.partial(fn, dim=dim, sizes=sizes,
                              m=axis_size(mesh, axis),
                              r=mesh.get_local_rank(axis),
                              group=mesh.get_group(axis))
    out = spec if n_out is None else (spec,) * n_out
    return shard_map(local, mesh, in_specs=(spec,) * len(xs),
                     out_specs=out)(*xs)


def _pieces(x, *, dim, sizes, m, r, group):
    """A grouped shard cut into the rank's piece of every segment."""
    return tuple(x.split([s // m for s in sizes], dim))


def _take(x, *, dim, sizes, m, r, group):
    return _pieces(_regroup(x, dim, sizes, m, r, group, inverse=False),
                   dim=dim, sizes=sizes, m=m, r=r, group=group)


def split_along(x: torch.Tensor, dim: int, sizes) -> tuple:
    """``x.split(sizes, dim)``, a DTensor split per rank.

    On a DTensor sharded along ``dim`` over one mesh axis whose size
    divides every one of ``sizes``, each piece is a DTensor laid out as
    ``x``, each rank holding its own shard of every piece: the rank's
    shard of ``x`` is put in grouped order (rank r holds the r-th of the
    equal pieces of every segment, in the segments' order) by one
    all-to-all over that axis and split locally. Nothing is gathered. A
    segment that does not split evenly over the axis (or a dim sharded
    over two axes) is sliced by DTensor, which first gathers ``x`` along
    ``dim``, where XLA would move only the boundary columns.
    """
    dim = dim % x.ndim
    sizes = tuple(sizes)
    axis = _split_axis(x, dim, sizes)
    if axis is None:
        return x.split(list(sizes), dim)
    return _along((x,), dim, sizes, axis, _take, len(sizes))


def split_product(x: torch.Tensor, w: torch.Tensor, sizes) -> tuple:
    """``(x @ w.to(x.dtype)).split(sizes, -1)`` for a weight ``w`` (K, N)
    whose columns are segments of ``sizes``, moving the weight, not the
    product.

    On a DTensor ``w`` sharded along N over one mesh axis whose size
    divides every one of ``sizes``, ``w``'s shard is put in grouped order
    by one all-to-all over that axis, so that the product gives each rank
    its own columns of every segment, taken locally: for many rows of
    ``x`` (Mamba-2's fused ``in_proj`` at prefill) the weight's shard is
    far smaller than the product's. Each piece is laid out as the
    product. Any other ``w``: the product sliced as ``split_along`` would.
    """
    sizes = tuple(sizes)
    axis = _split_axis(w, 1, sizes)
    if axis is None:
        return split_along(x @ w.to(x.dtype), -1, sizes)
    y = x @ _along((w,), 1, sizes, axis,
                   functools.partial(_regroup, inverse=False)).to(x.dtype)
    if _split_axis(y, y.ndim - 1, sizes) != axis:
        # its columns are in grouped order: a plain slice would be wrong
        raise ValueError(f"the product of a weight split along N over "
                         f"{axis!r} is laid out as {spec_of(y)}")
    return _along((y,), y.ndim - 1, sizes, axis, _pieces, len(sizes))


def _join(*pieces, dim, sizes, m, r, group):
    return _regroup(torch.cat(pieces, dim), dim, sizes, m, r, group,
                    inverse=True)


def join_along(pieces, dim: int) -> torch.Tensor:
    """``torch.cat(pieces, dim)``, the inverse of :func:`split_along`: on
    DTensors that it would split per rank (each rank holding its own shard
    of every piece, all laid out as the first) the ranks' pieces are
    joined locally and moved to the natural order by one all-to-all; else
    DTensor's ``cat``, which gathers the pieces along ``dim``."""
    dim = dim % pieces[0].ndim
    sizes = tuple(t.shape[dim] for t in pieces)
    axis = _split_axis(pieces[0], dim, sizes)
    if axis is None:
        return torch.cat(pieces, dim)
    return _along(tuple(pieces), dim, sizes, axis, _join)


def write_along(dst: torch.Tensor, dim: int, index, src: torch.Tensor) -> None:
    """``dst[..., index, ...] = src`` along ``dim``, in place; ``index`` is a
    slice of host ints or a 1-d index tensor of distinct positions.

    On a DTensor sharded along ``dim`` (a split-KV cache's sequence) each
    rank writes the positions its shard holds into its local shard, in
    O(len(index)) (DTensor cannot write in place across the shards of a
    dim): ``src`` is first laid out as ``dst`` but whole along ``dim``.
    """
    if not _sharded_along(dst, dim):
        dst[(slice(None),) * dim + (index,)] = src
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = dst.device_mesh
    place = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in dst.placements]
    if not is_sharded(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, place).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    n, off = shape[dim], offset[dim]
    loc = dst.to_local()
    if isinstance(index, slice):
        lo, hi = max(index.start, off), min(index.stop, off + n)
        if hi > lo:
            loc.narrow(dim, lo - off, hi - lo).copy_(
                src.narrow(dim, lo - index.start, hi - lo))
        return
    at = index - off
    mine = (at >= 0) & (at < n)
    # an entry this rank does not hold repeats its first one that it does
    # (the same position, the same value), so that index_copy_ writes
    # every position once whatever its order; a rank that holds none
    # writes its position 0's own value back
    first = mine.to(torch.int8).argmax()
    j = torch.where(mine, torch.arange(len(index), device=index.device),
                    first)
    held = mine.any()
    vals = torch.where(held, src.index_select(dim, j), loc.narrow(dim, 0, 1))
    loc.index_copy_(dim, torch.where(held, at[j], 0), vals)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over process groups; the backward passes the
    gradient through: the sum's every input sees the whole output."""

    @staticmethod
    def forward(x, *groups):
        from repro_torch.dist.collectives import all_reduce

        for g in groups:
            x = all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return (grad, *[None] * ctx.n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = len(inputs) - 1


def shard_map(fn, mesh, *, in_specs, out_specs, sum_over: tuple = ()):
    """``fn`` on each rank's shards (the reference's ``jax.shard_map``).

    Each argument is redistributed to its spec in ``in_specs`` (a plain
    tensor is taken as replicated) and ``fn`` gets the local shards: plain
    tensors, on which it may issue collectives itself. Its output is the
    local shard of ``out_specs``, or a tuple of them where ``out_specs`` is
    a tuple of specs; over the mesh axes in ``sum_over`` each rank holds a
    partial sum, which is summed (the reference's ``psum`` inside the
    function). With only plain tensors in, the output is the whole plain
    tensor.

    Gradients: the sum passes the output's gradient to every rank. An
    argument replicated over a mesh axis gets the sum of the ranks' local
    gradients over it where the ranks' outputs are distinct terms (the
    output is sharded over the axis, or summed over it); where the output
    is replicated over the axis too, every rank computed the same thing and
    holds the whole gradient.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = mesh_axis_names(mesh)
    groups = [mesh.get_group(a) for a in sum_over]
    many = not isinstance(out_specs, PartitionSpec)
    out_places = [placements(mesh, s)
                  for s in (out_specs if many else (out_specs,))]

    def split(place):
        return [not isinstance(p, Replicate) or a in sum_over
                for a, p in zip(names, place)]

    distinct = split(out_places[0])
    if any(split(place) != distinct for place in out_places[1:]):
        raise ValueError(f"out_specs {out_specs!r} must all split (or sum "
                         f"over) the same mesh axes")

    def run(*args):
        any_dt = any(isinstance(x, DTensor) for x in args)
        local = []
        for x, spec in zip(args, in_specs, strict=True):
            if not isinstance(x, DTensor):
                x = DTensor.from_local(x, mesh, [Replicate()] * len(names),
                                       run_check=False)
            place = placements(mesh, spec)
            grad_place = [Partial() if isinstance(pl, Replicate) and dist
                          else pl for pl, dist in zip(place, distinct)]
            local.append(x.redistribute(mesh, place)
                         .to_local(grad_placements=grad_place))
        outs = fn(*local)
        outs = list(outs) if many else [outs]
        for i, (out, place) in enumerate(zip(outs, out_places, strict=True)):
            if groups:
                out = _SumOver.apply(out, *groups)
            out = DTensor.from_local(out, mesh, place, run_check=False)
            outs[i] = out if any_dt else out.full_tensor()
        return tuple(outs) if many else outs[0]

    return run
