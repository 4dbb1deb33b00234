"""Quantized collectives for bandwidth-bound reductions, as the reference's
``repro.dist.collectives``.

QGTC §4.5 cuts host<->device transfer by moving packed low-bit payloads;
the same trade applies to the cross-replica gradient reduction (Tango,
arXiv 2308.00890): quantize to int-nbits, all-reduce the integer payload
(nbits/32 of the bytes), dequantize once, and feed the rounding error back
into the next round so the *accumulated* stream stays unbiased.

Where the reference runs inside ``jax.shard_map`` over a named mesh axis,
the port runs on every rank of a ``torch.distributed`` group: a process
group, or one named dimension of a DeviceMesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["compressed_psum_mean", "all_reduce", "all_to_all", "all_gather"]


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``op``: "sum" or "max") over the ranks of ``group``, as
    a new tensor: a functional collective, so a dry run's recorder
    (``perf.roofline.record_collectives``) counts it. Not differentiable."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


def all_to_all(x: torch.Tensor, group, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The reference's ``jax.lax.all_to_all(x, axis, split_axis,
    concat_axis, tiled=True)`` over the ranks of ``group``, differentiable.

    ``x``'s ``split_axis`` is cut into one block a rank, block j going to
    rank j (one ``all_to_all_single``); the blocks received are joined
    along ``concat_axis`` in rank order.
    """
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd

    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0).contiguous()
    y = all_to_all_single_autograd(xs, None, None, group)
    y = y.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    y = y.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(y.shape)
    shape[concat_axis:concat_axis + 2] = [n * shape[concat_axis + 1]]
    return y.reshape(shape)


def all_gather(x: torch.Tensor, group, *, axis: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` joined along ``axis`` in rank order
    (``jax.lax.all_gather(..., tiled=True)``), differentiable: its backward
    is a reduce-scatter."""
    from torch.distributed import _functional_collectives as funcol

    # the older name on torch releases before all_gather_single_autograd
    gather = getattr(funcol, "all_gather_single_autograd",
                     None) or funcol.all_gather_tensor_autograd
    return gather(x.contiguous(), axis, group)


def _group(group_or_mesh_dim):
    """A process group from a group, None (the default group), or a
    ``(mesh, axis name)`` pair."""
    if isinstance(group_or_mesh_dim, tuple):
        mesh, axis = group_or_mesh_dim
        return mesh.get_group(axis)
    return group_or_mesh_dim


def compressed_psum_mean(x: torch.Tensor, group_or_mesh_dim=None, *,
                         nbits: int = 8, err: torch.Tensor | None = None):
    """Mean of ``x`` over the ranks of a group via an int-``nbits`` sum.

    Every rank of the group calls it with its own ``x`` (float32). The
    scale is shared across the group (an ``all_reduce(MAX)`` of the local
    maxima), so the payload on the wire is integer: an ``all_reduce(SUM)``
    of int32 ``q`` plus one scalar. The float32 operations run in the
    reference's order.

    err    previous round's residual (error feedback); pass the returned
           residual back in to keep the accumulated stream unbiased.

    Returns ``(mean, residual)``.
    """
    if not 2 <= nbits <= 16:
        raise ValueError(f"nbits must be in 2..16, got {nbits}")
    group = _group(group_or_mesh_dim)
    qmax = float((1 << (nbits - 1)) - 1)
    v = x if err is None else x + err
    gmax = v.abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = gmax[0].clamp(min=1e-12) / qmax
    q = torch.clamp(torch.round(v / scale), -qmax, qmax).to(torch.int32)
    deq = q.to(torch.float32) * scale
    residual = v - deq
    n = dist.get_world_size(group)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    total = q.to(torch.float32) * scale
    return total / n, residual
