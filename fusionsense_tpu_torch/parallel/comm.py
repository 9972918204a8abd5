"""Collectives over the mesh's axes: the counterparts of the jax.lax
collectives that fusionsense_tpu/parallel/sharded.py calls inside shard_map.

Each takes the Mesh and an axis name or a tuple of names, and runs one
torch.distributed call over the process group spanning those axes through
this rank; over a set of axes that spans one rank it is the identity and
makes no call. The gathers carry gradients: all_gather is an
autograd.Function whose backward is a reduce-scatter that SUMS the
cotangents of the group's members, which is what the transpose of
lax.all_gather is under shard_map(check_vma=False), and what the
1 / (n_tile * n_gauss) loss scaling of the sharded step relies on
(torch.distributed.nn.functional.all_gather cannot serve: its backward
scatters from a group-local source rank, which raises on any subgroup).

Buffers are passed flat: gloo's all_gather_into_tensor takes an output of
n * numel elements, not a stacked (n, ...) one. COUNTS and BYTES tally the
calls and the bytes each rank sends into them, by operation.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")
COUNTS = {k: 0 for k in OPS}
BYTES = {k: 0 for k in OPS}


def reset_counts() -> None:
    for k in OPS:
        COUNTS[k] = 0
        BYTES[k] = 0


def _tally(op: str, x: torch.Tensor) -> None:
    COUNTS[op] += 1
    BYTES[op] += x.numel() * x.element_size()


def _all_gather_flat(out, x, group):
    # all_gather_single is the newer name of all_gather_into_tensor
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_flat(out, x, group):
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    fn(out, x, op=dist.ReduceOp.SUM, group=group)


def _reduce(mesh, x: torch.Tensor, axes, op) -> torch.Tensor:
    group = mesh.group(axes)
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    _tally("all_reduce", y)
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(mesh, x, axes):
    return _reduce(mesh, x, axes, dist.ReduceOp.SUM)


def pmean(mesh, x, axes):
    return _reduce(mesh, x, axes, dist.ReduceOp.SUM) / mesh.size_of(axes)


def pmax(mesh, x, axes):
    return _reduce(mesh, x, axes, dist.ReduceOp.MAX)


def pmin(mesh, x, axes):
    return _reduce(mesh, x, axes, dist.ReduceOp.MIN)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tiled):
        group = mesh.group(axis)
        n = mesh.size_of(axis)
        ctx.group, ctx.n, ctx.shape = group, n, x.shape
        flat = x.detach().contiguous().reshape(-1)
        out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
        _tally("all_gather", flat)
        _all_gather_flat(out, flat, group)
        out = out.reshape(n, *x.shape)
        return out.reshape(n * x.shape[0], *x.shape[1:]) if tiled else out

    @staticmethod
    def backward(ctx, g):
        flat = g.contiguous().reshape(-1)
        out = torch.empty(flat.numel() // ctx.n, dtype=g.dtype,
                          device=g.device)
        _tally("reduce_scatter", flat)
        _reduce_scatter_flat(out, flat, ctx.group)
        return out.reshape(ctx.shape), None, None, None


def all_gather(mesh, x: torch.Tensor, axis: str, tiled: bool = False):
    """lax.all_gather(x, axis, axis=0, tiled): the members' x stacked on a
    new leading axis, or concatenated along axis 0 when tiled, in the
    axis's index order. Differentiable: the cotangent of this member's x is
    the sum over the members of their cotangents of its slice."""
    if mesh.group(axis) is None:
        return x if tiled else x[None]
    return _AllGather.apply(x, mesh, axis, tiled)


def psum_scatter(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True): the sum
    over the members, of which this member keeps its 1/n block of axis 0."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.size_of(axis)
    flat = x.detach().contiguous().reshape(-1)
    out = torch.empty(flat.numel() // n, dtype=x.dtype, device=x.device)
    _tally("reduce_scatter", flat)
    _reduce_scatter_flat(out, flat, group)
    return out.reshape(x.shape[0] // n, *x.shape[1:])


def broadcast_(mesh, tensors: list) -> None:
    """Overwrite every tensor in place with global rank 0's, one broadcast
    per dtype (the tensors packed flat)."""
    if mesh.size == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        buf = torch.cat([t.reshape(-1) for t in ts])
        if dtype == torch.bool:      # gloo moves bytes, not bools
            buf = buf.to(torch.uint8)
        _tally("broadcast", buf)
        dist.broadcast(buf, src=0)
        off = 0
        for t in ts:
            t.copy_(buf[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
