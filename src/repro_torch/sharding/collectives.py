"""Named-axis collectives over a ``launch.mesh.Mesh``: the ``jax.lax``
operations the sharded bodies use, written on plain ``torch.distributed``
calls over the mesh's gloo groups.

``psum``, ``pmean`` and ``pmax`` reduce over one axis or a tuple of axes;
``all_to_all`` is JAX's tiled all-to-all with split and concat on axis 0;
``ppermute`` sends along an axis by a permutation list, and a rank no
pair sends to receives zeros; ``axis_index`` and ``axis_size`` read the
mesh. ``all_gather`` and ``gather_to`` collect equal blocks, in the
group's rank order.

Where the bodies are differentiated, each operation is a
``torch.autograd.Function`` whose backward is JAX's transpose: ``psum``'s
is ``psum``, ``pmean``'s ``pmean``, ``all_to_all``'s the same all-to-all
(it is its own transpose), ``ppermute``'s the inverse permutation.
``replicated_input`` and ``replicated_output`` are the transposes
``shard_map`` applies at its boundary to a value replicated over axes
its specs leave out: forward the identity; backward a ``psum`` of the
cotangent for an input, a division by the axes' size for an output.
``pmax`` has no transpose, as in JAX, and raises under grad.

gloo runs ``all_reduce`` on CUDA tensors and nothing else. Every other
collective on a CUDA tensor is staged explicitly through pinned host
memory: one counted copy down and one up (``mesh.host_copies``). Nothing
falls back silently.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(name: str, mesh) -> int:
    return mesh.axis_index(name)


def axis_size(axes, mesh) -> int:
    return mesh.axis_size(axes)


# ------------------------------------------------------------- staging ---
def _down(x, mesh):
    """``x`` as a host tensor for gloo: itself on the host, a pinned copy
    (counted) of a CUDA tensor."""
    if x.device.type != "cuda":
        return x.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    mesh.host_copies += 1
    return h


def _up(h, like, mesh):
    """The host result ``h`` back on ``like``'s device (a counted copy to
    the card)."""
    if like.device.type != "cuda":
        return h
    mesh.host_copies += 1
    return h.to(like.device)


# ------------------------------------------------------------ reductions ---
def _all_reduce(x, axes, mesh, op):
    """``x`` reduced over ``axes``; gloo reduces CUDA tensors itself."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if mesh.axis_size(axes) > 1:
        dist.all_reduce(out, op=op, group=mesh.group(axes))
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_reduce(x, axes, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, ctx.mesh, dist.ReduceOp.SUM), \
            None, None


def psum(x, axes, mesh):
    """The sum of ``x`` over the ranks along ``axes``."""
    return _PSum.apply(x, axes, mesh)


def pmean(x, axes, mesh):
    """The mean of ``x`` over the ranks along ``axes`` (the sum divided by
    their number, as JAX's ``pmean``)."""
    return psum(x, axes, mesh) / mesh.axis_size(axes)


def pmax(x, axes, mesh):
    """The elementwise maximum of ``x`` over the ranks along ``axes``; no
    gradient (JAX's ``pmax`` has no transpose)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("pmax has no gradient")
    return _all_reduce(x, axes, mesh, dist.ReduceOp.MAX)


# ------------------------------------------------------ shard_map edges ---
class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, ctx.mesh, dist.ReduceOp.SUM), \
            None, None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.n = mesh.axis_size(axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def replicated_input(x, axes, mesh):
    """``x``, an input held whole on every rank along ``axes``: its
    cotangent is summed over them (shard_map's transpose of an input its
    ``in_specs`` leave unsharded over ``axes``)."""
    return _ReplicatedInput.apply(x, axes, mesh)


def replicated_output(x, axes, mesh):
    """``x``, an output equal on every rank along ``axes`` and consumed on
    each: the global cotangent is shared among them (shard_map's transpose
    of an ``out_specs=P()`` output without its replication check)."""
    return _ReplicatedOutput.apply(x, axes, mesh)


# ---------------------------------------------------------- all_to_all ---
def _all_to_all(x, axis, mesh):
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all over {n} ranks of a leading dim "
                         f"{x.shape[0]}")
    if n == 1:
        return x.detach().clone()
    h = _down(x.detach(), mesh)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=mesh.group(axis))
    return _up(out, x, mesh)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_to_all(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis, ctx.mesh), None, None


def all_to_all(x, axis: str, mesh):
    """JAX's ``all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=True)``: block i of ``x``'s leading dim goes to the i-th rank
    along ``axis``, and the blocks received are concatenated in rank
    order."""
    return _AllToAll.apply(x, axis, mesh)


# ------------------------------------------------------------ ppermute ---
def _ppermute(x, axis, perm, mesh):
    members = mesh.members(axis)
    me = mesh.axis_index(axis)
    group = mesh.group(axis)
    recv = torch.zeros(x.shape, dtype=x.dtype,
                       pin_memory=x.device.type == "cuda")
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, _down(x.detach(), mesh),
                                  members[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, recv, members[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _up(recv, x, mesh)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _ppermute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.axis, inverse, ctx.mesh), None, None, None


def ppermute(x, axis: str, perm, mesh):
    """JAX's ``ppermute``: for each pair (i, j) of ``perm`` the i-th rank
    along ``axis`` sends ``x`` to the j-th; a rank no pair sends to gets
    zeros. Non-blocking sends and receives posted together, so
    neighbouring ranks cannot deadlock."""
    return _PPermute.apply(x, axis, tuple(map(tuple, perm)), mesh)


# ------------------------------------------------------------- gathers ---
def all_gather(x, axes, mesh):
    """Every rank's ``x`` along ``axes``, as a list in the group's rank
    order (``mesh.members(axes)``), on ``x``'s device."""
    if mesh.axis_size(axes) == 1:
        return [x]
    h = _down(x.detach(), mesh)
    out = [torch.empty_like(h) for _ in mesh.members(axes)]
    dist.all_gather(out, h, group=mesh.group(axes))
    return [_up(o, x, mesh) for o in out]


def gather_to(x, axes, mesh, dst: int):
    """Every rank's ``x`` along ``axes`` on the world rank ``dst`` (a list
    in the group's rank order, on the host); None on the other ranks."""
    if mesh.axis_size(axes) == 1:
        return [_down(x.detach(), mesh)] if mesh.members(axes)[0] == dst \
            else None
    h = _down(x.detach(), mesh)
    me = dist.get_rank()
    out = [torch.empty_like(h) for _ in mesh.members(axes)] \
        if me == dst else None
    dist.gather(h, out, dst=dst, group=mesh.group(axes))
    return out
