"""Collectives over the mesh's axes (port of
`mxnet_tpu/parallel/collectives.py`), on torch.distributed.

Each collective names mesh axes, as the reference's `lax` collectives do
inside `shard_map`; the mesh is the one `use_mesh` / `shard_map` made
current, or `mesh=`. On a mesh of one rank (no world) each is the
identity.

Gradients flow through them as JAX's AD gives them (the rank's loss is
one term of a sum over ranks): the backward of a sum-allreduce is a
sum-allreduce, all_gather and reduce_scatter are each other's transpose,
all_to_all's is the all_to_all that undoes it, and ring_permute's is the
permutation the other way round.

Transport. NCCL and gloo carry CUDA and CPU tensors alike for
all-reduce, all-gather, reduce-scatter, all-to-all and broadcast. The
one op gloo refuses on a CUDA tensor, its point-to-point send (under
`ring_permute`), moves through pinned host memory on that backend: the
tensor is copied to the host, sent from there, and the tensor received
is copied back. Only the transport moves: the arithmetic stays on the
card.
`counters()` reports the calls and bytes of each op, its logical payload
(the larger of what the rank sent in and received: an all-gather's whole
output; the compile watchdog's comms ledger reads it) and the bytes
staged through the host.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars

import torch

from ..base import MXNetError
from .mesh import P, current_mesh, use_mesh

_COUNTS = {"calls": collections.Counter(), "bytes": collections.Counter(),
           "payload": collections.Counter(), "staged_bytes": 0}
_DATA_AXIS = contextvars.ContextVar("mxnet_tpu_torch_data_axis",
                                    default=None)


def counters():
    """{"calls": {op: n}, "bytes": {op: payload bytes this rank sent
    in}, "payload": {op: max(bytes sent in, bytes received)},
    "staged_bytes": bytes copied through host memory}."""
    return {"calls": dict(_COUNTS["calls"]), "bytes": dict(_COUNTS["bytes"]),
            "payload": dict(_COUNTS["payload"]),
            "staged_bytes": _COUNTS["staged_bytes"]}


def reset_counters():
    _COUNTS["calls"].clear()
    _COUNTS["bytes"].clear()
    _COUNTS["payload"].clear()
    _COUNTS["staged_bytes"] = 0


class _Axis:
    """The group of this rank over some axes of a mesh."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = mesh._names(axes)
        self.size = mesh.axis_size(self.axes)
        self.group = mesh.group(self.axes)
        self.index = mesh.axis_index(self.axes) if self.size > 1 else 0

    @property
    def ranks(self):
        return self.mesh.group_ranks(self.axes)


def _axis(axis_name, mesh=None):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXNetError("collective over %r outside a mesh: call it inside "
                         "shard_map or `with use_mesh(mesh):`, or pass mesh="
                         % (axis_name,))
    return _Axis(mesh, axis_name)


def _count(op, t, received=None):
    n = t.numel() * t.element_size()
    _COUNTS["calls"][op] += 1
    _COUNTS["bytes"][op] += n
    _COUNTS["payload"][op] += max(n, received or 0)


def _to_host(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _COUNTS["staged_bytes"] += t.numel() * t.element_size()
    return host


def _back(host, like):
    _COUNTS["staged_bytes"] += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=False)


# ---------------------------------------------------------------------------
# transport (no autograd): each returns a new tensor
# ---------------------------------------------------------------------------


def all_reduce_raw(t, ax, op="sum"):
    """Sum (or "max") of t over the group, a new tensor."""
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=ax.group)
    return out


def all_gather_raw(t, ax, dim=0):
    """The group's tensors concatenated along `dim`, in axis_index
    order."""
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    x = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((ax.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", x, received=out.numel() * out.element_size())
    dist.all_gather_into_tensor(out, x, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter_raw(t, ax, dim=0):
    """This rank's block along `dim` of the group's sum."""
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    x = t.detach().movedim(dim, 0).contiguous()
    if x.shape[0] % ax.size:
        raise MXNetError("reduce_scatter: dimension %d of size %d does not "
                         "split over %d ranks" % (dim, x.shape[0], ax.size))
    _count("reduce_scatter", x)
    out = torch.empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=ax.group)
    return out.movedim(0, dim)


def all_to_all_raw(t, ax, split_axis, concat_axis):
    """Block j of t along split_axis goes to rank j; the blocks received
    are concatenated along concat_axis in rank order."""
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    if t.shape[split_axis] % ax.size:
        raise MXNetError("all_to_all: dimension %d of size %d does not split "
                         "over %d ranks" % (split_axis, t.shape[split_axis],
                                            ax.size))
    x = torch.stack(t.detach().chunk(ax.size, split_axis)).contiguous()
    _count("all_to_all", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return torch.cat(out.unbind(0), concat_axis)


def ring_raw(t, ax, shift=1):
    """The tensor of the rank `shift` places back on the ring over the
    group (each rank sends its own `shift` places on)."""
    if ax.group is None or shift % ax.size == 0:
        return t.clone()
    import torch.distributed as dist
    ranks = ax.ranks
    i = ax.index
    dst, src = ranks[(i + shift) % ax.size], ranks[(i - shift) % ax.size]
    x = t.detach().contiguous()
    _count("p2p", x)
    # gloo's send and recv take host tensors only
    staged = x.is_cuda and dist.get_backend(ax.group) == "gloo"
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, ax.group),
           dist.P2POp(dist.irecv, recv, src, ax.group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return _back(recv, x) if staged else recv


def all_reduce_flat(tensors, ax, bound=None):
    """Each tensor summed over the group: the tensors of one dtype
    flattened into one buffer and reduced at once (in pieces of at most
    `bound` elements when given). Returns a list of new tensors."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if bound and flat.numel() > bound:
            flat = torch.cat([all_reduce_raw(piece, ax)
                              for piece in torch.split(flat, int(bound))])
        else:
            flat = all_reduce_raw(flat, ax)
        for i, piece in zip(idx, torch.split(
                flat, [tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def broadcast_raw(t, ax, src_index=0):
    """The tensor of the group's rank `src_index`, on every rank."""
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    _count("broadcast", out)
    dist.broadcast(out, ax.ranks[src_index], group=ax.group)
    return out


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce_raw(x, ax)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather_raw(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.ax, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return reduce_scatter_raw(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.ax, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.ax, ctx.split, ctx.concat = ax, split_axis, concat_axis
        return all_to_all_raw(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.ax, ctx.concat, ctx.split), None, None, \
            None


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return ring_raw(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_raw(g, ctx.ax, -ctx.shift), None, None


def axis_size(axis_name, mesh=None):
    """The number of ranks over `axis_name` (a name or tuple of names)."""
    return _axis(axis_name, mesh).size


def axis_index(axis_name, mesh=None):
    """This rank's index over `axis_name` (`lax.axis_index`)."""
    return _axis(axis_name, mesh).index


def allreduce(x, axis_name, mesh=None):
    """Sum-allreduce over a mesh axis (`lax.psum`)."""
    return _AllReduce.apply(x, _axis(axis_name, mesh))


def allreduce_mean(x, axis_name, mesh=None):
    ax = _axis(axis_name, mesh)
    return _AllReduce.apply(x, ax) / ax.size


def allreduce_max(x, axis_name, mesh=None):
    """Max over a mesh axis (`lax.pmax`); not differentiated."""
    return all_reduce_raw(x.detach(), _axis(axis_name, mesh), op="max")


def reduce_scatter(x, axis_name, scatter_dim=0, mesh=None):
    """`lax.psum_scatter(..., tiled=True)`."""
    return _ReduceScatter.apply(x, _axis(axis_name, mesh), scatter_dim)


def all_gather(x, axis_name, gather_dim=0, mesh=None):
    """`lax.all_gather(..., tiled=True)`."""
    return _AllGather.apply(x, _axis(axis_name, mesh), gather_dim)


def ring_permute(x, axis_name, shift=1, mesh=None):
    """Send each shard `shift` places on around the ring (ppermute)."""
    return _Ring.apply(x, _axis(axis_name, mesh), shift)


def all_to_all(x, axis_name, split_axis, concat_axis, mesh=None):
    """The Ulysses-style sequence<->head reshard primitive
    (`lax.all_to_all(..., tiled=True)`)."""
    return _AllToAll.apply(x, _axis(axis_name, mesh), split_axis,
                           concat_axis)


def quantize_2bit(g, threshold):
    """The reference's gradient_compression.h quantizer: values >=
    threshold become +threshold, values <= -threshold become -threshold,
    the rest 0."""
    return torch.where(g >= threshold, torch.full_like(g, threshold),
                       torch.where(g <= -threshold,
                                   torch.full_like(g, -threshold),
                                   torch.zeros_like(g)))


def compressed_allreduce_2bit(x, axis_name, threshold=0.5, residual=None,
                              mesh=None):
    """2-bit-compressed allreduce with error feedback: `quantize_2bit` of
    x plus the residual is summed, and the quantization error carries
    into the next call. Returns (reduced, new_residual)."""
    g = x if residual is None else x + residual
    q = quantize_2bit(g, threshold).to(x.dtype)
    return all_reduce_raw(q, _axis(axis_name, mesh)), g - q


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _unmentioned(mesh, spec):
    named = set(P(*spec).axes())
    n = 1
    for a, s in mesh.shape.items():
        if a not in named:
            n *= s
    return n


class _ShardIn(torch.autograd.Function):
    """The rank's shard of a global tensor every rank holds. The
    backward sums every rank's shard cotangent into the global tensor's
    (JAX's shard_map transpose: all-gather over the spec's axes, psum
    over the others)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        idx = mesh.shard_slices(tuple(x.shape), spec)
        ctx.mesh, ctx.idx, ctx.shape = mesh, idx, tuple(x.shape)
        return x[idx].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.idx] = g
        return all_reduce_raw(full, _Axis(ctx.mesh, ctx.mesh.axis_names)), \
            None, None


class _ShardOut(torch.autograd.Function):
    """The global tensor assembled from every rank's shard. The backward
    takes the rank's block of the (replicated) global cotangent, divided
    by the ranks that hold the same block, as JAX's transpose does for
    an unmapped output."""

    @staticmethod
    def forward(ctx, y, mesh, spec):
        spec = tuple(spec) + (None,) * (y.dim() - len(spec))
        out = y.detach().clone()
        for dim, entry in enumerate(spec):
            if entry is not None and mesh.axis_size(entry) > 1:
                out = all_gather_raw(out, _Axis(mesh, entry), dim)
        ctx.mesh, ctx.spec = mesh, spec
        ctx.div = _unmentioned(mesh, spec)
        return out

    @staticmethod
    def backward(ctx, g):
        idx = ctx.mesh.shard_slices(tuple(g.shape), ctx.spec)
        return g[idx] / ctx.div, None, None


def _map_specs(fn, tree, specs):
    """Apply fn(leaf, spec) over `tree`, `specs` a prefix of it (a spec
    covers every leaf below it, as shard_map's in_specs)."""
    if isinstance(specs, P) or specs is None:
        spec = specs if specs is not None else P()
        return _tree_map(lambda t: fn(t, spec), tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map_specs(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, specs)


def _tree_map(fn, tree):
    from torch.utils import _pytree
    return _pytree.tree_map(
        lambda t: fn(t) if isinstance(t, torch.Tensor) else t, tree)


def shard_map(f, mesh, in_specs, out_specs, check_vma=None):
    """The per-rank form of `jax.shard_map`: the returned function takes
    global tensors (the same on every rank), hands `f` this rank's
    shards by `in_specs`, runs it with `mesh` current (so `f`'s
    collectives resolve its axes) and assembles the global outputs by
    `out_specs`; gradients flow back as JAX's shard_map transposes them.
    `check_vma` is accepted and ignored (no replication check)."""

    def wrapped(*args):
        local = _map_specs(lambda t, s: _ShardIn.apply(t, mesh, s),
                           tuple(args), tuple(in_specs))
        with use_mesh(mesh):
            out = f(*local)
        return _map_specs(lambda t, s: _ShardOut.apply(t, mesh, s), out,
                          out_specs)

    return wrapped


# ---------------------------------------------------------------------------
# BatchNorm over the data axis
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def data_axis_scope(mesh, axis):
    """Inside the block a training-mode BatchNorm takes its statistics
    over the global batch: the per-channel partials are reduced over
    `axis` of `mesh` (sync-BN semantics, as a GSPMD step computes them
    over the whole sharded batch). A mesh without the axis, or with one
    rank on it, changes nothing."""
    ax = None
    if mesh is not None and axis and mesh.axis_size(axis) > 1:
        ax = _Axis(mesh, axis)
    token = _DATA_AXIS.set(ax)
    try:
        yield ax
    finally:
        _DATA_AXIS.reset(token)


def batch_stat_axis():
    """The data axis BatchNorm reduces its partials over, or None."""
    return _DATA_AXIS.get()


def sync_mean_ex2(mean, ex2, ax):
    """The global (E[x], E[x^2]) from each rank's over equal shards,
    differentiable (the backward sums the ranks' cotangents)."""
    both = _AllReduce.apply(torch.stack([mean, ex2]), ax) / ax.size
    return both[0], both[1]


class _SumToReplicated(torch.autograd.Function):
    """The sum over every rank of the mesh, on every rank; the backward
    hands each rank's term the cotangent unchanged (each rank holds the
    same replicated total, and its backward stands for one copy)."""

    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce_raw(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_replicated(x, mesh):
    """Σ over the mesh's ranks of each rank's x, e.g. the global loss from
    the ranks' terms; differentiable as one replicated value."""
    return _SumToReplicated.apply(x, _Axis(mesh, mesh.axis_names))
