"""The collectives of the sharded train step: what XLA's SPMD partitioner
inserts into the JAX package's `shard_train_step`, written out as autograd
Functions over `torch.distributed` process groups.

A step runs inside `use(mesh)`, which makes the mesh's groups the ones
the model's layers, the losses and the optimizer reach through the
functions below; outside it (or on a mesh of one process) every function
is the identity, and the model computes exactly as on one device.

Megatron's four functions over the `model` axis:
- `copy_to_model`: identity forward, all-reduce backward (the input of a
  column-parallel layer, and a replicated parameter used on a shard);
- `reduce_from_model`: all-reduce forward, identity backward (the partial
  output of a row-parallel layer);
- `gather_from_model`: all-gather along a dimension, the local slice as its
  backward (a column-parallel output before a replicated consumer);
- `scatter_to_model`: the local slice, all-gather as its backward (a
  replicated input of a row-parallel layer).
Over the `data` axis: `data_sum`, a differentiable sum over the global
batch (forward and backward both all-reduce: every data rank holds the
same global loss, and `average_gradients` divides the summed gradients
by the data size), `average_gradients` between `backward()` and the
optimizer, and `global_rows`, which draws a tensor for the global batch
from a generator every rank holds in the same state and keeps this rank's
rows, so a data-parallel step draws what the one-device step draws.

Only `all_reduce`, `all_gather` and `broadcast` are used: gloo, which the
ranks that share a card (and the CPU) talk over, supports these three on
CUDA tensors, and not `reduce_scatter`.
"""

import contextlib

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_ACTIVE = None   # the mesh of the running step


@contextlib.contextmanager
def use(mesh):
    """Run the block with `mesh`'s process groups active."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def _axis(axis):
    """(group, size, rank) of an axis of the active mesh; (None, 1, 0)
    where there is none."""
    mesh = _ACTIVE
    if mesh is None:
        return None, 1, 0
    size = mesh.shape[axis]
    if size == 1:
        return None, 1, 0
    return mesh.group(axis), size, mesh.coords[axis]


def data_size():
    return _axis("data")[1]


def data_rank():
    return _axis("data")[2]


def model_size():
    return _axis("model")[1]


def model_rank():
    return _axis("model")[2]


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x, dim, group, size):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _local(x, dim, size, rank):
    return x.chunk(size, dim=dim)[rank].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.size, ctx.rank = dim, size, rank
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.dim, ctx.size, ctx.rank), None, None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _local(x, dim, size, rank)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, None, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_model(x):
    group, size, _ = _axis("model")
    return x if size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x):
    group, size, _ = _axis("model")
    return x if size == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim=-1):
    group, size, rank = _axis("model")
    return x if size == 1 else _GatherFromModel.apply(x, dim % x.dim(), group, size, rank)


def scatter_to_model(x, dim=-1):
    group, size, rank = _axis("model")
    return x if size == 1 else _ScatterToModel.apply(x, dim % x.dim(), group, size, rank)


def data_sum(x):
    """x summed over the data ranks (differentiable; see the module
    docstring for the scale of its gradient)."""
    group, size, _ = _axis("data")
    return x if size == 1 else _DataSum.apply(x, group)


def global_rows(draw, shape, dim=0):
    """draw(shape) for the global batch (dim `dim` times the data size),
    this data rank's rows of it; draw(shape) itself without a data axis."""
    _, size, rank = _axis("data")
    if size == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= size
    return draw(tuple(full)).narrow(dim, rank * shape[dim], shape[dim])


@torch.no_grad()
def average_gradients(params):
    """Each parameter's gradient averaged over the data ranks, in one
    all-reduce of a flat buffer; a missing gradient counts as zero, as the
    optimizer reads it."""
    group, size, _ = _axis("data")
    if size == 1:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for dtype in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = _flatten_dense_tensors([grads[i] for i in idx])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for i, g in zip(idx, _unflatten_dense_tensors(flat, [grads[i] for i in idx])):
            params[i].grad = g


def model_sum(x):
    """x summed over the model ranks (no gradient)."""
    group, size, _ = _axis("model")
    return x if size == 1 else _all_reduce(x, group)


@torch.no_grad()
def average_over_data(values):
    """A tensor averaged over the data ranks (metrics)."""
    group, size, _ = _axis("data")
    return values if size == 1 else _all_reduce(values, group) / size
