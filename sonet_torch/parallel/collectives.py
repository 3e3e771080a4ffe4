"""The mesh's collectives inside the model, and their gradients.

The JAX package computes on global arrays and GSPMD inserts these
reductions and their transposes; the port computes on each rank's block
and writes them out.  This file has no counterpart there.

The mesh in effect (``use_mesh``) is set by whoever built the step
(``train.make_steps(mesh=...)``, ``ServingEngine``): the layers read it
through ``active()``.  With no mesh, or an axis of size 1, every
function here is the identity and the model computes exactly what one
process computes.

Convention.  Along ``data`` each rank's work is its own (its items feed
its own share of the loss).  Along ``points`` a tensor is either
*point-level* -- this rank's part of the points (per-point features,
their partial sums) -- or *node-level* -- computed from replicated
inputs, equal on every points rank (the pooled nodes, the kNN layer, the
final PointNet, the heads, the loss).  A node-level tensor's cotangent on
each points rank is its whole cotangent; a point-level one's is this
rank's part.  So, for each collective with a gradient:

* ``sum_over(x, axes)``: all-reduce SUM of point-level partial sums into
  a value used point-level (BatchNorm statistics, over ``("data",
  "points")`` for per-point layers, over ``("data",)`` for node-level
  ones); the backward is the all-reduce SUM of the cotangents over the
  same ranks, as each rank holds its part of the statistic's cotangent.
* ``reduce_points(x)``: all-reduce SUM over ``points`` of point-level
  parts into a node-level value (the encoder's cluster sums and counts,
  the segmenter's and the Chamfer loss's point sums); the backward is the
  identity: the node-level cotangent is already whole on every rank.
* ``to_points(x)``: a node-level value used point-level (the node maps
  and the global feature gathered to the segmenter's points, the
  reconstruction seen by the input points); the identity forward, and
  the all-reduce SUM over ``points`` of the point-level cotangents.
* ``broadcast_points0(x)``: the value on points rank 0 (ORIGINAL stacked
  point 0's feature, which empty nodes take) on every points rank; the
  backward keeps the (node-level, whole) cotangent on rank 0 only.
* The pooling MAX over ``points`` lives with its kernel in
  ``ops/segment_fast.py`` (``windowed_vals_sharded``); its backward is
  ``route_max_grad`` with the tie counts summed over ``points``.

``sync_grads`` finishes a backward: a point-level parameter's gradient
is SUMmed over the whole mesh, a node-level one's over ``data`` only (it
is whole on each points rank and must not count P times); both are then
divided by D, since each data rank's loss is the mean over its own items.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from .mesh import AXES, coordinate, mesh_shape

_ACTIVE = None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Run the enclosed model code over ``mesh`` (None: one process)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def active():
    """The mesh in effect, or None."""
    return _ACTIVE


def axis_size(axis: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else _ACTIVE
    return dict(zip(AXES, mesh_shape(mesh)))[axis]


def axis_index(axis: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else _ACTIVE
    return dict(zip(AXES, coordinate(mesh)))[axis]


def _group(axes, mesh):
    """The process group of the ranks along ``axes`` through this rank,
    or None (no collective) when they are just this rank."""
    if mesh is None:
        return None
    axes = tuple(a for a in axes if axis_size(a, mesh) > 1)
    if not axes:
        return None
    if len(axes) == 2:
        return dist.group.WORLD        # the mesh covers the world
    return mesh.get_group(axes[0])


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                 ) -> torch.Tensor:
    """All-reduce ``t`` in place; a 16-bit float one goes through float32
    (gloo has no bfloat16 sum, and one rounding is kept)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, op=op, group=group)
        return t.copy_(wide)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce(x: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce (no gradient) of ``x`` over ``axes`` of the mesh in
    effect; returns a new tensor."""
    group = _group(axes, _ACTIVE)
    if group is None:
        return x
    return _all_reduce_(x.detach().clone(), group, op)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _ReducePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _BroadcastPoints0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, first):
        ctx.first = first
        out = x.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None, None


def sum_over(x: torch.Tensor, axes=AXES) -> torch.Tensor:
    """All-reduce SUM over ``axes`` of the active mesh; the backward sums
    the cotangents over the same ranks."""
    group = _group(axes, _ACTIVE)
    return x if group is None else _SumOver.apply(x, group)


def reduce_points(x: torch.Tensor) -> torch.Tensor:
    """All-reduce SUM over ``points`` into a node-level value; identity
    backward."""
    group = _group(("points",), _ACTIVE)
    return x if group is None else _ReducePoints.apply(x, group)


def to_points(x: torch.Tensor) -> torch.Tensor:
    """A node-level value used point-level: identity forward, backward
    summed over ``points``."""
    group = _group(("points",), _ACTIVE)
    return x if group is None else _ToPoints.apply(x, group)


def points0_rank(mesh=None) -> int:
    """The global rank of points rank 0 in this rank's data row."""
    mesh = mesh if mesh is not None else _ACTIVE
    return int(mesh.mesh[axis_index("data", mesh), 0])


def broadcast_points0(x: torch.Tensor) -> torch.Tensor:
    """Points rank 0's ``x`` on every points rank; the backward keeps the
    cotangent on rank 0 only."""
    mesh = _ACTIVE
    group = _group(("points",), mesh)
    if group is None:
        return x
    return _BroadcastPoints0.apply(x, group, points0_rank(mesh),
                                   axis_index("points", mesh) == 0)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean over ``data`` of a per-data-rank value (no gradient)."""
    d = axis_size("data")
    return x if d == 1 else all_reduce(x, ("data",)) / d


def point_level_parameters(model: torch.nn.Module) -> set:
    """The parameters of the layers that run on each rank's points
    (``PointLayer.sharded_points``): their gradients are partial along
    ``points``."""
    out = set()
    for m in model.modules():
        if getattr(m, "sharded_points", False):
            out.update(id(p) for p in m.parameters())
    return out


def sync_grads(model: torch.nn.Module, mesh) -> None:
    """Average the gradients of a backward over the mesh, in place (see
    the module docstring): point-level ones SUMmed over the mesh,
    node-level ones over ``data``, both divided by D.  Runs whenever a
    mesh is given, also in a world of one (one collective per kind of
    parameter, on one flat buffer)."""
    if mesh is None:
        return
    point = point_level_parameters(model)
    d = axis_size("data", mesh)
    kinds = {True: [], False: []}
    for p in model.parameters():
        if p.grad is not None:
            kinds[id(p) in point].append(p)
    for is_point, params in kinds.items():
        if not params:
            continue
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        group = (dist.group.WORLD if is_point
                 else mesh.get_group("data"))
        dist.all_reduce(flat, group=group)
        if d > 1:
            flat.div_(d)
        off = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def local_valid(valid: Optional[int], per: int, mesh=None) -> int:
    """Of the first ``valid`` items of a global batch, how many lie in this
    rank's block of ``per`` items along ``data``."""
    if valid is None:
        return per
    start = axis_index("data", mesh) * per
    return max(0, min(per, valid - start))
