"""The (data, points) device mesh on ``torch.distributed`` (port of the
JAX package's ``parallel/mesh.py``).

One process per device.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"points")`` over the default process group, rank ``r`` at coordinate
``(r // P, r % P)`` (the JAX package's ``devices.reshape(D, P)``):

* ``data``   -- the batch: each data rank holds ``B / D`` items;
* ``points`` -- the cloud's N points: each points rank holds ``N / P``.

The train state is replicated (``replicate`` broadcasts it from rank 0).
Every rank computes the same global batch on the host, byte for byte, and
``shard_batch`` keeps its block, as the JAX package's processes feed
``jax.device_put`` identical host values.  What JAX's GSPMD inserts for
the cross-item and cross-point reductions, the port writes out in
``parallel/collectives.py``.

Nothing here imports torch at module level: ``config.py`` takes its
``parse_mesh_shape`` from here, and ``sonet-torch --help`` imports no
torch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

AXES = ("data", "points")
_MESHES: Dict[tuple, Any] = {}


def normalize_mesh_shape(shape: Sequence[int]) -> tuple:
    """Validate a (data[, points]) mesh shape and pad it to 2 axes.

    Raises ValueError on anything but 1-2 positive ints."""
    try:
        norm = tuple(int(s) for s in shape)
    except (TypeError, ValueError):
        raise ValueError(f"mesh shape {shape!r}: want (data,) or "
                         f"(data, points) positive ints") from None
    if not 1 <= len(norm) <= 2 or any(s < 1 for s in norm):
        raise ValueError(f"mesh shape {shape!r}: want (data,) or "
                         f"(data, points) positive ints")
    return norm + (1,) * (2 - len(norm))


def parse_mesh_shape(text: str) -> tuple:
    """A mesh shape from the command line ('4,2', '4x2', '8') as a
    normalized (data, points) pair: one parser for every entry point, so
    junk like ',' or 'x' is refused everywhere."""
    tokens = [t.strip() for t in str(text).replace("x", ",").split(",")]
    tokens = [t for t in tokens if t]
    if not tokens:
        raise ValueError(f"mesh shape {text!r}: no axis sizes found "
                         f"(want e.g. '8' or '4,2')")
    try:
        shape = tuple(int(t) for t in tokens)
    except ValueError:
        raise ValueError(f"mesh shape {text!r}: want comma- or "
                         f"'x'-separated positive ints") from None
    return normalize_mesh_shape(shape)


def check_mesh_divisible(shape: Sequence[int], batch_size: int,
                         input_pc_num: int) -> None:
    """Batch over 'data', points over 'points'; raises ValueError naming
    the axis that does not divide."""
    if batch_size % shape[0]:
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"data axis ({shape[0]})")
    if input_pc_num % shape[1]:
        raise ValueError(f"input_pc_num {input_pc_num} must divide over "
                         f"the points axis ({shape[1]})")


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = AXES, device_type: str | None = None):
    """The ``DeviceMesh`` of ``shape`` (default ``(world, 1)``: data
    parallel over every process) over the default process group, which
    must be up (``parallel.maybe_init_distributed``) and cover the mesh
    exactly: a mesh that leaves a process out would leave it waiting in
    the first collective.  ``device_type`` defaults to this rank's
    device's (``parallel.distributed.rank_device``).  One mesh per shape,
    built once (its groups are made collectively)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        want = math.prod(shape) if shape is not None else 1
        raise ValueError(
            f"mesh shape {tuple(shape) if shape else (1, 1)} ({want} "
            f"devices): a mesh needs one process per device, brought up "
            f"with --distributed (e.g. torchrun --nproc_per_node {want} "
            f"... --distributed auto)")
    world = dist.get_world_size()
    shape = normalize_mesh_shape(shape if shape is not None else (world,))
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh shape {shape} covers {math.prod(shape)} devices but the "
            f"process group has {world} processes; the mesh must cover "
            f"every process")
    key = (shape, tuple(axis_names))
    mesh = _MESHES.get(key)
    if mesh is None:
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        from .distributed import current_device
        dt = device_type or current_device().type
        ranks = torch.arange(world).reshape(shape)
        mesh = _MESHES[key] = DeviceMesh(dt, ranks,
                                         mesh_dim_names=tuple(axis_names))
    return mesh


def mesh_shape_of(value) -> tuple:
    """A mesh shape as an entry point takes it: a shape, a device count or
    the command line's text ('4,2', '4x2', '8'; text that is no shape
    exits), and None, 0 or '' for (1, 1), which ``setup_mesh`` reads as
    one process, or data parallel over a process group."""
    if isinstance(value, str) and value.strip():
        try:
            return parse_mesh_shape(value)
        except ValueError as e:
            raise SystemExit(f"--mesh_shape: {e}")
    if not value:
        return (1, 1)
    return normalize_mesh_shape(
        tuple(value) if isinstance(value, (tuple, list)) else (value,))


def _divisible_or_exit(shape, cfg) -> None:
    try:
        check_mesh_divisible(shape, cfg.batch_size, cfg.input_pc_num)
    except ValueError as e:
        raise SystemExit(f"--mesh_shape: {e}")


def setup_mesh(cfg, device="cuda"):
    """(cfg, mesh, device) for a run of ``cfg``: the process group brought
    up from ``cfg.distributed`` (``maybe_init_distributed``), the mesh of
    ``cfg.mesh_shape`` over it (data parallel over every process when the
    shape is (1, 1)), ``cfg`` carrying that shape, and this rank's
    device.  Exits with "--mesh_shape: ..." as soon as the shape is known
    when ``cfg.batch_size`` or ``cfg.input_pc_num`` does not divide over
    it, before anything is loaded.  Raises ValueError on junk in the spec,
    on a mesh that does not cover the process group, and on a mesh of
    several devices in one process; one process without a mesh gets
    ``(cfg, None, device)``."""
    from ..device import resolve_device
    from .distributed import (current_device, maybe_init_distributed,
                              process_count)
    shape = normalize_mesh_shape(cfg.mesh_shape)
    if math.prod(shape) > 1:
        _divisible_or_exit(shape, cfg)
    if not maybe_init_distributed(cfg.distributed, device):
        if math.prod(shape) > 1:
            make_mesh(shape)                # raises: no process group
        return cfg, None, resolve_device(device)
    if math.prod(shape) == 1:
        shape = (process_count(), 1)
        _divisible_or_exit(shape, cfg)
    mesh = make_mesh(shape, tuple(cfg.mesh_axes))
    return (cfg.replace(mesh_shape=shape), mesh,
            resolve_device(current_device()))


def mesh_for_config(cfg, device="cuda"):
    """The mesh of a run of ``cfg`` by ``setup_mesh``'s rule (the JAX
    package's name for it), or None for one process."""
    return setup_mesh(cfg, device)[1]


def mesh_shape(mesh) -> tuple:
    """(data, points) sizes of ``mesh``; (1, 1) for None."""
    if mesh is None:
        return (1, 1)
    return tuple(int(s) for s in mesh.mesh.shape)


def coordinate(mesh) -> tuple:
    """This rank's (data, points) coordinate in ``mesh``; (0, 0) for
    None."""
    if mesh is None:
        return (0, 0)
    return (mesh.get_local_rank(AXES[0]), mesh.get_local_rank(AXES[1]))


def batch_specs(cfg=None) -> Dict[str, tuple]:
    """The mesh axes of each leading dim of a task batch's tensors: the
    batch on 'data', the points on 'points'; the nodes and labels are
    replicated along 'points'."""
    return {
        "pc": ("data", "points"),
        "sn": ("data", "points"),
        "node": ("data",),
        "node_knn_I": ("data",),
        "label": ("data",),
        "seg": ("data", "points"),
    }


def block(x, spec: Sequence[str], mesh, lead: int = 0):
    """This rank's block of ``x`` (a numpy array or a tensor holding the
    global value) under ``spec`` (the axes of its dims from ``lead`` on):
    a view, not a copy."""
    if mesh is None or x is None:
        return x
    sizes = dict(zip(AXES, mesh_shape(mesh)))
    coords = dict(zip(AXES, coordinate(mesh)))
    index = [slice(None)] * lead
    for dim, axis in enumerate(spec, start=lead):
        n = x.shape[dim]
        if n % sizes[axis]:
            raise ValueError(f"dim {dim} of size {n} does not divide over "
                             f"the '{axis}' axis ({sizes[axis]})")
        per = n // sizes[axis]
        index.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return x[tuple(index)]


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's block of a global batch that every rank computed
    identically, with the canonical specs (``batch_specs``); keys without
    a spec (``valid``) pass through.  Views of the inputs."""
    specs = batch_specs()
    return {k: block(v, specs[k], mesh) if k in specs else v
            for k, v in batch.items()}


def shard_points(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's block of the points of a batch that already holds its
    data block (the device pipeline's, ``data/device_pipeline.py``)."""
    specs = batch_specs()
    return {k: (block(v, ("points",), mesh, lead=1)
                if "points" in specs.get(k, ()) else v)
            for k, v in batch.items()}


def shard_stacked(stacked: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``shard_batch`` for a chunk of K stacked batches, dict of (K, B,
    ...) arrays: the chunk axis is kept whole."""
    specs = batch_specs()
    return {k: block(v, specs[k], mesh, lead=1) if k in specs else v
            for k, v in stacked.items()}


def replicate(tree: Any, mesh) -> Any:
    """A copy of ``tree`` (a tensor, or a dict, list or tuple of them;
    other leaves pass through) holding rank 0's values on every rank.

    Alias-safe: the result is new storage, so the source can change (or
    be freed) without touching the copy.  Under a mesh every rank calls
    it in the same order (a broadcast per tensor, from global rank 0)."""
    import torch
    import torch.distributed as dist

    if isinstance(tree, dict):
        return type(tree)((k, replicate(v, mesh)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    out = tree.detach().clone()
    if mesh is not None and dist.get_world_size() > 1:
        dist.broadcast(out, src=0)
    return out
