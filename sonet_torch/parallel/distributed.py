"""Several processes, one program (port of the JAX package's
``parallel/distributed.py``, on ``torch.distributed``).

Every process runs the same code on byte-identical host values: the host
randomness (epoch shuffles, index tables, augmentation draws) is seeded
per (seed, mode, epoch, index), so each process computes the global batch
and keeps its block (``parallel.shard_batch``).  Process 0 owns the
console, the metric files and the checkpoints; the others wait at
``sync``.

``--distributed`` (``Config.distributed``):

* ``""``     -- off: one process;
* ``"auto"`` -- torchrun's environment (``init_method="env://"``:
  ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
* ``"HOST:PORT,NPROC,PID"`` -- ``tcp://HOST:PORT`` with that world size
  and rank (set PID per process).

The device rule: a rank on ``cuda`` takes ``cuda:LOCAL_RANK``, its index
among the processes of its host, which torchrun sets; it raises when
there is no such card, and when ``LOCAL_RANK`` is not set (a
``HOST:PORT,NPROC,PID`` spec launched by hand: PID is the global rank,
which says nothing of the host's cards).  A rank on a named card
(``cuda:0``) takes that card, which its ranks then share.

The backend rule, chosen before the group exists and never by trying:
``gloo`` on the CPU; ``nccl`` when each rank has its own card (``cuda``);
``gloo`` when the ranks name a card, since they may share it and NCCL
refuses two ranks on one device.  Gloo's CUDA support covers broadcast
and all-reduce, not all-gather, so every collective of the port is one of
those two (an all-gather is an all-reduce SUM of zero-padded blocks).
Gloo runs its collectives on the host, so a step that holds one cannot be
captured in a CUDA graph (``train/graphs.py`` refuses it by name and the
entry points run such steps eagerly).
"""

from __future__ import annotations

import os
from typing import Any, Optional


_DEVICE = None   # this rank's device, set by maybe_init_distributed


def parse_distributed_spec(text: Optional[str]):
    """``--distributed`` text -> None (off), {} (auto: torchrun's
    environment) or ``{"init_method", "world_size", "rank"}``.  Raises
    ValueError on junk rather than running one process."""
    if not text:
        return None
    text = text.strip()
    if text.lower() == "auto":
        return {}
    parts = [t.strip() for t in text.split(",")]
    if len(parts) != 3 or ":" not in parts[0]:
        raise ValueError(
            f"--distributed {text!r}: want 'auto' or 'HOST:PORT,NPROC,PID'")
    try:
        nproc, pid = int(parts[1]), int(parts[2])
    except ValueError:
        raise ValueError(f"--distributed {text!r}: NPROC and PID must be "
                         f"ints") from None
    if nproc < 1 or not 0 <= pid < nproc:
        raise ValueError(f"--distributed {text!r}: need NPROC >= 1 and "
                         f"0 <= PID < NPROC")
    return {"init_method": f"tcp://{parts[0]}", "world_size": nproc,
            "rank": pid}


def backend_for(device) -> str:
    """The process group's backend for ranks on ``device`` (see the module
    docstring): gloo on the CPU and on a named card, nccl on ``cuda``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type == "cuda":
        return "gloo" if dev.index is not None else "nccl"
    raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")


def rank_device(device, local_rank: Optional[int]):
    """This rank's device: ``cuda`` -> ``cuda:local_rank`` (raises when
    ``local_rank`` is None, i.e. ``LOCAL_RANK`` is not set, and when the
    host has no such card), a named card or the CPU as given."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        raise RuntimeError(
            "a rank on 'cuda' takes the card of its LOCAL_RANK, which is "
            "not set (torchrun sets it); set LOCAL_RANK to this process's "
            "index on its host, or name its card (--device cuda:N)")
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"rank with LOCAL_RANK {local_rank} on 'cuda' but the host has "
            f"{count} card(s); name a card (--device cuda:0) to share it "
            f"among the ranks")
    return torch.device("cuda", local_rank)


def maybe_init_distributed(spec: Optional[str],
                           device="cuda") -> bool:
    """Bring up the process group from a ``--distributed`` spec, once; a
    second call (the Trainer after an explicit caller) only checks.
    ``device`` is what the caller asked for (``cuda``, ``cuda:N`` or
    ``cpu``): it picks the backend and this rank's device
    (``current_device``), which becomes the current card.  Returns True
    iff the process runs in a group."""
    import torch
    import torch.distributed as dist

    global _DEVICE
    kwargs = parse_distributed_spec(spec)
    if kwargs is None:
        return dist.is_available() and dist.is_initialized()
    if dist.is_initialized():
        return True
    if not kwargs:
        unset = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                             "RANK") if k not in os.environ]
        if unset:
            raise ValueError(
                f"--distributed auto reads torchrun's environment, and "
                f"{', '.join(unset)} is not set: launch with torchrun (or "
                f"python -m torch.distributed.run), or give "
                f"HOST:PORT,NPROC,PID")
        kwargs = {"init_method": "env://"}
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else None
    backend = backend_for(device)
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _DEVICE = dev
    dist.init_process_group(backend=backend, **kwargs)
    if dist.get_rank() == 0:
        why = {"gloo": "ranks on the CPU" if dev.type == "cpu" else
               f"ranks share the named card {dev}",
               "nccl": "one card per rank"}[backend]
        print(f"distributed: {dist.get_world_size()} processes over "
              f"{backend} ({why})"
              + ("; steps run eagerly: gloo collectives cannot be captured"
                 if backend == "gloo" and dev.type == "cuda" else ""),
              flush=True)
    return True


def current_device():
    """This rank's device (set by ``maybe_init_distributed``); the CPU for
    a group brought up elsewhere on the CPU."""
    import torch
    import torch.distributed as dist

    if _DEVICE is not None:
        return _DEVICE
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def uses_gloo(mesh) -> bool:
    """True when ``mesh``'s collectives run on gloo (the host)."""
    import torch.distributed as dist

    return mesh is not None and dist.get_backend() == "gloo"


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on the process that owns the console and the run directory."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def all_gather(x, axes, mesh, lead: int = 0):
    """The global value of ``x``, this rank's block along the mesh axes
    ``axes`` of its dims from ``lead`` on (``parallel.mesh.block``), on
    every rank: an all-reduce SUM of the zero-padded blocks over the ranks
    of those axes (gloo has no all-gather for CUDA tensors).  Exact: each
    entry has one nonzero contribution."""
    import torch
    import torch.distributed as dist

    from .mesh import AXES, coordinate, mesh_shape
    if mesh is None or not axes:
        return x
    sizes = dict(zip(AXES, mesh_shape(mesh)))
    coords = dict(zip(AXES, coordinate(mesh)))
    if all(sizes[a] == 1 for a in axes):
        return x
    wide = x.to(torch.int32) if x.dtype == torch.bool else x
    dims = x.shape[lead:lead + len(axes)]
    out = wide.new_zeros(list(x.shape[:lead])
                         + [n * sizes[a] for n, a in zip(dims, axes)]
                         + list(x.shape[lead + len(axes):]))
    index = (slice(None),) * lead + tuple(
        slice(coords[a] * n, (coords[a] + 1) * n) for n, a in zip(dims, axes))
    out[index] = wide
    group = (None if len(set(axes)) == 2 else mesh.get_group(axes[0]))
    dist.all_reduce(out, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def fetch_global(tree: Any, mesh=None, specs: Optional[dict] = None) -> Any:
    """A tree of tensors (dict, list or tuple) as host numpy on every
    process.  Under a mesh a leaf with a leading axis is this rank's
    block of the 'data' axis and is all-gathered (``specs`` names other
    axes by key, e.g. ``{"score": ("data", "points")}``); a 0-d leaf is
    replicated and read as it is.  Other leaves pass through."""
    import torch

    specs = specs or {}

    def one(x, key=None):
        if isinstance(x, dict):
            return type(x)((k, one(v, k)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        if mesh is not None and x.dim() > 0:
            x = all_gather(x, specs.get(key, ("data",)), mesh)
        return x.detach().cpu().numpy()

    return one(tree)


def sync(name: str = "sonet") -> None:
    """A barrier over every process (nothing in one process)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any: an all-reduce
    MAX of the flag, called at the same points on every process."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=current_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())

