"""Device-resident input pipeline: the whole raw split lives on the device
(port of the JAX package's ``data/device_pipeline.py``).

The host pipeline (``data/pipeline.BatchLoader``) reads, subsamples and
augments every item on the host, in series with the step on one
interpreter lock.  Here the raw split (full resolution, no augmentation)
is stacked once and copied to the device once; each step gathers its
rows, draws a distinct uniform subsample to ``input_pc_num`` and applies
the host loaders' augmentation stack (modelnet_shrec_loader.py:219-245)
as tensor ops on the device.  A step then moves only an index row; with
``train/graphs.py`` the whole step, this sampling included, is one
captured CUDA graph.

``sample_batch`` comes in two parts: ``draw_sample`` takes the random
tensors from a ``torch.Generator`` and ``apply_sample`` is a pure
function of the gathered batch and those draws.  Torch cannot reproduce
JAX's random streams, so the draws agree with the JAX package's in
distribution; fed the same draws, ``apply_sample`` gives its values.

A split above ``--device_budget_gb`` streams through ``ChunkedDeviceData``:
the stacked split stays on the host and an epoch is served in chunks,
staged one ahead into fixed device buffers.

Under a (data, points) mesh (``parallel/``) the index tables are the
global ones and every rank gathers its block of a row; the draws are the
global batch's, each rank keeping its rows and then its block of the
points (``sample_batch(mesh=...)``), so a mesh epoch draws what a
one-process epoch draws.  With ``--dataset_placement sharded`` each rank
holds only its data shard of the train split (``ShardedDeviceSplit``).
"""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.cuda.sorts import SUBSET_MAX_KEYS, subset_select

KEYS = ("pc", "sn", "node", "label", "seg")


@dataclass
class DeviceData:
    """A split's raw arrays on one device: ``pc`` and ``sn`` (T, N_raw, D),
    ``node`` (T, M, D), ``label`` (T,) int64, ``seg`` (T, N_raw) int64;
    ``sn`` and ``seg`` may be None.  ``shard``: the arrays hold one data
    shard of the split (``ShardedDeviceSplit``), whose tables index them
    per rank."""

    pc: torch.Tensor
    sn: Optional[torch.Tensor]
    node: torch.Tensor
    label: torch.Tensor
    seg: Optional[torch.Tensor] = None
    shard: bool = False

    @property
    def size(self) -> int:
        return self.pc.shape[0]

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in KEYS
                if getattr(self, k) is not None}


def _raw_getter(dataset):
    get = getattr(dataset, "raw_item", None)
    if get is None:
        raise TypeError(
            f"{type(dataset).__name__} has no raw_item(); the "
            "device-resident pipeline needs un-augmented full-resolution "
            "items (use the host input pipeline for this dataset)")
    return get


def stack_host_split(dataset) -> dict:
    """Stack a map-style dataset's raw items into host numpy arrays.

    Needs ``dataset.raw_item(idx)`` (full resolution, no subsample or
    augmentation): stacking ``dataset[idx]`` instead would bake one frozen
    train-time augmentation into the split and augment it again every
    step, so a dataset without ``raw_item`` raises ``TypeError``.  Every
    item must have the same shapes."""
    get = _raw_getter(dataset)
    first = get(0)
    T = len(dataset)
    keys = [k for k in KEYS if k in first]
    host = {k: np.empty((T,) + np.shape(first[k]),
                        np.asarray(first[k]).dtype) for k in keys}
    for i in range(T):
        item = get(i) if i else first
        for k in keys:
            host[k][i] = item[k]
    host["label"] = host["label"].astype(np.int64)
    return host


def split_nbytes(host: dict) -> int:
    return sum(a.nbytes for a in host.values())


def estimate_split_nbytes(dataset) -> int:
    """The stacked split's bytes from one raw item times the length,
    without stacking (labels counted at their stacked int64 width)."""
    first = _raw_getter(dataset)(0)
    per = 0
    for k in KEYS:
        if k in first:
            a = np.asarray(first[k])
            per += a.size * (8 if k == "label" else a.dtype.itemsize)
    return per * len(dataset)


def _as_tensor(a: np.ndarray, k: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if k in ("label", "seg") else t


def device_data_from_host(host: dict, device: str | torch.device = "cuda"
                          ) -> DeviceData:
    """Copy pre-stacked host arrays (``stack_host_split``) to ``device``."""
    dev = torch.device(device)
    t = {k: _as_tensor(a, k).to(dev) for k, a in host.items()}
    return DeviceData(pc=t["pc"], sn=t.get("sn"), node=t["node"],
                      label=t["label"], seg=t.get("seg"))


def load_device_data(dataset, device: str | torch.device = "cuda"
                     ) -> DeviceData:
    """Stack a dataset's raw items and copy them to ``device``.  For a
    split above the budget use ``ChunkedDeviceData`` (the ``Trainer``
    chooses by ``--device_budget_gb``)."""
    return device_data_from_host(stack_host_split(dataset), device)


class ShardedDeviceSplit:
    """A train split sharded over the mesh's ``data`` axis
    (``--dataset_placement sharded``; the JAX package's
    ``ShardedDeviceSplit``): each rank stacks and holds only its data
    shard's items, so D ranks keep a D times bigger split resident.

    Items are assigned to shards once, by a seeded global permutation
    (``default_rng(seed + 777)``), in near-equal counts; each epoch
    shuffles within the shards (``default_rng(seed + 1000 + epoch)``, one
    permutation per shard in shard order), and a batch is the union of
    the shards' rows -- stratified, not the one-process global shuffle,
    as in the JAX package.  ``epoch_index`` gives this rank's (S, B/D)
    table of LOCAL indices into ``data``; ``local_items`` the global ids
    this rank stacked."""

    def __init__(self, dataset, mesh, seed: int = 0,
                 device: str | torch.device = "cuda"):
        from ..parallel.mesh import coordinate, mesh_shape
        get = _raw_getter(dataset)
        T = len(dataset)
        self.dp = mesh_shape(mesh)[0]
        if T < self.dp:
            raise ValueError(
                f"dataset has {T} items but the 'data' mesh axis has "
                f"{self.dp} shards; sharded placement needs at least one "
                "item per shard -- use --dataset_placement replicated")
        self.size, self.seed = T, seed
        base, rem = divmod(T, self.dp)
        self.counts = np.array([base + (s < rem) for s in range(self.dp)],
                               np.int64)
        self.per = int(self.counts.max())
        perm = np.random.default_rng(seed + 777).permutation(T)
        offs = np.concatenate([[0], np.cumsum(self.counts)])
        self.shard = coordinate(mesh)[0]
        ids = perm[offs[self.shard]:offs[self.shard + 1]]
        self.local_items = sorted(int(g) for g in ids)
        first = get(int(ids[0]))
        keys = [k for k in KEYS if k in first]
        host = {k: np.empty((len(ids),) + np.shape(first[k]),
                            np.asarray(first[k]).dtype) for k in keys}
        for j, gid in enumerate(ids):
            item = get(int(gid))
            for k in keys:
                host[k][j] = item[k]
        host["label"] = host["label"].astype(np.int64)
        self.data = device_data_from_host(host, device)
        self.data.shard = True

    def nbytes_per_shard(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.data.tensors().values())

    def epoch_index(self, shuffle: bool, epoch: int, batch_size: int):
        """(this rank's (S, B/D) int64 table of local indices, each row's
        valid count), the same on every rank for (seed, epoch)."""
        if batch_size % self.dp:
            raise ValueError(
                f"--dataset_placement sharded needs batch_size "
                f"({batch_size}) divisible by the data-axis size "
                f"({self.dp})")
        b = batch_size // self.dp
        S = int(self.counts.min()) // b
        if S == 0:
            return None, []
        rng = np.random.default_rng(self.seed + 1000 + epoch)
        table = None
        for s in range(self.dp):      # every shard's draw, in order
            loc = (rng.permutation(int(self.counts[s])) if shuffle
                   else np.arange(int(self.counts[s])))
            if s == self.shard:
                table = loc[: S * b].reshape(S, b).astype(np.int64)
        return table, [batch_size] * S


class ChunkedDeviceData:
    """The device-resident pipeline for a split above the device budget.

    The stacked split stays on the host; an epoch is served as chunks of
    ``chunk_items`` items (a multiple of the batch).  A background thread
    slices the next chunk into pinned memory and copies it, on a side
    stream, into a staging buffer while the steps read the current one;
    the consumer then moves it into the fixed ``active`` buffers on the
    compute stream.  The buffers never move, so a step captured over
    ``active`` stays valid for every chunk, the short tail included (its
    table indexes only its own rows).  The budget holds the two buffers.

    An epoch is the resident pipeline's: one global shuffle by
    ``default_rng(seed + 1000 + epoch)``, then contiguous chunks, so the
    batches come in the same order and the run trains on the same
    trajectory (``Trainer._device_epoch_index``)."""

    def __init__(self, dataset_or_host, budget_bytes: int, batch_size: int,
                 device: str | torch.device = "cuda", seed: int = 0):
        host = (dataset_or_host if isinstance(dataset_or_host, dict)
                else stack_host_split(dataset_or_host))
        self.host = host
        self.size = host["pc"].shape[0]
        self.seed = seed
        self.device = torch.device(device)
        bpi = max(split_nbytes(host) // max(self.size, 1), 1)
        # two chunks resident (staging and active); at least one batch each
        per_chunk = max(int(budget_bytes) // (2 * bpi), batch_size)
        self.chunk_items = max(per_chunk // batch_size, 1) * batch_size
        self.num_chunks = -(-self.size // self.chunk_items)
        rows = min(self.chunk_items, self.size)

        def buffers():
            t = {k: torch.empty((rows,) + a.shape[1:],
                                dtype=_as_tensor(a[:1], k).dtype,
                                device=self.device)
                 for k, a in host.items()}
            return DeviceData(pc=t["pc"], sn=t.get("sn"), node=t["node"],
                              label=t["label"], seg=t.get("seg"))

        self.active = buffers()
        cuda = self.device.type == "cuda"
        self._staging = buffers() if cuda else None
        self._stream = torch.cuda.Stream(self.device) if cuda else None

    @staticmethod
    def _table(n_rows: int, batch_size: int):
        """(S, B) index table over ``n_rows`` staged rows, the last row
        padded by repeating its last index; and each row's valid count."""
        B = batch_size
        rows, valids = [], []
        for i in range(0, n_rows, B):
            n = min(B, n_rows - i)
            valids.append(n)
            row = np.arange(i, i + n, dtype=np.int64)
            if n < B:
                row = np.concatenate([row, np.full(B - n, row[-1])])
            rows.append(row)
        return np.stack(rows), valids

    def epoch_chunks(self, shuffle: bool, epoch: int, batch_size: int,
                     drop_last: bool) -> Iterator[tuple]:
        """Yield ``(active DeviceData, (S, B) int64 table, valids)`` for each
        chunk of the epoch; the next chunk stages while the caller's steps
        run.  With ``drop_last`` the global order is first cut to whole
        batches, as the resident pipeline does."""
        order = np.arange(self.size)
        if shuffle:
            order = np.random.default_rng(
                self.seed + 1000 + epoch).permutation(self.size)
        if drop_last:
            order = order[: (len(order) // batch_size) * batch_size]
        if len(order) == 0:
            return
        chunks = [order[i:i + self.chunk_items]
                  for i in range(0, len(order), self.chunk_items)]
        cuda = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=1)
        free = threading.Semaphore(1)      # the staging buffer may be written
        stop = threading.Event()
        consumed = torch.cuda.Event() if cuda else None

        def stage(ids):
            part = {k: _as_tensor(a[ids], k) for k, a in self.host.items()}
            if not cuda:
                return part, None
            part = {k: t.pin_memory() for k, t in part.items()}
            free.acquire()
            if stop.is_set():
                return None, None
            with torch.cuda.stream(self._stream):
                # the consumer's copy out of staging came first
                self._stream.wait_event(consumed)
                for k, t in part.items():
                    getattr(self._staging, k)[:len(ids)].copy_(
                        t, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            return part, ready

        def produce():
            try:
                for ids in chunks:
                    part, ready = stage(ids)
                    if stop.is_set():
                        return
                    q.put(("ok", (len(ids), part, ready)))
            except Exception as e:  # noqa: BLE001 -- reaches the consumer
                q.put(("err", e))

        t = threading.Thread(target=produce, daemon=True,
                             name="sonet-chunk-stage")
        t.start()
        try:
            for _ in chunks:
                kind, payload = q.get()
                if kind == "err":
                    raise payload
                n, part, ready = payload
                if cuda:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for k in part:
                        getattr(self.active, k)[:n].copy_(
                            getattr(self._staging, k)[:n])
                    consumed.record(cur)
                    free.release()
                else:
                    for k, v in part.items():
                        getattr(self.active, k)[:n].copy_(v)
                table, valids = self._table(n, batch_size)
                yield self.active, table, valids
        finally:
            stop.set()
            free.release()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()


# ---------------------------------------------------------------------------
# sampling on the device
# ---------------------------------------------------------------------------

def gather(data: DeviceData, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw rows ``idx`` (B,) of ``data``."""
    return {k: v.index_select(0, idx) for k, v in data.tensors().items()}


def draw_sample(generator: Optional[torch.Generator], B: int, n_raw: int,
                cfg: Config, *, train: bool, dim: int, has_sn: bool,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The random tensors of one ``sample_batch``, drawn from ``generator``:
    ``keys`` (B, n_raw) uniform when the batch is subsampled; in training
    ``roty`` (B,) uniform, ``rotp`` (B, 3) normal, ``jpc`` / ``jsn`` (B, N,
    D) and ``jnode`` (B, M, D) standard normal, ``scale`` (B, 1, 1) in
    [0.8, 1.2) and ``shift`` (B, 1, D) in [-0.1, 0.1), each under the
    switch of ``cfg`` that uses it (the JAX package's key splits)."""
    N, M = min(cfg.input_pc_num, n_raw), cfg.node_num
    kw = dict(generator=generator, device=device)
    d = {}
    if cfg.input_pc_num < n_raw:
        d["keys"] = torch.rand((B, n_raw), **kw)
    if not train:
        return d
    if cfg.rot_horizontal:
        d["roty"] = torch.rand((B,), **kw)
    if cfg.rot_perturbation:
        d["rotp"] = torch.randn((B, 3), **kw)
    d["jpc"] = torch.randn((B, N, dim), **kw)
    if has_sn:
        d["jsn"] = torch.randn((B, N, dim), **kw)
    d["jnode"] = torch.randn((B, M, dim), **kw)
    d["scale"] = torch.rand((B, 1, 1), **kw) * 0.4 + 0.8
    if cfg.translation_perturbation:
        d["shift"] = torch.rand((B, 1, dim), **kw) * 0.2 - 0.1
    return d


def _rot_y(u: torch.Tensor) -> torch.Tensor:
    """(B,) uniform draws -> (B, 3, 3) y-axis rotations by u * 2 pi
    (augmentation.py:37-55)."""
    theta = u * 2 * math.pi
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _rot_perturb(n: torch.Tensor, angle_sigma=0.06, angle_clip=0.18
                 ) -> torch.Tensor:
    """(B, 3) normal draws -> (B, 3, 3) small rotations Rz @ Ry @ Rx
    (augmentation.py:82-130)."""
    a = torch.clamp(angle_sigma * n, -angle_clip, angle_clip)
    cx, sx = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    cy, sy = torch.cos(a[:, 1]), torch.sin(a[:, 1])
    cz, sz = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    z, o = torch.zeros_like(cx), torch.ones_like(cx)
    Rx = torch.stack([torch.stack([o, z, z], -1),
                      torch.stack([z, cx, -sx], -1),
                      torch.stack([z, sx, cx], -1)], -2)
    Ry = torch.stack([torch.stack([cy, z, sy], -1),
                      torch.stack([z, o, z], -1),
                      torch.stack([-sy, z, cy], -1)], -2)
    Rz = torch.stack([torch.stack([cz, -sz, z], -1),
                      torch.stack([sz, cz, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    return Rz @ Ry @ Rx


def _jitter(x: torch.Tensor, n: torch.Tensor, sigma: float, clip: float):
    return x + torch.clamp(sigma * n, -clip, clip)


def apply_sample(raw: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                 cfg: Config, *, train: bool) -> Dict[str, torch.Tensor]:
    """Subsample and augment the gathered rows ``raw`` with ``draws``
    (``draw_sample``): the first ``input_pc_num`` points of a stable argsort
    of the keys (a distinct uniform subset; ``seg`` follows; for up to
    ``SUBSET_MAX_KEYS`` keys a row the selection ``subset_select``, on a
    card its kernel), then in
    training the y rotation, the 3-axis perturbation, jitter (points and
    normals 0.01 clipped at 0.05, nodes 0.04 at 0.1), the per-item scale
    and the shift.  A pure function: the same inputs give the same
    batch."""
    pc, sn, node = raw["pc"], raw.get("sn"), raw["node"]
    seg = raw.get("seg")
    if "keys" in draws:
        N = cfg.input_pc_num
        keys = draws["keys"]
        choice = (subset_select(keys.contiguous(), N)
                  if keys.shape[1] <= SUBSET_MAX_KEYS
                  else torch.argsort(keys, dim=1, stable=True)[:, :N])
        rows = choice[..., None].expand(-1, -1, pc.shape[-1])
        pc = torch.gather(pc, 1, rows)
        if sn is not None:
            sn = torch.gather(sn, 1, rows)
        if seg is not None:
            seg = torch.gather(seg, 1, choice)
    if train:
        for name, make in (("roty", _rot_y), ("rotp", _rot_perturb)):
            if name in draws:
                R = make(draws[name])
                pc, node = pc @ R, node @ R
                if sn is not None:
                    sn = sn @ R
        pc = _jitter(pc, draws["jpc"], 0.01, 0.05)
        if sn is not None:
            sn = _jitter(sn, draws["jsn"], 0.01, 0.05)
        node = _jitter(node, draws["jnode"], 0.04, 0.1)
        scale = draws["scale"]
        pc, node = pc * scale, node * scale
        if sn is not None:
            sn = sn * scale
        if "shift" in draws:
            pc, node = pc + draws["shift"], node + draws["shift"]
    batch = {"pc": pc.float(), "node": node.float(), "label": raw["label"]}
    if sn is not None:
        batch["sn"] = sn.float()
    if seg is not None:
        batch["seg"] = seg
    return batch


def sample_batch(data: DeviceData, idx: torch.Tensor,
                 generator: Optional[torch.Generator], cfg: Config, *,
                 train: bool, mesh=None) -> Dict[str, torch.Tensor]:
    """Gather, subsample and augment one batch on ``data``'s device: the
    rows ``idx`` (B,), then ``apply_sample`` with draws from
    ``generator``.  Reads nothing back to the host.

    Under a mesh ``idx`` is this rank's block of the batch's rows (B/D,):
    the draws are those of the whole batch (B rows), of which this rank
    keeps its own, and the batch is then cut to this rank's block of the
    points (``parallel.mesh.shard_points``)."""
    from ..parallel.mesh import coordinate, mesh_shape, shard_points
    D, d = mesh_shape(mesh)[0], coordinate(mesh)[0]
    b = idx.shape[0]
    raw = gather(data, idx)
    draws = draw_sample(generator, b * D, data.pc.shape[1], cfg,
                        train=train, dim=data.pc.shape[-1],
                        has_sn=data.sn is not None, device=data.pc.device)
    if D > 1:
        draws = {k: v[d * b:(d + 1) * b] for k, v in draws.items()}
    return shard_points(apply_sample(raw, draws, cfg, train=train), mesh)
