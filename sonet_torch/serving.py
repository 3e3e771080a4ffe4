"""Request-level serving of an eval-mode model and self-contained serving
artifacts (port of the JAX package's ``serving.py``: ``batch_buckets``,
``input_signature``, ``build_serve_fn``, ``export_run``,
``load_exported`` and ``ServingEngine`` with ``predict`` / ``warmup`` /
``stats``).

The engine serves a model at a fixed batch size ``B``: a request of any
``B' >= 1`` items is cut into ``ceil(B'/B)`` dispatches, the last padded
with copies of its last item, and the padding is sliced off.  Per-item
outputs do not depend on the batch in eval mode.  Dispatch is serialised
on a lock (one card, one model).  On a card each dispatch is one replay
of a captured CUDA graph (``train.graphs.StepGraph``), as the JAX
package's is one call of a jitted program: the chunk is written into
pinned host buffers, copied to the graph's static inputs, the graph
replayed and the output copied back before the lock is released.
``warmup`` captures; on the CPU the forward runs eagerly.

The engine serves a snapshot of the weights taken when it is built (a
copy of the model in eval mode), as the JAX package's closes over its
``params`` and ``batch_stats``: training the caller's module afterwards,
which switches it to train mode, changes none of the engine's answers.
``ServingEngine.from_run`` restores a finished run (its ``config.json``
and the newest checkpoint under ``ckpt/``).  ``start_microbatch`` turns on
the request micro-batcher: concurrent requests smaller than the batch
share one dispatch.

``from_run(mesh_shape=...)`` serves over a (data, points) mesh of the
processes of a ``--distributed`` run (``parallel/``): every rank calls
``predict`` with the same inputs, keeps its block of each dispatch, runs
the sharded forward and gathers the output, so every rank returns the
whole answer.  Over gloo (ranks sharing a card) the forward runs eagerly
(``train.graphs.eager_by_rule``).

Artifacts (``export_run``, ``load_exported``,
``ServingEngine.from_artifact``): a finished run's eval forward traced by
``torch.export`` with its weights and BatchNorm statistics inside, a
directory of::

    model.pt2       torch.export.save of the program
                    (model_b{b}.pt2 for each bucket of a bucketed one)
    manifest.json   task, input signature, output meaning, platforms,
                    pooling, what loading it requires, torch version,
                    source checkpoint

Calling convention (all arrays batch-major, spatial dim D=3, or 2 for
MNIST; shapes are those recorded in ``manifest["inputs"]``):

    classify/retrieve:  (pc, sn, node)          -> score  (B, classes)
    segment:            (pc, sn, node, label)   -> score  (B, N, classes)
    autoencode:         (pc, sn, node)          -> pc_out (B, output_pc_num, 3)

Platforms: an export's platform list defaults to its device's type.  Any
list with ``cpu`` forces ``pooling="scatter"`` and is traced and stored on
the CPU, whatever the export's device: the program holds plain ATen
operators only and its weights lie on the CPU, so it loads with ``torch``
alone, in a process that cannot import this package, on a host with or
without a card.  A program runs where its weights lie; ``load_exported``
moves one stored on another device type onto its device
(``torch.export.passes.move_to_device_pass``), and a process using
``torch`` alone does the same.  A ``cuda``-only export keeps the windowed
segment-max kernel as the operator ``sonet_torch::windowed_vals``; unlike
the JAX artifact, which embeds its Mosaic kernel, such a program names an
operator that must be registered before it loads, so ``load_exported``
imports ``sonet_torch.ops.cuda.segment_max_window`` (the operator alone,
no model code) when the manifest's ``requires`` lists it, and the kernel
is built from the package's source at first use.

``export_run(..., poly_batch=True)`` writes an any-batch-size artifact
(manifest shapes carry ``None``), in one of two forms:

- **bucketed** (the default without ``cpu`` in the platform list): one
  fixed-shape program per power-of-2 batch bucket up to the export's
  batch (``model_b1.pt2`` .. ``model_b{B}.pt2``), each keeping the kernel;
  a request pads to the smallest covering bucket and chunks above the
  largest; the weights are stored once per bucket;
- **symbolic** (with ``cpu``): one program with a symbolic batch
  dimension (``torch.export.Dim("b", min=1)``), on the portable scatter
  path; ``ServingEngine`` pads a dispatch to a power of 2.  On a card
  ``warmup`` captures the sizes 1, 2, 4 and 8, the micro-batcher's fill;
  a larger dispatch (a request of more than 8 items, or a coalesced group
  that overshoots 8) is captured at its first use, on the thread that
  dispatches it, and every size's graph, memory pool and pinned buffers
  are kept for the engine's life.

``load_exported``'s function is serialised by ``ServingEngine``; called
directly it is not safe from two threads at once.
"""

from __future__ import annotations

import copy
import json
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from . import train
from .config import Config, load_config
from .device import resolve_device
from .nn.encoder import resolve_pooling, spatial_dim
from .parallel import collectives
from .parallel.distributed import all_gather
from .parallel import mesh as pmesh
from .train.graphs import StepGraph, eager_by_rule

ARTIFACT_BLOB = "model.pt2"
ARTIFACT_MANIFEST = "manifest.json"
KERNEL_OP_MODULE = "sonet_torch.ops.cuda.segment_max_window"
# the micro-batcher fills a symbolic artifact's dispatch toward this size
_SYMBOLIC_FILL = 8

_OUTPUT_DOC = {"classify": "score (B, classes)",
               "retrieve": "score (B, classes)",
               "segment": "per-point score (B, N, classes)",
               "autoencode": "reconstructed cloud (B, P, 3)"}


def batch_buckets(max_batch: int) -> list:
    """Power-of-2 batch buckets covering ``1..max_batch`` (ascending,
    always ends exactly at ``max_batch``): 8 -> [1, 2, 4, 8];
    6 -> [1, 2, 4, 6]."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def input_signature(cfg: Config, batch_size: Optional[int] = None):
    """(name, shape, dtype) triples of the serving inputs for ``cfg``."""
    B = batch_size or cfg.batch_size
    D = spatial_dim(cfg)
    sig = [("pc", (B, cfg.input_pc_num, D), "float32"),
           ("sn", (B, cfg.input_pc_num, D), "float32"),
           ("node", (B, cfg.node_num, D), "float32")]
    if cfg.task == "segment":
        sig.append(("label", (B,), "int32"))
    return sig


def build_serve_fn(model: nn.Module, cfg: Config) -> Callable:
    """Eval-mode forward of a model: the inputs of ``input_signature`` as
    tensors on the model's device -> the task's output (``_OUTPUT_DOC``)."""
    if cfg.task not in _OUTPUT_DOC:
        raise NotImplementedError(f"unknown serving task {cfg.task!r} "
                                  f"(have {sorted(_OUTPUT_DOC)})")
    model.eval()
    autoencode = cfg.task == "autoencode"

    def serve(*inputs):
        with torch.inference_mode():
            out, _ = model(*inputs)
        return out.pc if autoencode else out

    return serve


class _ServeModule(nn.Module):
    """The eval forward as a module for ``torch.export``: the inputs of
    ``input_signature`` -> the task's output in float32."""

    def __init__(self, model: nn.Module, task: str):
        super().__init__()
        self.model = model.eval()
        self.autoencode = task == "autoencode"

    def forward(self, *inputs):
        out, _ = self.model(*inputs)
        return (out.pc if self.autoencode else out).float()


def _restore_run(run_dir: str, batch_size: Optional[int] = None,
                 checkpoint: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 pooling: Optional[str] = None, mesh=None):
    """Restore a finished run for serving: ``(cfg, model, state, ckpt)``,
    from ``run_dir/config.json`` and ``checkpoint`` (default: the newest
    under ``run_dir/ckpt``), on ``device``, with ``pooling`` in place of
    the run's when one is given; ``mesh`` is the serving mesh, whatever
    the run trained on."""
    cfg = load_config(os.path.join(run_dir, "config.json"))
    if batch_size:
        cfg = cfg.replace(batch_size=batch_size)
    cfg = cfg.replace(mesh_shape=pmesh.mesh_shape(mesh), distributed="")
    if pooling:
        cfg = cfg.replace(pooling=pooling)
    state = train.init_state(cfg, device=device, mesh=mesh)
    ckpt = checkpoint or train.latest_checkpoint(os.path.join(run_dir, "ckpt"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}/ckpt")
    state = train.restore_checkpoint(ckpt, state)
    return cfg, state.model, state, ckpt


def _host_call(forward: Callable, dev: torch.device,
               mesh=None) -> Callable:
    """numpy arrays -> numpy float32 output of ``forward`` (tensors on
    ``dev`` -> a float32 tensor).  On a card ``forward`` is a ``StepGraph``
    replay over pinned host buffers, one graph (and one set of buffers) a
    batch size; the output is copied out before the call returns.  The
    graph is the function's ``graph`` attribute (None where the forward
    runs eagerly: on the CPU, and over a gloo ``mesh``)."""
    if eager_by_rule(dev, mesh):
        def call(*arrays):
            tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in arrays]
            with torch.inference_mode():
                return forward(*tensors).float().cpu().numpy()

        call.graph = None
        return call

    graph = StepGraph(forward, dev)
    pinned = {}        # input signature -> (pinned inputs, pinned output)

    def call(*arrays):
        key = tuple((a.shape, a.dtype.str) for a in arrays)
        bufs = pinned.get(key)
        if bufs is None:
            ins = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   for a in arrays]
            bufs = pinned[key] = [ins, None]
        else:
            for t, a in zip(bufs[0], arrays):
                t.numpy()[...] = a
        out = graph(*bufs[0])
        if bufs[1] is None:
            bufs[1] = torch.empty(out.shape, dtype=out.dtype,
                                  pin_memory=True)
        bufs[1].copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return bufs[1].numpy().copy()

    call.graph = graph
    return call


def _check_platforms(platforms) -> list:
    out = [p.lower() for p in platforms]
    bad = sorted(set(out) - {"cpu", "cuda"})
    if bad or not out:
        raise ValueError(f"platforms {platforms!r}: want a list of 'cpu' "
                         f"and 'cuda'")
    return out


def export_run(run_dir: str, out_dir: Optional[str] = None,
               batch_size: Optional[int] = None,
               checkpoint: Optional[str] = None,
               platforms: Optional[list] = None,
               poly_batch: bool = False,
               bucketed: Optional[bool] = None,
               device: str | torch.device = "cuda") -> dict:
    """Export a finished run as a serving artifact; returns the manifest.

    The program is traced on ``device`` (``cuda`` unless the caller asks
    for ``cpu``).  ``platforms`` defaults to ``[device type]``; any list
    containing ``cpu`` forces the portable scatter pooling and a trace on
    the CPU (see the module doc).  ``poly_batch=True`` writes an
    any-batch-size artifact: bucketed without ``cpu`` in the list,
    symbolic with it; ``bucketed`` overrides that default
    (``bucketed=True`` with ``cpu``: per-bucket programs on the portable
    pooling).  A program that cannot be traced raises."""
    dev = resolve_device(device)
    platforms = _check_platforms(platforms or [dev.type])
    if bucketed is None:
        bucketed = poly_batch and "cpu" not in platforms
    bucketed = bucketed and poly_batch  # meaningless without poly_batch
    portable = "cpu" in platforms or (poly_batch and not bucketed)
    cfg = load_config(os.path.join(run_dir, "config.json"))
    pooling = ("scatter" if portable
               else resolve_pooling(cfg, "cuda" if "cuda" in platforms
                                    else dev))
    if "cpu" in platforms:      # stored on the CPU: loads without a card
        dev = torch.device("cpu")
    cfg, model, _, ckpt = _restore_run(run_dir, batch_size, checkpoint,
                                       device=dev, pooling=pooling)
    sig = input_signature(cfg, cfg.batch_size)
    module = _ServeModule(model, cfg.task)
    out_dir = out_dir or os.path.join(run_dir, "export")
    os.makedirs(out_dir, exist_ok=True)

    def example(b):
        return tuple(torch.zeros((b,) + tuple(s[1:]), dtype=getattr(torch, d),
                                 device=dev) for _, s, d in sig)

    def save(fname, inputs, dynamic_shapes=None) -> int:
        with torch.no_grad():
            program = torch.export.export(module, inputs,
                                          dynamic_shapes=dynamic_shapes)
        path = os.path.join(out_dir, fname)
        torch.export.save(program, path)
        return os.path.getsize(path)

    buckets = blobs = None
    if poly_batch and bucketed:
        # one fixed-shape program per power-of-2 batch bucket: static
        # shapes keep the kernel in every bucket
        buckets = batch_buckets(cfg.batch_size)
        blobs = {str(b): f"model_b{b}.pt2" for b in buckets}
        blob_bytes = sum(save(blobs[str(b)], example(b)) for b in buckets)
        shapes = [[None] + list(s[1:]) for _, s, _ in sig]
    elif poly_batch:
        # one symbolic-batch program, traced at a batch of at least 2
        # (torch.export specialises a dimension it sees at 0 or 1)
        b = torch.export.Dim("b", min=1)
        blob_bytes = save(ARTIFACT_BLOB, example(max(cfg.batch_size, 2)),
                          (tuple({0: b} for _ in sig),))
        shapes = [[None] + list(s[1:]) for _, s, _ in sig]
    else:
        blob_bytes = save(ARTIFACT_BLOB, example(cfg.batch_size))
        shapes = [list(s) for _, s, _ in sig]

    manifest = {
        "task": cfg.task,
        "inputs": [{"name": n, "shape": ms, "dtype": d}
                   for (n, _, d), ms in zip(sig, shapes)],
        "poly_batch": poly_batch,
        "output": _OUTPUT_DOC[cfg.task],
        "platforms": platforms,
        "pooling": pooling,
        "requires": ([KERNEL_OP_MODULE] if pooling == "sorted_window"
                     else []),
        "classes": cfg.classes,
        "checkpoint": ckpt,
        "torch_version": torch.__version__,
        "blob_bytes": blob_bytes,
    }
    if buckets is not None:
        manifest["buckets"] = buckets
        manifest["blobs"] = blobs
    with open(os.path.join(out_dir, ARTIFACT_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _load_program(path: str, dev: torch.device) -> Callable:
    """The program saved at ``path`` as a callable module on ``dev``."""
    program = torch.export.load(path)
    where = {t.device.type for t in (*program.state_dict.values(),
                                     *program.constants.values())
             if isinstance(t, torch.Tensor)}
    if where - {dev.type}:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    return program.module()


def load_exported(artifact_dir: str,
                  device: str | torch.device = "cuda"):
    """Load a serving artifact on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; its type must be among the manifest's platforms):
    returns ``(fn, manifest)``.

    ``fn(*arrays)`` runs the program on numpy arrays and returns a numpy
    float32 array; on a card every program is a captured graph.  It needs
    no model code, configuration or checkpoint of this package, only the
    operator module that ``manifest["requires"]`` names."""
    import importlib

    dev = resolve_device(device)
    with open(os.path.join(artifact_dir, ARTIFACT_MANIFEST)) as f:
        manifest = json.load(f)
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"artifact {artifact_dir} was exported for "
                         f"{manifest['platforms']}, not {dev.type}")
    for module in manifest.get("requires", []):
        importlib.import_module(module)   # registers the program's operators
    if manifest.get("buckets"):
        progs = {int(b): _load_program(os.path.join(artifact_dir, f), dev)
                 for b, f in manifest["blobs"].items()}
    else:
        progs = {None: _load_program(os.path.join(artifact_dir,
                                                  ARTIFACT_BLOB), dev)}

    def forward(*tensors):
        prog = progs.get(tensors[0].shape[0], progs.get(None))
        with torch.no_grad():
            return prog(*tensors)

    call = _host_call(forward, dev)
    b_max = None if None in progs else max(progs)

    def _call(cast):
        if b_max is None:
            return call(*cast)
        # bucketed: the smallest covering bucket per chunk, padded by
        # repeating the last row (per-item outputs are batch-independent
        # in eval mode), chunked above the largest
        B_req = cast[0].shape[0]
        outs = []
        for s in range(0, B_req, b_max):
            chunk = [a[s:s + b_max] for a in cast]
            n = chunk[0].shape[0]
            b = min(x for x in progs if x >= n)
            if b != n:
                chunk = [np.concatenate([a, np.repeat(a[-1:], b - n, axis=0)])
                         for a in chunk]
            outs.append(call(*chunk)[:n])
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def fn(*arrays):
        expect = manifest["inputs"]
        if len(arrays) != len(expect):
            names = [i["name"] for i in expect]
            raise ValueError(f"expected {len(expect)} inputs {names}, "
                             f"got {len(arrays)}")
        cast = [np.asarray(a, i["dtype"]) for a, i in zip(arrays, expect)]
        for a, i in zip(cast, expect):
            want = i["shape"]  # None = any batch (poly_batch export)
            if len(a.shape) != len(want) or any(
                    w is not None and w != g for w, g in zip(want, a.shape)):
                raise ValueError(f"input {i['name']}: expected shape "
                                 f"{want}, got {list(a.shape)}")
        if manifest.get("poly_batch"):
            sizes = {a.shape[0] for a in cast}
            if len(sizes) > 1:
                raise ValueError("inconsistent batch sizes across inputs: "
                                 f"{[a.shape[0] for a in cast]}")
            if 0 in sizes:
                raise ValueError("empty request batch (B=0); poly_batch "
                                 "artifacts require B >= 1")
        return _call(cast)

    fn.graph = call.graph
    return fn, manifest


def _mesh_call(serve: Callable, cfg: Config, dev: torch.device,
               mesh) -> Callable:
    """``_host_call`` over a mesh: the global batch's arrays -> this
    rank's block (``parallel.shard_batch``) -> the forward over the mesh
    -> the output gathered over the ranks (per-point scores over both
    axes), the whole answer on every rank."""
    names = [n for n, _, _ in input_signature(cfg, cfg.batch_size)]
    axes = ("data", "points") if cfg.task == "segment" else ("data",)

    def forward(*tensors):
        with collectives.use_mesh(mesh):
            out = serve(*tensors).float()
        return all_gather(out, axes, mesh)

    inner = _host_call(forward, dev, mesh)

    def call(*arrays):
        b = pmesh.shard_batch(dict(zip(names, arrays)), mesh)
        return inner(*(b[n] for n in names))

    call.graph = inner.graph
    return call


class ServingEngine:
    """Request-level serving wrapper over a fixed-batch forward.

    Construct with :meth:`from_model` (a built port model and a device),
    :meth:`from_run` (a run directory) or :meth:`from_artifact` (an
    ``export_run`` directory).  ``fn`` takes one numpy array per input,
    each ``(B, *item)``, and returns the output for those B items; its
    ``graph`` attribute, when it has one, is the ``StepGraph`` it replays
    on a card (``self.graph``).
    """

    def __init__(self, fn: Callable, manifest: dict):
        self._fn = fn
        self.graph: Optional[StepGraph] = getattr(fn, "graph", None)
        self.manifest = manifest
        self._lock = threading.Lock()        # device dispatch
        self._stats_lock = threading.Lock()  # traffic counters
        self.requests = 0
        self.items = 0
        self.dispatches = 0
        self.coalesced = 0
        self.total_s = 0.0
        self._batcher: Optional[_MicroBatcher] = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_artifact(cls, artifact_dir: str,
                      device: str | torch.device = "cuda"
                      ) -> "ServingEngine":
        """Serve an ``export_run`` artifact on ``device`` (``cuda`` unless
        the caller asks for ``cpu``): on a card each of its programs is a
        captured graph, one a batch size it is called at."""
        dev = resolve_device(device)
        fn, manifest = load_exported(artifact_dir, device=dev)
        return cls(fn, dict(manifest, device=str(dev), source="artifact"))

    @classmethod
    def from_model(cls, model: nn.Module, cfg: Config,
                   device: str | torch.device = "cuda",
                   batch_size: Optional[int] = None) -> "ServingEngine":
        """Serve a snapshot of ``model`` (built for ``cfg``) on ``device`` at
        batch size ``batch_size`` (default ``cfg.batch_size``); ``model``
        itself is left as it is.  Raises when ``device`` is ``cuda`` and
        there is no card."""
        return cls._serving(model, cfg, resolve_device(device),
                            batch_size or cfg.batch_size, {"source": "model"})

    @classmethod
    def from_run(cls, run_dir: str, batch_size: Optional[int] = None,
                 checkpoint: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 mesh_shape=None) -> "ServingEngine":
        """Serve a finished run: the model of ``run_dir/config.json`` with
        the weights of ``checkpoint`` (default: the newest under
        ``run_dir/ckpt``), on ``device``, at ``batch_size`` (default: the
        run's).  Raises when ``device`` is ``cuda`` and there is no card.

        ``mesh_shape`` (data[, points], or its text) serves over a mesh
        of the processes of a process group brought up first
        (``parallel.maybe_init_distributed``), by the rule of
        ``parallel.mesh.setup_mesh``: with none given, data parallel over
        every process of the group, and one process outside a group.  The state is replicated,
        each dispatch's items split over 'data' and its points over
        'points' (the module docstring); ``device`` ``cuda`` is then this
        rank's card.  A batch or cloud that the mesh does not divide exits
        with "--mesh_shape: ..." before the weights are read."""
        run_cfg = load_config(os.path.join(run_dir, "config.json"))
        _, mesh, dev = pmesh.setup_mesh(run_cfg.replace(
            batch_size=batch_size or run_cfg.batch_size, distributed="",
            mesh_shape=pmesh.mesh_shape_of(mesh_shape)), device)
        cfg, model, _, ckpt = _restore_run(run_dir, batch_size, checkpoint,
                                           device=dev, mesh=mesh)
        return cls._serving(model, cfg, dev, cfg.batch_size,
                            {"checkpoint": ckpt, "source": "run"}, mesh)

    @classmethod
    def _serving(cls, model: nn.Module, cfg: Config, dev: torch.device,
                 B: int, origin: dict, mesh=None) -> "ServingEngine":
        # a snapshot: the caller may go on training its module
        model = copy.deepcopy(model).to(dev)
        serve = build_serve_fn(model, cfg)
        if mesh is None:
            fn = _host_call(lambda *tensors: serve(*tensors).float(), dev)
        else:
            fn = _mesh_call(serve, cfg, dev, mesh)

        manifest = {
            "task": cfg.task,
            "inputs": [{"name": n, "shape": list(s), "dtype": d}
                       for n, s, d in input_signature(cfg, B)],
            "output": _OUTPUT_DOC[cfg.task],
            "platforms": [dev.type],
            "device": str(dev),
            "pooling": resolve_pooling(cfg, dev),
            "classes": cfg.classes,
            "mesh_shape": (list(pmesh.mesh_shape(mesh)) if mesh is not None
                           else None),
            **origin,
        }
        return cls(fn, manifest)

    # -- serving ------------------------------------------------------------

    @property
    def batch_size(self) -> Optional[int]:
        """The batch of every dispatch; None for a poly_batch artifact
        (any)."""
        return self.manifest["inputs"][0]["shape"][0]

    @property
    def input_names(self) -> list:
        return [i["name"] for i in self.manifest["inputs"]]

    def predict(self, inputs: dict) -> np.ndarray:
        """Run the model on named arrays; returns the stacked output.

        ``inputs`` maps input name -> array of shape ``(B', *item)`` for
        any ``B' >= 1`` (see the module doc for the chunk/pad semantics).
        """
        expect = self.manifest["inputs"]
        missing = [i["name"] for i in expect if i["name"] not in inputs]
        if missing:
            raise ValueError(f"missing inputs {missing} "
                             f"(want {self.input_names})")
        arrays, B_req = [], None
        for spec in expect:
            try:
                a = np.asarray(inputs[spec["name"]], spec["dtype"])
            except (TypeError, ValueError) as e:
                raise ValueError(f"input {spec['name']}: not convertible "
                                 f"to {spec['dtype']}: {e}") from None
            want = spec["shape"]
            if a.ndim != len(want) or list(a.shape[1:]) != want[1:]:
                raise ValueError(
                    f"input {spec['name']}: expected shape "
                    f"(B, {', '.join(map(str, want[1:]))}), "
                    f"got {list(a.shape)}")
            if B_req is None:
                B_req = a.shape[0]
            elif a.shape[0] != B_req:
                raise ValueError(
                    f"inconsistent batch sizes: {spec['name']} has "
                    f"{a.shape[0]}, expected {B_req}")
            arrays.append(a)
        if not B_req:
            raise ValueError("empty request batch")

        t0 = time.perf_counter()
        batcher = self._batcher  # racy vs stop_microbatch: read once
        if (batcher is not None
                and (self.batch_size is None or B_req < self.batch_size)):
            out = batcher.submit(arrays, B_req)
        else:
            out = self._dispatch(arrays, B_req)
        with self._stats_lock:
            self.requests += 1
            self.items += B_req
            self.total_s += time.perf_counter() - t0
        return out

    def _dispatch(self, arrays: list, B_req: int) -> np.ndarray:
        """Run validated arrays through the model (the chunk/pad core);
        serialised on the device lock."""
        B = self.batch_size
        outs = []
        with self._lock:
            if B is None:
                # poly_batch artifact: one dispatch, any B'.  A bucketed
                # one pads and chunks onto its programs inside fn; a
                # symbolic one is captured once per dispatched size, so B'
                # is padded up to a power of 2 here (the padding repeats
                # the last item and is sliced off)
                if not self.manifest.get("buckets"):
                    Bp = 1 << max(B_req - 1, 0).bit_length()
                    if Bp != B_req:
                        arrays = [np.concatenate(
                            [a, np.repeat(a[-1:], Bp - B_req, axis=0)])
                            for a in arrays]
                self.dispatches += 1
                return np.asarray(self._fn(*arrays))[:B_req]
            for s in range(0, B_req, B):
                chunk = [a[s:s + B] for a in arrays]
                n = chunk[0].shape[0]
                if n < B:
                    chunk = [np.concatenate(
                        [c, np.repeat(c[-1:], B - n, axis=0)]) for c in chunk]
                self.dispatches += 1
                outs.append(np.asarray(self._fn(*chunk))[:n])
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    # -- micro-batching ------------------------------------------------------

    def start_microbatch(self, window_ms: float = 5.0) -> None:
        """Coalesce CONCURRENT small requests into shared dispatches.

        A request of fewer items than the batch fills a dispatch only
        partly and still pays its whole cost.  With micro-batching on, such
        a request parks for up to ``window_ms`` while other requests
        arrive; parked requests are concatenated into one padded dispatch
        and each caller gets exactly its own rows back (per-row outputs do
        not depend on the batch in eval mode).  A single client's latency
        grows by at most ``window_ms``."""
        if self._batcher is None:
            self._batcher = _MicroBatcher(self, window_ms)

    def stop_microbatch(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    def warmup(self) -> None:
        """Run once on zeros (a bucketed artifact at each bucket, a
        symbolic one at one item, or on a card at each power of 2 up to
        the micro-batcher's fill) so that the first request finds the
        kernels built and loaded and, on a card, the forward captured on
        this thread; the traffic counters are left as they were."""
        sizes = self.manifest.get("buckets") or [self.batch_size or 1]
        if self.batch_size is None and self.graph is not None:
            sizes = batch_buckets(_SYMBOLIC_FILL)
        before = (self.requests, self.items, self.dispatches,
                  self.coalesced, self.total_s)
        for b in sizes:
            self.predict({i["name"]: np.zeros([b] + list(i["shape"][1:]),
                                              i["dtype"])
                          for i in self.manifest["inputs"]})
        (self.requests, self.items, self.dispatches, self.coalesced,
         self.total_s) = before

    def stats(self) -> dict:
        return {
            "task": self.manifest["task"],
            "batch_size": self.batch_size,
            "requests": self.requests,
            "items": self.items,
            "dispatches": self.dispatches,
            "coalesced_requests": self.coalesced,
            "microbatch": self._batcher is not None,
            "avg_ms_per_item": (round(self.total_s / self.items * 1e3, 3)
                                if self.items else None),
        }


class _MicroBatcher:
    """Request coalescer for :meth:`ServingEngine.start_microbatch`.

    One collector thread: takes the first parked request, keeps
    gathering until the batch is filled or ``window_ms`` elapses,
    concatenates, runs ONE ``engine._dispatch`` (which takes the engine's
    dispatch lock) and hands each caller its own rows.  Errors from the
    shared dispatch propagate to every participating caller."""

    _CLOSE = object()

    def __init__(self, engine: ServingEngine, window_ms: float):
        self._engine = engine
        self._window_s = max(window_ms, 0.0) / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._submit_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sonet-torch-microbatch")
        self._thread.start()

    def submit(self, arrays: list, n: int) -> np.ndarray:
        # the lock orders every enqueue before the CLOSE sentinel: a
        # predict() racing stop_microbatch() either lands in the queue
        # (the collector drains everything up to CLOSE) or dispatches
        # directly — it can never park forever behind the sentinel
        with self._submit_lock:
            if self._closed:
                return self._engine._dispatch(arrays, n)
            slot = {"done": threading.Event()}
            self._q.put((arrays, n, slot))
        slot["done"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(self._CLOSE)
        self._thread.join(timeout=10)

    def _loop(self) -> None:
        B = self._engine.batch_size
        if B is None:
            # a poly_batch artifact has no fixed batch: fill toward its
            # largest bucket, or 8 for a symbolic one
            buckets = self._engine.manifest.get("buckets")
            B = buckets[-1] if buckets else _SYMBOLIC_FILL
        while True:
            first = self._q.get()
            if first is self._CLOSE:
                return
            group = [first]
            total = first[1]
            deadline = time.perf_counter() + self._window_s
            while total < B:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is self._CLOSE:
                    self._finish(group, total)
                    return
                group.append(nxt)
                total += nxt[1]
            self._finish(group, total)

    def _finish(self, group: list, total: int) -> None:
        arrays = [np.concatenate([g[0][i] for g in group])
                  for i in range(len(group[0][0]))]
        try:
            out = self._engine._dispatch(arrays, total)
        except Exception as e:  # propagate to every caller
            for _, _, slot in group:
                slot["error"] = e
                slot["done"].set()
            return
        if len(group) > 1:
            with self._engine._stats_lock:
                self._engine.coalesced += len(group)
        ofs = 0
        for _, n, slot in group:
            slot["out"] = out[ofs:ofs + n]
            ofs += n
            slot["done"].set()
