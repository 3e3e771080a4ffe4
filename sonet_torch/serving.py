"""Request-level serving of an eval-mode model (port of the JAX package's
``serving.py``: ``batch_buckets``, ``input_signature``, ``build_serve_fn``
and ``ServingEngine`` with ``predict`` / ``warmup`` / ``stats``).

The engine serves a model at a fixed batch size ``B``: a request of any
``B' >= 1`` items is cut into ``ceil(B'/B)`` dispatches, the last padded
with copies of its last item, and the padding is sliced off.  Per-item
outputs do not depend on the batch in eval mode.  Dispatch is serialised
on a lock (one card, one model).

The engine serves a snapshot of the weights taken when it is built (a
copy of the model in eval mode), as the JAX package's closes over its
``params`` and ``batch_stats``: training the caller's module afterwards,
which switches it to train mode, changes none of the engine's answers.
``ServingEngine.from_run`` restores a finished run (its ``config.json``
and the newest checkpoint under ``ckpt/``).  The request micro-batcher,
export and serving over a device mesh arrive with later slices.
"""

from __future__ import annotations

import copy
import os
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


def _restore_run(run_dir: str, batch_size: Optional[int] = None,
                 checkpoint: Optional[str] = None,
                 device: str | torch.device = "cuda"):
    """Restore a finished run for serving: ``(cfg, model, state, ckpt)``,
    from ``run_dir/config.json`` and ``checkpoint`` (default: the newest
    under ``run_dir/ckpt``), on ``device``."""
    cfg = load_config(os.path.join(run_dir, "config.json"))
    if batch_size:
        cfg = cfg.replace(batch_size=batch_size)
    cfg = cfg.replace(mesh_shape=(1, 1))
    state = train.init_state(cfg, device=device)
    ckpt = checkpoint or train.latest_checkpoint(os.path.join(run_dir, "ckpt"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}/ckpt")
    state = train.restore_checkpoint(ckpt, state)
    return cfg, state.model, state, ckpt


class ServingEngine:
    """Request-level serving wrapper over a fixed-batch forward.

    Construct with :meth:`from_model` (a built port model and a device) or
    :meth:`from_run` (a run directory).
    ``fn`` takes one numpy array per input, each ``(B, *item)``, and
    returns the output for those B items.
    """

    def __init__(self, fn: Callable, manifest: dict):
        self._fn = fn
        self.manifest = manifest
        self._lock = threading.Lock()        # device dispatch
        self._stats_lock = threading.Lock()  # traffic counters
        self.requests = 0
        self.items = 0
        self.dispatches = 0
        self.total_s = 0.0

    # -- constructors -------------------------------------------------------

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
                 device: str | torch.device = "cuda") -> "ServingEngine":
        """Serve a finished run: the model of ``run_dir/config.json`` with
        the weights of ``checkpoint`` (default: the newest under
        ``run_dir/ckpt``), on ``device``, at ``batch_size`` (default: the
        run's).  Raises when ``device`` is ``cuda`` and there is no card."""
        dev = resolve_device(device)
        cfg, model, _, ckpt = _restore_run(run_dir, batch_size, checkpoint,
                                           device=dev)
        return cls._serving(model, cfg, dev, cfg.batch_size,
                            {"checkpoint": ckpt, "source": "run"})

    @classmethod
    def _serving(cls, model: nn.Module, cfg: Config, dev: torch.device,
                 B: int, origin: dict) -> "ServingEngine":
        # a snapshot: the caller may go on training its module
        model = copy.deepcopy(model).to(dev)
        serve = build_serve_fn(model, cfg)

        def fn(*arrays):
            tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in arrays]
            return serve(*tensors).float().cpu().numpy()

        manifest = {
            "task": cfg.task,
            "inputs": [{"name": n, "shape": list(s), "dtype": d}
                       for n, s, d in input_signature(cfg, B)],
            "output": _OUTPUT_DOC[cfg.task],
            "platforms": [dev.type],
            "device": str(dev),
            "pooling": resolve_pooling(cfg, dev),
            "classes": cfg.classes,
            **origin,
        }
        return cls(fn, manifest)

    # -- serving ------------------------------------------------------------

    @property
    def batch_size(self) -> int:
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
            for s in range(0, B_req, B):
                chunk = [a[s:s + B] for a in arrays]
                n = chunk[0].shape[0]
                if n < B:
                    chunk = [np.concatenate(
                        [c, np.repeat(c[-1:], B - n, axis=0)]) for c in chunk]
                self.dispatches += 1
                outs.append(np.asarray(self._fn(*chunk))[:n])
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def warmup(self) -> None:
        """Run once on zeros so that the first request finds the kernels
        built and loaded; the traffic counters are left as they were."""
        zeros = {i["name"]: np.zeros(i["shape"], i["dtype"])
                 for i in self.manifest["inputs"]}
        before = (self.requests, self.items, self.dispatches, self.total_s)
        self.predict(zeros)
        (self.requests, self.items, self.dispatches, self.total_s) = before

    def stats(self) -> dict:
        return {
            "task": self.manifest["task"],
            "batch_size": self.batch_size,
            "requests": self.requests,
            "items": self.items,
            "dispatches": self.dispatches,
            "avg_ms_per_item": (round(self.total_s / self.items * 1e3, 3)
                                if self.items else None),
        }
