"""Captured steps: one step as a CUDA graph, replayed once per row of an
epoch's index table (the port's counterpart of the JAX package's
``jax.jit(..., donate_argnums=0)`` step scanned over an epoch by
``lax.scan``, ``data/device_pipeline.py:make_device_epoch_fns``).

``EpochGraph`` runs ``step(data, idx) -> {metric: tensor}`` for each row
``idx`` of an (S, B) table.  On a card the step is captured once into a
``torch.cuda.CUDAGraph`` over static buffers: the table, a row counter
and an (S, ...) buffer per metric, all on the card.  A replay reads the
row the counter names, runs the step, writes its metrics into that row
of the buffers and advances the counter, so an epoch is S replays and one
fetch of the metrics.  On the CPU the same step runs eagerly, row by row.

What a graph freezes at capture, and how each is kept right:

* values the step reads from Python (the learning rate, the BatchNorm
  momentum of the epoch): ``key()`` names them; when it changes the step
  is captured again before the next replay;
* tensors the step allocates are the graph's own, reused every replay;
  the state it updates in place (weights, running statistics, Adam's
  moments and a capturable Adam's step counters) keeps its addresses;
* random draws come from the generators registered with the graph, whose
  offsets every replay advances as an eager step would;
* Python counters the step advances (``TrainState.step``) are advanced by
  ``on_replay`` after each replay.

A capture is preceded by one eager warm-up step on a side stream (lazy
state, library handles), after which ``snapshot``'s restore puts the
state back, and the generators are reset to where they were.  A failed
capture raises; nothing falls back to eager replay on a card.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Sequence

import numpy as np
import torch

Step = Callable[[object, torch.Tensor], Dict[str, torch.Tensor]]


def _no_snapshot():
    return lambda: None


class EpochGraph:
    """Replay ``step`` once per row of an epoch's index table.

    ``generators``: the step's generators (registered with the graph);
    ``key``: Python values the step reads, checked before every replay;
    ``snapshot``: returns a function that restores the state the step
    changes (called around the warm-up); ``on_replay``: called after each
    replay.  ``captures`` and ``replays`` count what happened."""

    def __init__(self, step: Step, device: torch.device, *,
                 generators: Sequence[torch.Generator] = (),
                 key: Callable[[], Hashable] = lambda: None,
                 snapshot: Callable[[], Callable[[], None]] = _no_snapshot,
                 on_replay: Callable[[], None] = lambda: None):
        self.step = step
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.key = key
        self.snapshot = snapshot
        self.on_replay = on_replay
        self.captures = 0
        self.replays = 0
        self.captured_key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._bound = None            # (data's tensors' addresses, key)
        self._table = self._counter = None
        self._out: Dict[str, torch.Tensor] = {}

    # -- the CPU: eager ----------------------------------------------------
    def _run_eager(self, data, table: np.ndarray) -> Dict[str, np.ndarray]:
        rows = []
        for row in table:
            m = self.step(data, torch.from_numpy(row).to(self.device))
            rows.append({k: v.detach() for k, v in m.items()})
        return {k: torch.stack([r[k] for r in rows]).cpu().numpy()
                for k in rows[0]}

    # -- the card: captured ------------------------------------------------
    def _body(self, data) -> None:
        idx = self._table.index_select(0, self._counter).squeeze(0)
        m = self.step(data, idx)
        for k, buf in self._out.items():
            buf.index_copy_(0, self._counter, m[k].detach()[None].to(buf.dtype))
        self._counter.add_(1)

    def _capture(self, data, key) -> None:
        dev = self.device
        self.reset()
        gen_states = [g.get_state() for g in self.generators]
        restore = self.snapshot()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            m = self.step(data, self._table[0])
            shapes = {k: (v.shape, v.dtype) for k, v in m.items()}
            del m
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        restore()
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        if {k: (v.shape[1:], v.dtype) for k, v in self._out.items()} != shapes:
            cap = self._table.shape[0]
            self._out = {k: torch.zeros((cap,) + tuple(s), dtype=dt,
                                        device=dev)
                         for k, (s, dt) in shapes.items()}
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        # thread_local: a chunk-staging thread may pin memory and copy on
        # its own stream meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._body(data)
        restore()          # Python-side changes made while capturing
        self._graph = graph
        self.captures += 1
        self.captured_key = key
        self._bound = (self._addresses(data), key)

    @staticmethod
    def _addresses(data) -> tuple:
        return tuple(t.data_ptr() for t in data.tensors().values())

    def reset(self) -> None:
        """Drop the captured graph (the next replay captures anew): call it
        when the state's tensors were replaced, e.g. by a restore."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = None
        self._bound = None

    def run(self, data, table: np.ndarray) -> Dict[str, np.ndarray]:
        """Run the step for every row of ``table`` (S, B) over ``data`` (a
        ``DeviceData``); the stacked metrics (S, ...) on the host, fetched
        once."""
        table = np.ascontiguousarray(table, np.int64)
        if self.device.type != "cuda":
            return self._run_eager(data, table)
        S, B = table.shape
        if (self._table is None or self._table.shape[0] < S
                or self._table.shape[1] != B):
            self.reset()
            self._table = torch.zeros((S, B), dtype=torch.int64,
                                      device=self.device)
            self._counter = torch.zeros(1, dtype=torch.int64,
                                        device=self.device)
            self._out = {}
        self._table[:S].copy_(torch.from_numpy(table).pin_memory(),
                              non_blocking=True)
        self._counter.zero_()
        for _ in range(S):
            key = self.key()
            if (self._graph is None
                    or self._bound != (self._addresses(data), key)):
                self._capture(data, key)
            self._graph.replay()
            self.replays += 1
            self.on_replay()
        return {k: v[:S].cpu().numpy() for k, v in self._out.items()}
