"""Captured steps: a step as a CUDA graph, the port's counterpart of the
JAX package's ``jax.jit`` (its train and eval steps, ``train/loops.py``;
its served forward, ``serving.py``; infer's and retrieval's eval steps)
and of its epoch scanned by ``lax.scan``
(``data/device_pipeline.py:make_device_epoch_fns``).

Two holders share one warm-up and capture (``_warm_up``, ``_capture``):

* ``StepGraph`` runs ``fn(*args, **kwargs) -> outputs`` with its inputs
  copied into static buffers on the card, one graph per input signature
  (names, shapes and dtypes), all of one holder in one memory pool.  A
  call copies its tensors into the buffers on the current stream and
  replays; it returns the graph's own output buffers, which the next
  replay overwrites, so a caller reads or clones them first.  The served forward, the host and
  native pipelines' train and eval steps, infer and retrieval run so.
* ``EpochGraph`` runs ``step(data, idx) -> {metric: tensor}`` for each
  row ``idx`` of an (S, B) table: the table, a row counter and an
  (S, ...) buffer per metric live on the card; a replay reads the row the
  counter names, runs the step, writes its metrics into that row of the
  buffers and advances the counter, so an epoch is S replays and one
  fetch of the metrics.  The device pipeline runs so.  In a profiler's
  trace each replay (each eager step on the CPU) is the range
  ``sonet:EpochGraph.replay`` (``utils/spans.py``).

On the CPU both run the same function eagerly.

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

Steps over a mesh (``mesh=``, ``parallel/``): collectives on NCCL are
captured with the rest of the step.  Gloo runs its collectives on the
host, where a graph cannot hold them: a holder given a mesh on gloo runs
its step eagerly, by that rule and not on a failure (``eager_by_rule``),
and a capture asked for under gloo raises by name
(``check_capturable``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import numpy as np
import torch

from ..utils.spans import span

Step = Callable[[object, torch.Tensor], Dict[str, torch.Tensor]]

# the profiler range around each of EpochGraph's steps (utils/spans.py)
REPLAY = "sonet:EpochGraph.replay"


def _no_snapshot():
    return lambda: None


def check_capturable(mesh) -> None:
    """Raise when ``mesh``'s collectives run on gloo: a CUDA graph cannot
    hold a collective that runs on the host."""
    from ..parallel.distributed import uses_gloo
    if uses_gloo(mesh):
        raise RuntimeError(
            "CUDA graph capture of a step over a gloo mesh: gloo runs its "
            "collectives on the host, which a graph cannot hold; such steps "
            "run eagerly (train.graphs.eager_by_rule)")


def eager_by_rule(device: torch.device, mesh) -> bool:
    """True when a step on ``device`` over ``mesh`` runs eagerly: on the
    CPU, and over a gloo mesh (``check_capturable``)."""
    from ..parallel.distributed import uses_gloo
    return torch.device(device).type != "cuda" or uses_gloo(mesh)


def _warm_up(warm: Callable[[], Any], device: torch.device,
             generators: Sequence[torch.Generator],
             snapshot: Callable[[], Callable[[], None]]):
    """Run ``warm()`` once eagerly on a side stream, then put the state and
    the generators back.  Returns (what ``warm`` returned, the restore
    function of the state as it was)."""
    gen_states = [g.get_state() for g in generators]
    restore = snapshot()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warmed = warm()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    restore()
    for g, s in zip(generators, gen_states):
        g.set_state(s)
    return warmed, restore


def _capture(body: Callable[[], Any], generators: Sequence[torch.Generator],
             restore: Callable[[], None], pool=None):
    """Capture ``body()`` into a new graph (in ``pool`` when one is given)
    with ``generators`` registered; ``restore`` puts back the Python-side
    changes made while capturing.  Returns (graph, what ``body``
    returned)."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        if g.device.type == "cuda":
            graph.register_generator_state(g)
    # thread_local: a loader or chunk-staging thread may pin memory and
    # copy on its own stream meanwhile
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        captured = body()
    restore()
    return graph, captured


class StepGraph:
    """Call ``fn(*args, **kwargs)`` as a captured CUDA graph over static
    input buffers, one graph per input signature: the positional inputs'
    shapes and dtypes, and the keyword inputs' names, shapes and dtypes,
    so a dict batch (``graph(**batch)``) binds each buffer to its name
    whatever the dict's order.

    ``generators``, ``key``, ``snapshot`` and ``on_replay`` are as for
    ``EpochGraph``.  ``captures`` and ``replays`` count what happened.
    The inputs are tensors (on the host, pinned for an asynchronous copy,
    or on the card); the outputs are tensors, or a dict, tuple or list of
    them, owned by the graph until the next call.  ``mesh``: the mesh the
    step runs over (eager over gloo, see the module docstring)."""

    def __init__(self, fn: Callable[..., Any], device: torch.device, *,
                 generators: Sequence[torch.Generator] = (),
                 key: Callable[[], Hashable] = lambda: None,
                 snapshot: Callable[[], Callable[[], None]] = _no_snapshot,
                 on_replay: Callable[[], None] = lambda: None, mesh=None):
        self.fn = fn
        self.device = torch.device(device)
        self.mesh = mesh
        self.eager = eager_by_rule(self.device, mesh)
        self.generators = tuple(generators)
        self.key = key
        self.snapshot = snapshot
        self.on_replay = on_replay
        self.captures = 0
        self.replays = 0
        # signature -> (graph, static args, static kwargs, outputs, key)
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None

    def _capture(self, sig: tuple, args, kwargs, key) -> tuple:
        check_capturable(self.mesh)
        dev = self.device
        old = self._graphs.pop(sig, None)
        if old is not None:
            old[0].reset()
        del old
        if not self._graphs:
            # a pool that no live graph holds takes no new capture (its
            # blocks may still back tensors, such as gradients, of the
            # graph just reset): start another
            self._pool = torch.cuda.graph_pool_handle()

        def empty(t):
            return torch.empty(t.shape, dtype=t.dtype, device=dev)
        with torch.inference_mode(False):    # written in place by every call
            s_args = [empty(t) for t in args]
            s_kwargs = {k: empty(t) for k, t in kwargs.items()}
        _fill(s_args, s_kwargs, args, kwargs)  # the warm-up reads real values
        _, restore = _warm_up(lambda: self.fn(*s_args, **s_kwargs), dev,
                              self.generators, self.snapshot)
        graph, out = _capture(lambda: self.fn(*s_args, **s_kwargs),
                              self.generators, restore, self._pool)
        entry = self._graphs[sig] = (graph, s_args, s_kwargs, out, key)
        self.captures += 1
        return entry

    def __call__(self, *args: torch.Tensor, **kwargs: torch.Tensor):
        if self.eager:     # host inputs go to the device, as a capture's do
            dev = self.device
            return self.fn(*(t.to(dev, non_blocking=True) for t in args),
                           **{k: t.to(dev, non_blocking=True)
                              for k, t in kwargs.items()})
        sig = (tuple((tuple(t.shape), t.dtype) for t in args),
               tuple(sorted((k, tuple(t.shape), t.dtype)
                            for k, t in kwargs.items())))
        key = self.key()
        entry = self._graphs.get(sig)
        if entry is None or entry[4] != key:
            entry = self._capture(sig, args, kwargs, key)
        graph, s_args, s_kwargs, out, _ = entry
        _fill(s_args, s_kwargs, args, kwargs)
        graph.replay()
        self.replays += 1
        self.on_replay()
        return out

    def reset(self) -> None:
        """Drop every captured graph (the next call captures anew)."""
        for graph, *_ in self._graphs.values():
            graph.reset()
        self._graphs.clear()


def _fill(s_args, s_kwargs, args, kwargs) -> None:
    """Copy the inputs into a graph's static buffers, on the current
    stream."""
    for s, t in zip(s_args, args):
        s.copy_(t, non_blocking=True)
    for k, s in s_kwargs.items():
        s.copy_(kwargs[k], non_blocking=True)


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
                 on_replay: Callable[[], None] = lambda: None, mesh=None):
        self.step = step
        self.device = torch.device(device)
        self.mesh = mesh
        self.eager = eager_by_rule(self.device, mesh)
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
            with span(REPLAY):
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
        check_capturable(self.mesh)
        dev = self.device
        self.reset()

        def warm():
            m = self.step(data, self._table[0])
            return {k: (v.shape, v.dtype) for k, v in m.items()}

        shapes, restore = _warm_up(warm, dev, self.generators, self.snapshot)
        if {k: (v.shape[1:], v.dtype) for k, v in self._out.items()} != shapes:
            cap = self._table.shape[0]
            self._out = {k: torch.zeros((cap,) + tuple(s), dtype=dt,
                                        device=dev)
                         for k, (s, dt) in shapes.items()}
        self._graph, _ = _capture(lambda: self._body(data), self.generators,
                                  restore)
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
        if self.eager:
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
            with span(REPLAY):
                self._graph.replay()
            self.replays += 1
            self.on_replay()
        return {k: v[:S].cpu().numpy() for k, v in self._out.items()}
