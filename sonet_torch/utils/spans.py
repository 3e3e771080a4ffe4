"""Named ranges of the program in a ``torch.profiler`` trace.

``with span("sonet:<name>"):`` marks the work inside it as a range of
that name (``torch.profiler.record_function``).  When the profiler also
records CUDA, kineto adds a device-side row of the same name, from the
first kernel the range launched to the last, on the kernels' clock.  The
``sonet:`` prefix keeps the program's ranges apart from those of whoever
profiles it.

When no profiler is recording, ``span`` makes one check and returns a
shared do-nothing context: it enters no profiler code and allocates
nothing.

The program's spans, and what reads them:

* ``sonet:EpochGraph.replay`` (``train/graphs.py``): one replay of a
  captured step, or one eager step on a host without a card.  Read by
  ``tools/torch_replay_ranges.py``, which compares the benchmark's replays
  of a traced train part (``benchmark/replays.py``) with these rows.
* ``sonet:decoder`` (``nn/decoder.py``): the autoencoder's decoder
  forward; ``sonet:chamfer`` (``ops/chamfer.py``): one Chamfer loss
  call.  Inside a captured step these are recorded at the capture only,
  so the benchmark reads them from a profiled eager step: the device time
  of the kernels the range's ops launch and of those their backward ops
  launch (``benchmark/span_time.py``, ``decoder_device_ms.train`` and
  ``chamfer_device_ms.train``).
* ``sonet:grouping`` (``nn/encoder.py``): the encoder's point-to-node
  grouping, from the top-k assignment to the decentered points (the
  node-sorted rows, the node counts and cluster sums, the recentered
  nodes).  Recorded at a capture only, as the decoder's range, and read
  the same way (``grouping_device_ms.train``).

Counters: ``ops.chamfer.calls`` (an attribute of the function, as
``windowed_vals.launches`` is), the Chamfer calls by (predicted points,
input points), counted where Python runs them (in a CUDA graph at its
capture), beside ``ops.cuda.batchnorm_act.launches``,
``ops.cuda.segment_max_grad.segment_max_grad.launches`` (node pooling's
backward on a card: one call, a launch of each of its two kernels),
``ops.cuda.segment_sums.segment_sums.launches`` (node recentering's sums
on a card) and ``ops.cuda.adam_step.adam_step.launches`` (Adam's update
of both groups on a card: one call a train step that Python runs, none
on a serve, infer or export path).
"""

from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking its body as the range ``name`` when a profiler is
    recording, and a shared do-nothing context when none is."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name)
