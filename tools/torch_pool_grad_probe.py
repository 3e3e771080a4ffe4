#!/usr/bin/env python3
"""Where node pooling's backward, node recentering's sums and the batched
products spend their device time in a full-width train step on one NVIDIA
GPU.

    python3 tools/torch_pool_grad_probe.py [--preset modelnet40] [--steps 5]

Runs ``config.<preset>()`` (B=8, published widths, dropout off, seeded
random weights and clouds) eagerly: two warm-up steps, then ``--steps``
steps under torch.profiler with the operands' shapes recorded.  It puts a
range, ``probe:route_max_grad``, around each call of node pooling's
backward (``ops.segment_fast.route_max_grad`` and
``ops.segment.route_max_grad``, whichever the tree has the model call),
so it reads any tree of the port.  Per step it prints:

* each batched product (``aten::bmm``) by its operands' shapes: the
  kernels it launched, by name, with their device time;
* the kernels launched inside the backward's range, by name, with their
  device time;
* the kernels launched by the operator ``sonet_torch::segment_sums`` (node
  recentering's counts and sums over node-sorted rows), where the tree has
  it; a tree without it makes that product an ``aten::bmm`` of
  ``[B, M, kN] x [B, kN, 3]``;
* the device time of every kernel of the step.

The last line is a JSON object of the readings (ms a step).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

RANGE = "probe:route_max_grad"
SUMS_OP = "sonet_torch::segment_sums"


def _kernels_under(ev):
    """(name, us) of every device kernel launched by ``ev`` or the ops
    under it."""
    out = [(k.name, k.duration) for k in ev.kernels]
    for child in ev.cpu_children:
        out += _kernels_under(child)
    return out


def _batch(np, torch, cfg, device):
    rs = np.random.RandomState(0)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    batch = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
             "node": pc[:, :M] + 0.1 * rs.randn(B, M, 3).astype(np.float32)}
    if cfg.task == "segment":
        batch["label"] = rs.randint(0, 16, B).astype(np.int32)
        batch["seg"] = rs.randint(0, cfg.classes, (B, N))
    elif cfg.task == "classify":
        batch["label"] = rs.randint(0, cfg.classes, B)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="modelnet40")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("this probe runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from sonet_torch import config, train
    from sonet_torch.ops import segment, segment_fast

    for mod in (segment_fast, segment):
        real = mod.route_max_grad

        def ranged(*a, _real=real, **k):
            with record_function(RANGE):
                return _real(*a, **k)
        mod.route_max_grad = ranged

    dev = torch.device("cuda")
    cfg = getattr(config, args.preset)().replace(dropout=0.0)
    state = train.init_state(cfg, device=dev, seed=0)
    step, _ = train.make_steps(cfg, 10)
    batch = _batch(np, torch, cfg, dev)
    for _ in range(2):
        step(state, batch, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(args.steps):
            step(state, batch, None)
        torch.cuda.synchronize()

    n = args.steps
    bmm = defaultdict(lambda: defaultdict(float))
    pool = defaultdict(float)
    sums = defaultdict(float)
    calls = defaultdict(int)
    total = 0.0
    for ev in prof.events():
        if ev.name == "aten::bmm":
            key = str(ev.input_shapes)
            calls[key] += 1
            for name, us in _kernels_under(ev):
                bmm[key][name] += us
        elif ev.name == RANGE and ev.device_type == DeviceType.CPU:
            calls[RANGE] += 1
            for name, us in _kernels_under(ev):
                pool[name] += us
        elif ev.name == SUMS_OP and ev.device_type == DeviceType.CPU:
            calls[SUMS_OP] += 1
            for name, us in _kernels_under(ev):
                sums[name] += us
        # the device rows of ranges (kineto's annotations) are no work
        if (ev.device_type == DeviceType.CUDA
                and not ev.name.startswith(("probe:", "sonet:"))):
            total += ev.time_range.end - ev.time_range.start
    card = torch.cuda.get_device_name(0)
    print(f"{args.preset} train step, B={cfg.batch_size}, on {card}: "
          f"{total / n / 1e3:.4f} ms of kernels a step", flush=True)
    result = {"preset": args.preset, "card": card,
              "step_kernel_ms": total / n / 1e3, "bmm": {}, "pool_grad": {},
              "segment_sums": {}}
    for key, names in sorted(bmm.items(), key=lambda kv: -sum(
            kv[1].values())):
        ms = sum(names.values()) / n / 1e3
        print(f"aten::bmm {key}: {calls[key] / n:g} a step, {ms:.4f} ms",
              flush=True)
        for name, us in sorted(names.items(), key=lambda kv: -kv[1]):
            print(f"    {us / n / 1e3:.4f} ms  {name[:120]}", flush=True)
        result["bmm"][key] = {name: us / n / 1e3
                              for name, us in names.items()}
    ms = sum(pool.values()) / n / 1e3
    print(f"{RANGE}: {calls[RANGE] / n:g} a step, {ms:.4f} ms", flush=True)
    for name, us in sorted(pool.items(), key=lambda kv: -kv[1]):
        print(f"    {us / n / 1e3:.4f} ms  {name[:120]}", flush=True)
    result["pool_grad"] = {name: us / n / 1e3 for name, us in pool.items()}
    ms = sum(sums.values()) / n / 1e3
    print(f"{SUMS_OP}: {calls[SUMS_OP] / n:g} a step, {ms:.4f} ms",
          flush=True)
    for name, us in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"    {us / n / 1e3:.4f} ms  {name[:120]}", flush=True)
    result["segment_sums"] = {name: us / n / 1e3 for name, us in sums.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
