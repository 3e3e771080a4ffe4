#!/usr/bin/env python3
"""What the train step's three sorts cost on one NVIDIA GPU, the stable
PyTorch sorts beside the hand-written kernels that replace them.

    python3 tools/torch_sort_probe.py [--presets modelnet40,mnist] [--step]
                                      [--no-sites]

At each preset's shapes (``config.<preset>()``, B=8, and the raw cloud
size of its benchmark cell) it builds realistic inputs on the card
(``chip_smoke.sort_inputs``: uniform subsample keys, the squared distances
of random points to nodes drawn from them and of the nodes to each other,
the diagonal pinned at -1 as ``knn`` pins it, and the node ids of the
top-k assignment).  For each of the three
call sites it then reads:

* the plain version, the PyTorch code the step ran before the kernels (the
  argsort and its slice; the sort and its slices; the node sort with the
  inverse permutation's scatter and ``searchsorted``), timed by replaying
  a CUDA graph of it, and the kernels it launches, by name, from
  torch.profiler;
* ``torch.sort`` alone, by graph;
* the kernel (``ops.cuda.sorts``), by graph, and whether it equals the
  plain version (``==``).

With ``--step`` it also runs two eager train steps of each preset under
torch.profiler and sums the device time of the kernels that the
benchmark's ``sorts`` bucket would hold (names matching
``(?<!search)[Ss]ort|fill_index_and_segment``), by name.  With
``--no-sites`` it reads only that, so a copy of the probe reads a tree of
the port that lacks the kernels.

The last line is a JSON object of the readings (ms a call).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import defaultdict

# the raw points a cloud of each benchmark cell holds before the subsample
RAW_POINTS = {"modelnet40": 10000, "shapenetpart": 2048,
              "autoencoder": 2048, "mnist": 512}
SORTS = re.compile(r"(?<!search)[Ss]ort|fill_index_and_segment")


def _kernels(torch, fn):
    """(name, count) of every device row one call of ``fn`` makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                ("probe:", "sonet:")):
            names[e.name] += 1
    return dict(names)


def _sorted_first(torch, d, k):
    """``ops.pairwise._smallest_k`` before the kernel: a stable sort of
    every row and the first k columns of it."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _node_sort_before(torch, min_idx):
    """The encoder's node sort before the kernel, as it ran in the step."""
    id0 = min_idx[:, :1].long()
    min_idx, perm = torch.sort(min_idx, dim=1, stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm.scatter_(1, perm, torch.arange(
        perm.shape[1], device=perm.device).expand_as(perm))
    point0_idx = torch.searchsorted(min_idx, id0.to(min_idx.dtype),
                                    side="left")[:, 0]
    return min_idx, perm, inv_perm, point0_idx


def _site(torch, time_graph_ms, name, plain, kernel, library):
    want, got = plain(), kernel()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(
        want if isinstance(want, tuple) else (want,),
        got if isinstance(got, tuple) else (got,)))
    row = {"equal": equal,
           "plain_graph_ms": time_graph_ms(plain, reps=20, inner=10),
           "torch_sort_graph_ms": time_graph_ms(library, reps=20, inner=10),
           "kernel_graph_ms": time_graph_ms(kernel, reps=20, inner=10),
           "plain_kernels": _kernels(torch, plain),
           "kernel_kernels": _kernels(torch, kernel)}
    row["plain_launches"] = sum(row["plain_kernels"].values())
    print(f"  {name}: plain {row['plain_graph_ms']:.4f} ms "
          f"({row['plain_launches']} launches), torch.sort alone "
          f"{row['torch_sort_graph_ms']:.4f} ms, kernel "
          f"{row['kernel_graph_ms']:.4f} ms, equal {equal}", flush=True)
    for kname, n in sorted(row["plain_kernels"].items()):
        print(f"      plain: {n} x {kname[:110]}", flush=True)
    return row


def _step_sorts(torch, cfg, dev):
    """ms a step, by name, of the kernels the ``sorts`` bucket would hold,
    over two eager train steps of ``cfg`` on random clouds."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sonet_torch import train
    from sonet_torch.nn.encoder import spatial_dim
    rs = np.random.RandomState(0)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    D = spatial_dim(cfg)
    pc = rs.randn(B, N, D).astype(np.float32)
    batch = {"pc": pc, "node": pc[:, :M] + 0.1 * rs.randn(B, M, D).astype(
        np.float32)}
    if cfg.surface_normal:
        batch["sn"] = rs.randn(B, N, D).astype(np.float32)
    if cfg.task == "segment":
        batch["label"] = rs.randint(0, 16, B).astype(np.int32)
        batch["seg"] = rs.randint(0, cfg.classes, (B, N))
    elif cfg.task == "classify":
        batch["label"] = rs.randint(0, cfg.classes, B)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    state = train.init_state(cfg, device=dev, seed=0)
    step, _ = train.make_steps(cfg, 10)
    for _ in range(2):
        step(state, batch, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, batch, None)
        torch.cuda.synchronize()
    names = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and SORTS.search(e.name):
            names[e.name] += (e.time_range.end - e.time_range.start) / 2e3
    return dict(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", default=",".join(RAW_POINTS))
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--no-sites", dest="sites", action="store_false")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("this probe runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import time_graph_ms
    from sonet_torch import config

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    result = {"card": card, "presets": {}}
    for preset in args.presets.split(","):
        cfg = getattr(config, preset)().replace(dropout=0.0)
        entry = {}
        if args.sites:
            entry = _sites(torch, time_graph_ms, cfg, preset, card, dev)
        if args.step:
            step = _step_sorts(torch, cfg, dev)
            entry["step_sorts_ms"] = step
            print(f"{preset}: an eager train step's sorts bucket: "
                  f"{sum(step.values()):.4f} ms", flush=True)
            for kname, ms in sorted(step.items(), key=lambda kv: -kv[1]):
                print(f"      {ms:.4f} ms  {kname[:110]}", flush=True)
        result["presets"][preset] = entry
    print(json.dumps(result), flush=True)
    return 0


def _sites(torch, time_graph_ms, cfg, preset, card, dev):
    """The three call sites' readings at ``cfg``'s shapes."""
    from chip_smoke import sort_inputs
    from sonet_torch.nn.encoder import spatial_dim
    from sonet_torch.ops.cuda import sorts
    raw = RAW_POINTS[preset]
    B, N, M, k = cfg.batch_size, cfg.input_pc_num, cfg.node_num, cfg.k
    gen = torch.Generator(device=dev).manual_seed(0)
    keys, d_assign, d_knn, ids = sort_inputs(torch, gen, dev, B, raw, N,
                                             spatial_dim(cfg), M, k)
    print(f"{preset} on {card}: B={B}, {raw} raw points, N={N}, M={M}, "
          f"k={k}, som_k={cfg.som_k}", flush=True)
    rows = {}
    if raw > N:
        rows["subset_select"] = _site(
            torch, time_graph_ms, f"subset ({B}, {raw}) -> {N}",
            lambda: torch.argsort(keys, dim=1, stable=True)[:, :N],
            lambda: sorts.subset_select(keys, N),
            lambda: torch.sort(keys, dim=1, stable=True))
    for name, d, kk in (("smallest_k.assign", d_assign, k),
                        ("smallest_k.knn", d_knn, cfg.som_k)):
        if kk < 1:
            continue
        rows[name] = _site(
            torch, time_graph_ms, f"{name} {tuple(d.shape)} -> {kk}",
            lambda d=d, kk=kk: _sorted_first(torch, d, kk),
            lambda d=d, kk=kk: sorts.smallest_k(d, kk),
            lambda d=d: torch.sort(d, dim=-1, stable=True))
    rows["node_sort"] = _site(
        torch, time_graph_ms, f"node sort {tuple(ids.shape)}, M={M}",
        lambda: _node_sort_before(torch, ids),
        lambda: sorts.node_sort(ids, M),
        lambda: torch.sort(ids, dim=1, stable=True))
    plain = sum(r["plain_graph_ms"] for r in rows.values())
    kernel = sum(r["kernel_graph_ms"] for r in rows.values())
    print(f"  the three sites: plain {plain:.4f} ms, kernels "
          f"{kernel:.4f} ms a step", flush=True)
    return {"sites": rows, "plain_ms": plain, "kernel_ms": kernel}


if __name__ == "__main__":
    sys.exit(main())
