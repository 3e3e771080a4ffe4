#!/usr/bin/env python3
"""Kernel 1 (the windowed segment max) alone on one CUDA card: where its
time goes, and what a launch costs the host.

    python3 tools/torch_kernel1_probe.py [--sweep]

At (8, 15000, 384) bf16, the same in float32, and (64, 15000, 384) bf16,
M = 64, with node-sorted ids from a real top-k assignment (the inputs of
``chip_smoke.py`` phase 3), it prints for ``windowed_vals``:

- the time by CUDA events around 20 launches made from Python (a slow
  host floors this reading), and by a CUDA graph of 20 captured launches
  replayed (the host starts one replay, so it cannot);
- from a torch.profiler trace of 20 calls, the device duration of the fill
  kernel and of the main kernel apart, and the idle gap between them;
- the wrapper's host time per call: the host clock around 200 calls
  made without waiting, before one synchronize;
- the memory bound of the shape, and the shares of it.

``--sweep`` also times the bulk kernel's ring under other settings
(stages, bytes a stage, blocks a multiprocessor) through the library's
``sonet_segment_max_window_config``, each by graph replay on the first
and the last shape.
"""

import argparse
import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sonet_torch.ops import cuda  # noqa: E402
from sonet_torch.ops.cuda import segment_max_window as smw  # noqa: E402

M, C, N, K = 64, 384, 5000, 3
SHAPES = ((8, torch.bfloat16), (8, torch.float32), (64, torch.bfloat16))
SWEEP = [(s, kb * 1024, k) for k in (1, 2) for s in (2, 3, 4, 6)
         for kb in (12, 24, 32, 48) if s * kb * k <= 216]


def inputs(gen, dev):
    for B, dtype in SHAPES:
        ids = cs._flagship_ids(torch, B, N, M, K, gen, dev)
        data = torch.randn((B, K * N, C), generator=gen,
                           device=dev).to(dtype)
        nbytes = (data.numel() * data.element_size() + ids.numel() * 4
                  + B * M * C * 4)
        yield data, ids, cs._bound(nbytes, data.numel())[0], nbytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel1_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cs.phase_device()
    cuda.build(["segment_max_window"])
    for ln in cuda.ptxas_log("segment_max_window").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print("  ptxas:", ln.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    kept = []
    for data, ids, bound_ms, nbytes in inputs(gen, dev):
        def fn():
            return smw.windowed_vals(data, ids, M)
        path = smw.kernel_path(data) if hasattr(smw, "kernel_path") else "n/a"
        ev = cs.time_ms(fn, reps=30, inner=20)
        gr = cs.time_graph_ms(fn, reps=30, inner=20)
        dt = cs.device_times_ms(fn, 20, "fill_empty", "segment_max_window")
        host = cs.host_us_per_call(fn)
        fill, main_ms, gap = (dt["fill_empty"], dt["segment_max_window"],
                              dt["gap"])
        print(f"{tuple(data.shape)} {str(data.dtype)[6:]} path={path}: "
              f"events {ev:.4f} ms, graph {gr:.4f} ms; device: fill "
              f"{fill:.4f} + gap {gap:.4f} + main {main_ms:.4f} ms; host "
              f"{host:.2f} us a call; bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB): {bound_ms / gr:.1%} by graph, "
              f"{bound_ms / main_ms:.1%} main kernel alone", flush=True)
        if (data.shape[0], data.dtype) != (8, torch.float32):
            kept.append((data, ids, bound_ms))
    if args.sweep:
        lib = cuda.load("segment_max_window")
        cfg = lib.sonet_segment_max_window_config
        cfg.argtypes = [ctypes.c_int] * 3
        for stages, stage_bytes, per_sm in SWEEP:
            cfg(stages, stage_bytes, per_sm)
            row = []
            for data, ids, bound_ms in kept:
                want = smw.windowed_vals_plain(data[:1], ids[:1], M)
                got = smw.windowed_vals(data[:1], ids[:1], M)
                if not bool((got == want).all()):
                    raise AssertionError("the kernel differs from its plain "
                                         f"version at {stages, stage_bytes}")
                gr = cs.time_graph_ms(
                    lambda: smw.windowed_vals(data, ids, M), reps=15)
                row.append(f"B={data.shape[0]} {gr:.4f} ms "
                           f"({bound_ms / gr:.1%})")
            print(f"stages {stages}, {stage_bytes} B a stage, {per_sm} "
                  f"block(s) an SM: " + "; ".join(row), flush=True)
        cfg(0, 0, 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
