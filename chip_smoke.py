#!/usr/bin/env python3
"""Drive the PyTorch port (``sonet_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Phases; any failure ends the run with a non-zero exit and no result line:

1. device: the card's name and power limit, from nvidia-smi;
2. build: every CUDA kernel under ``sonet_torch/csrc/``, one nvcc each,
   all started together;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it and on edge cases (exact equality), with the
   kernel's, the plain version's and one library call's time (CUDA
   events, median over repeats) beside the kernel's bound;
4. the slice: the ModelNet40 classifier (``config.modelnet40()``, full
   width, seeded random weights) served through ``ServingEngine`` on the
   card for requests of 1, 8 and 13 clouds, with every kernel's launch
   count read from 0; logits checked for shape and finiteness and held
   against the same weights with scatter pooling; a small float32 model
   held against the same model on the CPU; the B=8 forward timed.
5. a JSON line of every kernel with its launches, error and times;
6. last line: {"ok": true, "device": {...}}.

``--profile DIR`` also writes a torch.profiler table of the B=8 forward
to ``DIR/profile_forward.txt`` and prints the device-busy share.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# bf16 serving vs the scatter path: the two paths feed the per-point
# matmuls and the cluster sums the same points in another order, so
# bf16 rounding can differ by a few ulp (1 ulp = 0.4-0.8%) per layer
LOGIT_RTOL = 2e-2
# float32 on the card vs the CPU: the same arithmetic, summed in another
# order by cuBLAS and the CPU's GEMMs
SMALL_F32_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0]
    log(line)
    return line


def phase_build():
    from sonet_torch.ops import cuda
    t0 = time.perf_counter()
    built = cuda.build()
    log(f"build: {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in built:
        for ln in cuda.ptxas_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


def _flagship_ids(torch, B, N, M, k, gen, dev):
    """Sorted node ids from a real top-k assignment of random clouds."""
    from sonet_torch.ops import assign_topk
    pc = torch.randn(B, N, 3, generator=gen, device=dev)
    pick = torch.randperm(N, generator=gen, device=dev)[:M]
    ids = assign_topk(pc, pc[:, pick], k).min_idx
    return torch.sort(ids, dim=1).values.contiguous()


def phase_kernels():
    """Kernel 1 vs its plain version; returns its line of the result."""
    import torch
    from sonet_torch.ops.cuda.segment_max_window import (
        windowed_vals, windowed_vals_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, k, M, C = 8, 5000, 3, 64, 384
    ids = _flagship_ids(torch, B, N, M, k, gen, dev)           # (8, 15000)
    kN = N * k

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ids_small = torch.randint(0, 16, (2, 1000), generator=gen, device=dev,
                              dtype=torch.int32)
    ids_ragged = torch.sort(torch.randint(
        0, 16, (3, 1001), generator=gen, device=dev,
        dtype=torch.int32), dim=1).values
    ids_empty = torch.randint(0, 14, (2, 500), generator=gen, device=dev,
                              dtype=torch.int32)
    ids_empty[ids_empty == 3] = 2                 # node 3 empty; 14..19 empty
    cases = [
        ("flagship bf16 sorted", rand((B, kN, C), torch.bfloat16), ids, M),
        ("flagship f32 sorted", rand((B, kN, C), torch.float32), ids, M),
        ("unsorted f32", rand((2, 1000, 96), torch.float32), ids_small, 16),
        ("ragged N=1001, odd C=33, bf16",
         rand((3, 1001, 33), torch.bfloat16), ids_ragged, 16),
        ("empty nodes f32", rand((2, 500, 128), torch.float32), ids_empty, 20),
    ]
    max_err = 0.0
    for name, data, seg, m in cases:
        got = windowed_vals(data, seg, m)
        torch.cuda.synchronize()
        want = windowed_vals_plain(data, seg, m)
        same = bool((got == want).all())
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"kernel segment_max_window [{name}] {tuple(data.shape)} M={m}: "
            f"{'equal' if same else 'DIFFERENT'} (max abs err {err})")
        if not same:
            raise AssertionError(f"segment_max_window differs from its plain "
                                 f"version on {name}")

    data = cases[0][1]
    base = torch.empty((B, M, C), dtype=data.dtype, device=dev)
    idx = ids.long()[..., None].expand(B, kN, C).contiguous()
    ms = time_ms(lambda: windowed_vals(data, ids, M), reps=30, inner=20)
    plain_ms = time_ms(lambda: windowed_vals_plain(data, ids, M), reps=5)
    library_ms = time_ms(lambda: base.scatter_reduce(
        1, idx, data, reduce="amax", include_self=False), reps=30, inner=20)
    nbytes = (data.numel() * data.element_size() + ids.numel() * 4
              + B * M * C * 4)
    ops = data.numel()
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                else "operations")
    log(f"segment_max_window at {tuple(data.shape)} bf16, M={M}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_reduce "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB "
        f"at {HBM_BYTES_PER_S / 1e12} TB/s), {bound_ms / ms:.1%} of bound")
    return {"name": "segment_max_window", "route": "cuda",
            "source": "sonet_torch/csrc/segment_max_window.cu",
            "replaces": "sonet_tpu/ops/pallas/segment_max_window.py:127",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _clouds(np, n_items, cfg, seed):
    """Points on random ellipsoids with their normals, and SOM nodes
    picked among the points, from ``seed``."""
    rs = np.random.RandomState(seed)
    N, M = cfg.input_pc_num, cfg.node_num
    u = rs.randn(n_items, N, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    axes = rs.uniform(0.3, 1.0, (n_items, 1, 3))
    pc = u * axes
    sn = u / axes
    sn /= np.linalg.norm(sn, axis=-1, keepdims=True)
    pick = np.stack([rs.choice(N, M, replace=False) for _ in range(n_items)])
    node = np.take_along_axis(pc, pick[..., None], axis=1)
    return {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
            "node": node.astype(np.float32)}


def phase_slice(kernel_counters, profile_dir=None):
    """Serve the ModelNet40 classifier on the card; returns the launches
    of every kernel during the served requests."""
    import numpy as np
    import torch
    from sonet_torch import config
    from sonet_torch.models import build_model
    from sonet_torch.serving import ServingEngine

    cfg = config.modelnet40()
    model = build_model(cfg, device="cuda", seed=0)
    engine = ServingEngine.from_model(model, cfg, device="cuda")
    log(f"serving {cfg.task} modelnet40: B={engine.batch_size}, "
        f"N={cfg.input_pc_num}, M={cfg.node_num}, k={cfg.k}, "
        f"som_k={cfg.som_k}, F={cfg.feature_num}, classes={cfg.classes}, "
        f"{cfg.compute_dtype}, pooling={engine.manifest['pooling']}")
    engine.warmup()
    inputs = _clouds(np, 13, cfg, seed=1)

    for counter in kernel_counters.values():
        counter.launches = 0
    outputs = {}
    for b in (1, 8, 13):
        before = {n: c.launches for n, c in kernel_counters.items()}
        out = engine.predict({n: a[:b] for n, a in inputs.items()})
        torch.cuda.synchronize()
        grew = {n: c.launches - before[n] for n, c in kernel_counters.items()}
        log(f"request B'={b}: logits {out.shape}, finite "
            f"{bool(np.isfinite(out).all())}, kernel launches {grew}")
        if out.shape != (b, cfg.classes) or not np.isfinite(out).all():
            raise AssertionError(f"bad logits for B'={b}: {out.shape}")
        if not all(v > 0 for v in grew.values()):
            raise AssertionError(f"a kernel was not launched for B'={b}: "
                                 f"{grew}")
        outputs[b] = out
    launches = {n: c.launches for n, c in kernel_counters.items()}
    log(f"served: {engine.stats()}; launches {launches}")

    # items are independent in eval mode: the 13-item request chunks to
    # 8 + 5 (padded) and must repeat the 1- and 8-item answers
    for b in (1, 8):
        diff = float(np.abs(outputs[13][:b] - outputs[b]).max())
        log(f"B'=13 vs B'={b} on the shared items: max abs diff {diff}")
        if diff > LOGIT_RTOL * max(1.0, float(np.abs(outputs[b]).max())):
            raise AssertionError("served logits depend on the request size")

    # the same weights through the scatter pooling path
    scatter = build_model(cfg.replace(pooling="scatter"), device="cuda")
    scatter.load_state_dict(model.state_dict())
    dev_in = {n: torch.from_numpy(a[:8]).cuda() for n, a in inputs.items()}
    with torch.inference_mode():
        ref = scatter(dev_in["pc"], dev_in["sn"], dev_in["node"])[0]
    ref = ref.float().cpu().numpy()
    diff = float(np.abs(ref - outputs[8]).max())
    scale = max(1.0, float(np.abs(ref).max()))
    log(f"sorted_window vs scatter logits: max abs diff {diff} "
        f"(max |logit| {scale}, tolerance {LOGIT_RTOL} x that)")
    if diff > LOGIT_RTOL * scale:
        raise AssertionError("kernel path disagrees with the scatter path")

    # a small float32 model on the card against the same model on the CPU
    small = config.tiny_test()
    small_in = [torch.from_numpy(a) for a in _clouds(np, 4, small, 2).values()]
    on_cpu = build_model(small, device="cpu", seed=0)
    on_card = build_model(small, device="cuda", seed=0)
    with torch.inference_mode():
        want = on_cpu(*small_in)[0]
        got = on_card(*(a.cuda() for a in small_in))[0].cpu()
    diff = float((got - want).abs().max())
    log(f"tiny_test float32, card vs CPU: max abs diff {diff} "
        f"(tolerance {SMALL_F32_TOL} x max(1, max |logit|))")
    if diff > SMALL_F32_TOL * max(1.0, float(want.abs().max())):
        raise AssertionError("the model on the card disagrees with the CPU")

    def forward():
        with torch.inference_mode():
            model(dev_in["pc"], dev_in["sn"], dev_in["node"])

    fwd_ms = time_ms(forward, reps=20)
    req8 = {n: a[:8] for n, a in inputs.items()}
    t = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.predict(req8)
        t.append((time.perf_counter() - t0) * 1e3)
    req_ms = statistics.median(t)
    log(f"B=8 forward on the card: {fwd_ms:.4f} ms "
        f"({8 / fwd_ms * 1e3:.1f} clouds/s); B'=8 request through "
        f"ServingEngine (host arrays in and out): {req_ms:.4f} ms "
        f"({8 / req_ms * 1e3:.1f} clouds/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")

    if profile_dir:
        profile_forward(forward, profile_dir)
    return launches


def profile_forward(forward, out_dir):
    """torch.profiler over 5 B=8 forwards: the kernel table to a file and
    the device-busy share of the window to stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only (kernels, copies, memsets): the operator rows
    # repeat their kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    path = os.path.join(out_dir, "profile_forward.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    log(f"profile: 5 forwards, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%} under the "
        f"profiler); table in {path}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 5e3:9.4f} ms/forward "
            f"{e.count // 5:4d}x  {e.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import sonet_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sonet_torch package is missing beside this "
              f"script: {e}", file=sys.stderr)
        return 1
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    phase_device()
    phase_build()
    kernels = [phase_kernels()]
    counters = {"segment_max_window": windowed_vals}
    launches = phase_slice(counters, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
