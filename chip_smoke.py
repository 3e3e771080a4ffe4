#!/usr/bin/env python3
"""Drive the PyTorch port (``sonet_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Phases; any failure ends the run with a non-zero exit and no result line:

1. device: the card's name and power limit, from nvidia-smi;
2. build: every CUDA kernel under ``sonet_torch/csrc/``, one nvcc each,
   all started together;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it and on edge cases (exact equality), with the
   kernel's, the plain version's and, where one exists, one library
   call's time (CUDA events, median over repeats) beside the kernel's
   bound.  Kernel 2 (``segment_argmax``) is on no path of the model and
   is held here only, also against kernel 1's values;
4. serving: the ModelNet40 classifier (``config.modelnet40()``, full
   width, seeded random weights) served through ``ServingEngine`` on the
   card for requests of 1, 8 and 13 clouds, with every kernel's launch
   count read from 0; logits checked for shape and finiteness and held
   against the same weights with scatter pooling; a small float32 model
   held against the same model on the CPU; the B=8 forward timed;
5. training: ``train.init_state`` and ``train.make_classify_steps`` on the
   same configuration; the first PointNet's gradients, from a float32
   train-mode forward and from bf16 and float32 forwards with the running
   statistics, and the first train step's loss, held against the scatter
   pooling path; 10 train steps with every
   kernel's launch count read from 0, finite losses and gradients, every
   trainable tensor moved but the biases a BatchNorm follows; a small
   float32 train step held against the CPU; the loss falling over 10
   steps on one batch with dropout off; the B=8 train step timed;
6. a JSON line of every kernel with its launches on each path, error and
   times;
7. last line: {"ok": true, "device": {...}}.

``--profile DIR`` also writes torch.profiler tables of the B=8 forward
and train step to ``DIR/profile_forward.txt`` and
``DIR/profile_train_step.txt`` and prints the device-busy shares.
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
# float32 gradients, card vs CPU: 1e-3 of the tensor's largest entry plus
# 1e-6 for the noise-level gradients of biases whose true gradient is 0
GRAD_F32_RTOL, GRAD_F32_ATOL = 1e-3, 1e-6
# first PointNet gradients, kernel vs scatter pooling, from the same
# weights, batch and dropout masks, as (dtype, train mode, relative error
# of each tensor against its norm).  A gradient that misses the pooling
# backward is off by about 100%.  With the running BatchNorm statistics
# the two forwards are bit-identical: 2% in bf16 (weight gradients are
# rounded to bf16, up to 0.4% an entry, after sums over 120,000 points
# taken in another order) and 1e-4 in float32.  With batch statistics, as
# in a train step, the two paths sum the statistics in another point
# order, which moves nearly tied max-pooling winners: in float32 the same
# path fed its points in another order moves these gradients by up to
# about 1e-2 (tools/torch_pool_grad_order.py), so kernel vs scatter is
# held at 5e-2; in bf16 one-ulp flips move them by far more, so bf16 in
# train mode is not compared
GRAD_POOL_CASES = (("bfloat16", False, 2e-2), ("float32", False, 1e-4),
                   ("float32", True, 5e-2))
# the first PointNet's last bias has a true gradient of 0 (the KNN
# layer's BatchNorm cancels a constant shift of the pooled features), so
# both paths give it rounding noise: it is left out of those comparisons
NOISE_BIAS = "encoder.first_pointnet.PointLayer_3.Dense_0.bias"
TRAIN_STEPS = 10


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


def _bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, bound_by


def phase_kernels():
    """Every kernel vs its plain version; returns their lines of the
    result."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, k, M = 8, 5000, 3, 64
    ids = _flagship_ids(torch, B, N, M, k, gen, dev)           # (8, 15000)
    return [_check_segment_max_window(torch, gen, ids, M),
            _check_segment_argmax(torch, gen, ids, M)]


def _check_segment_max_window(torch, gen, ids, M):
    """Kernel 1 on the flagship bf16 and f32 inputs and edge cases."""
    from sonet_torch.ops.cuda.segment_max_window import (
        windowed_vals, windowed_vals_plain)
    dev = ids.device
    B, kN = ids.shape
    C = 384

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
    bound_ms, bound_by = _bound(nbytes, data.numel())
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


def _check_segment_argmax(torch, gen, ids, M):
    """Kernel 2 against its plain version, index for index, on the
    flagship f32 input and edge cases; against kernel 1's values; timed.
    No PyTorch call returns per-segment argmax indices, so there is no
    library time."""
    from sonet_torch.ops.cuda.segment_argmax import (
        segment_argmax, segment_argmax_plain)
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals
    dev = ids.device
    B, kN = ids.shape
    C = 384

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand_ids(shape, m, sort):
        i = torch.randint(0, m, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(i, dim=1).values if sort else i

    flagship = rand((B, kN, C))
    # planted exact ties: in every cloud, the first point of each node
    # copied onto the node's second point; the lower index must win
    tie_ids = rand_ids((4, 3000), 32, True)
    tie_data = rand((4, 3000, 128))
    starts = []
    for b in range(4):
        first = torch.searchsorted(tie_ids[b], torch.arange(
            32, device=dev, dtype=torch.int32))
        ok = (first + 1 < 3000)
        ok &= tie_ids[b, (first + 1).clamp_max(2999)] == tie_ids[
            b, first.clamp_max(2999)]
        first = first[ok]
        tie_data[b, first + 1] = tie_data[b, first]
        starts.append(first)
    ids_empty = rand_ids((2, 500), 14, False)
    ids_empty[ids_empty == 3] = 2                 # node 3 empty; 14..19 empty
    cases = [
        ("flagship f32 sorted", flagship, ids, M),
        ("unsorted f32", rand((2, 1000, 96)), rand_ids((2, 1000), 16, False),
         16),
        ("planted ties f32", tie_data, tie_ids, 32),
        ("empty nodes f32", rand((2, 500, 128)), ids_empty, 20),
        ("ragged N=1001, odd C=33, f32", rand((3, 1001, 33)),
         rand_ids((3, 1001), 16, True), 16),
    ]
    max_err = 0.0
    for name, data, seg, m in cases:
        got = segment_argmax(data, seg, m)
        torch.cuda.synchronize()
        want = segment_argmax_plain(data, seg, m)
        same = bool((got == want).all())
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"kernel segment_argmax [{name}] {tuple(data.shape)} M={m}: "
            f"{'equal' if same else 'DIFFERENT'} indices (max abs err {err})")
        if not same:
            raise AssertionError(f"segment_argmax differs from its plain "
                                 f"version on {name}")
        if name == "planted ties f32":
            for b, first in enumerate(starts):
                node = tie_ids[b, first].long()
                if bool((got[b, node] == (first + 1)[:, None]).any()):
                    raise AssertionError("segment_argmax: a tie went to the "
                                         "higher index")
            log(f"  planted ties: {sum(len(f) for f in starts)} tied pairs, "
                f"the lower index won every one")

    # the values behind kernel 2's indices are kernel 1's maxima
    idx = segment_argmax(flagship, ids, M)
    vals = torch.gather(flagship, 1, idx.long())
    ref = windowed_vals(flagship, ids, M)
    full = ref > -3e38
    if not bool((vals[full] == ref[full]).all()):
        raise AssertionError("segment_argmax's values differ from "
                             "segment_max_window's")
    log(f"segment_argmax values equal segment_max_window's on "
        f"{int(full.sum())} non-empty (b, node, channel) entries")

    ms = time_ms(lambda: segment_argmax(flagship, ids, M), reps=30, inner=20)
    plain_ms = time_ms(lambda: segment_argmax_plain(flagship, ids, M), reps=5)
    nbytes = flagship.numel() * 4 + ids.numel() * 4 + B * M * C * 4
    bound_ms, bound_by = _bound(nbytes, flagship.numel())
    log(f"segment_argmax at {tuple(flagship.shape)} f32, M={M}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, no library call, bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s), {bound_ms / ms:.1%} of bound")
    return {"name": "segment_argmax", "route": "cuda",
            "source": "sonet_torch/csrc/segment_argmax.cu",
            "replaces": "sonet_tpu/ops/pallas/segment_argmax.py:113",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "note": "on no path of the model; held in phase 3 only"}


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


def phase_serve(kernel_counters, on_path, profile_dir=None):
    """Serve the ModelNet40 classifier on the card; returns the launches
    of every kernel during the served requests.  Each kernel named in
    ``on_path`` must launch for every request."""
    import numpy as np
    import torch
    from sonet_torch import config
    from sonet_torch.models import build_model
    from sonet_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
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
        if not all(grew[n] > 0 for n in on_path):
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
        profile_run(forward, profile_dir, "forward")
    return launches


def _stopped_biases(model):
    """Names of the biases that a BatchNorm follows: they get no gradient
    by design (``nn.layers.Dense.stop_bias_grad``)."""
    from sonet_torch.nn.layers import Dense
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, Dense) and m.stop_bias_grad}


def _rel_err(a, b) -> float:
    return float((a - b).float().norm() / b.float().norm().clamp_min(1e-30))


def phase_train(kernel_counters, on_path, profile_dir=None):
    """Train the ModelNet40 classifier on the card through
    ``train.init_state`` and ``train.make_classify_steps``; returns the
    launches of every kernel during the TRAIN_STEPS steps.  Each kernel
    named in ``on_path`` must launch once per step."""
    import numpy as np
    import torch
    from sonet_torch import config, train
    from sonet_torch.models import build_model
    from sonet_torch.nn.encoder import resolve_pooling

    dev = torch.device("cuda")
    cfg = config.modelnet40()
    B, spe = cfg.batch_size, 100
    state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=spe)
    train_step, eval_step = train.make_classify_steps(cfg, spe)
    model = state.model
    log(f"training {cfg.task} modelnet40: B={B}, N={cfg.input_pc_num}, "
        f"M={cfg.node_num}, k={cfg.k}, som_k={cfg.som_k}, "
        f"F={cfg.feature_num}, {cfg.compute_dtype}, dropout {cfg.dropout}, "
        f"Adam lr {cfg.lr}, pooling={resolve_pooling(cfg, dev)}")
    clouds = _clouds(np, 3 * B, cfg, seed=3)
    labels = np.random.RandomState(4).randint(0, cfg.classes, 3 * B)
    batches = []
    for i in range(3):
        part = slice(i * B, (i + 1) * B)
        b = {n: torch.from_numpy(a[part]).to(dev) for n, a in clouds.items()}
        b["label"] = torch.from_numpy(labels[part]).to(dev)
        batches.append(b)
    stopped = _stopped_biases(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    _pooling_gradient_checks(torch, cfg, batches[0], model.state_dict())
    # the first train step's loss against the same weights, batch and
    # dropout masks through scatter pooling
    twin = build_model(cfg.replace(pooling="scatter"), device=dev)
    twin.load_state_dict(model.state_dict())
    twin.train()
    b0 = batches[0]
    with torch.no_grad():
        score, _ = twin(b0["pc"], b0["sn"], b0["node"], epoch=0,
                        generator=torch.Generator(device=dev).manual_seed(7))
        twin_loss = float(train.losses.cross_entropy(score, b0["label"]))
    del twin, score

    gen = torch.Generator(device=dev).manual_seed(7)
    for counter in kernel_counters.values():
        counter.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = train_step(state, batches[i % 3], gen)
        losses.append(float(metrics["loss"]))
        no_grad = [n for n, p in model.named_parameters()
                   if (p.grad is None) != (n in stopped)]
        bad = [n for n, p in model.named_parameters() if p.grad is not None
               and not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(losses[-1]) or no_grad or bad:
            raise AssertionError(f"train step {i}: loss {losses[-1]}, "
                                 f"gradient missing or extra {no_grad}, "
                                 f"not finite {bad}")
        if i == 0:
            diff = abs(losses[0] - twin_loss)
            log(f"first train step vs scatter pooling: loss {losses[0]} vs "
                f"{twin_loss} (diff {diff}, tolerance {LOGIT_RTOL} x "
                f"max(1, loss))")
            if diff > LOGIT_RTOL * max(1.0, twin_loss):
                raise AssertionError("train loss: kernel path disagrees with "
                                     "the scatter path")
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in kernel_counters.items()}
    log(f"{TRAIN_STEPS} train steps: losses {losses}; kernel launches "
        f"{launches}")
    for n in on_path:
        if launches[n] != TRAIN_STEPS:
            raise AssertionError(f"{n} launched {launches[n]} times in "
                                 f"{TRAIN_STEPS} train steps, want one a step")
    params = dict(model.named_parameters())
    unmoved = [n for n in params if n not in stopped
               and torch.equal(params[n].detach(), before[n])]
    moved = [n for n in stopped if not torch.equal(params[n].detach(),
                                                   before[n])]
    log(f"after {TRAIN_STEPS} steps: {len(params) - len(stopped)} trainable "
        f"tensors moved but {unmoved}; the {len(stopped)} biases a "
        f"BatchNorm follows stayed but {moved}")
    if unmoved or moved:
        raise AssertionError("parameters moved where they should not, or "
                             "did not where they should")
    ev = eval_step(state, batches[0])
    if ev["score"].shape != (B, cfg.classes) or not bool(
            torch.isfinite(ev["score"]).all()):
        raise AssertionError("eval_step: bad scores")
    log(f"eval_step: loss {float(ev['loss'])}, accuracy "
        f"{float(ev['accuracy'])}")

    _train_tiny_card_vs_cpu(torch, np, config, train)

    # one fixed batch, dropout off: the loss must fall
    fixed = train.init_state(cfg.replace(dropout=0.0), device=dev, seed=1,
                             steps_per_epoch=spe)
    fixed_losses = []
    for _ in range(TRAIN_STEPS + 1):
        fixed, metrics = train_step(fixed, batches[0], None)
        fixed_losses.append(float(metrics["loss"]))
    log(f"one batch, dropout off: losses {fixed_losses}")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError("the train loss did not fall on a fixed batch")
    del fixed

    def step():
        train_step(state, batches[0], gen)

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(step, reps=20)
    log(f"B=8 train step on the card: {step_ms:.4f} ms "
        f"({B / step_ms * 1e3:.1f} clouds/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    if profile_dir:
        profile_run(step, profile_dir, "train_step")
    return launches


def _pooling_gradient_checks(torch, cfg, batch, state_dict):
    """The first PointNet's gradients through the kernel and through
    scatter pooling, from the same weights, batch and dropout masks, for
    each case of GRAD_POOL_CASES."""
    from sonet_torch import train
    from sonet_torch.models import build_model
    prefix = "encoder.first_pointnet."
    for dtype, train_mode, tol in GRAD_POOL_CASES:
        stats = "batch" if train_mode else "running"
        grads = {}
        for pooling in ("sorted_window", "scatter"):
            m = build_model(cfg.replace(pooling=pooling, compute_dtype=dtype),
                            device="cuda")
            m.load_state_dict(state_dict)
            m.train(train_mode)
            gen = torch.Generator(device="cuda").manual_seed(7)
            score, _ = m(batch["pc"], batch["sn"], batch["node"], epoch=0,
                         generator=gen)
            train.losses.cross_entropy(score, batch["label"]).backward()
            grads[pooling] = {n: p.grad for n, p in m.named_parameters()
                              if n.startswith(prefix) and p.grad is not None}
            del m, score
        kernel, scatter = grads["sorted_window"], grads["scatter"]
        errs = {n: _rel_err(kernel[n], g) for n, g in scatter.items()
                if n != NOISE_BIAS}
        worst = max(errs, key=errs.get)
        log(f"first_pointnet gradients, kernel vs scatter pooling ({dtype}, "
            f"{stats} statistics): {len(errs)} tensors, worst relative "
            f"error {errs[worst]:.3e} ({worst[len(prefix):]}; tolerance "
            f"{tol}); norms {float(kernel[worst].norm()):.6g} vs "
            f"{float(scatter[worst].norm()):.6g}")
        if errs[worst] > tol:
            raise AssertionError(f"first_pointnet gradients ({dtype}, {stats} "
                                 f"statistics): the kernel path disagrees "
                                 f"with scatter")


def _train_tiny_card_vs_cpu(torch, np, config, train):
    """One float32 ``tiny_test`` train step on the card against the same
    step on the CPU: loss and every gradient."""
    cfg = config.tiny_test().replace(dropout=0.0)
    step, _ = train.make_classify_steps(cfg, steps_per_epoch=10)
    rs = np.random.RandomState(5)
    small = _clouds(np, 4, cfg, seed=2)
    small["label"] = rs.randint(0, cfg.classes, 4)
    out = {}
    for dev in ("cpu", "cuda"):
        state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=10)
        batch = {n: torch.from_numpy(a).to(dev) for n, a in small.items()}
        state, metrics = step(state, batch, None)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().cpu() for n, p in state.model.named_parameters()}
        out[dev] = float(metrics["loss"]), grads
    (want_loss, want), (got_loss, got) = out["cpu"], out["cuda"]
    errs = {n: float((got[n] - w).abs().max())
            / (GRAD_F32_RTOL * float(w.abs().max()) + GRAD_F32_ATOL)
            for n, w in want.items()}
    worst = max(errs, key=errs.get)
    log(f"tiny_test float32 train step, card vs CPU: loss {got_loss} vs "
        f"{want_loss}; worst gradient at {errs[worst]:.3f} of its tolerance "
        f"({worst})")
    if abs(got_loss - want_loss) > SMALL_F32_TOL * max(1.0, abs(want_loss)):
        raise AssertionError("the train loss on the card disagrees with the "
                             "CPU")
    if errs[worst] > 1.0:
        raise AssertionError("the gradients on the card disagree with the "
                             "CPU")


def profile_run(fn, out_dir, what):
    """torch.profiler over 5 calls of ``fn``: the kernel table to
    ``out_dir/profile_<what>.txt`` and the device-busy share of the window
    to stdout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device rows only (kernels, copies, memsets): the operator rows
    # repeat their kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    path = os.path.join(out_dir, f"profile_{what}.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"profile: 5 x {what}, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%} under the "
        f"profiler); table in {path}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        log(f"  {e.self_device_time_total / 5e3:9.4f} ms/{what} "
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
    from sonet_torch.ops.cuda.segment_argmax import segment_argmax
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernels = phase_kernels()
    counters = {"segment_max_window": windowed_vals,
                "segment_argmax": segment_argmax}
    on_path = ("segment_max_window",)       # kernel 2 is on no path
    by_path = {"serve": phase_serve(counters, on_path, args.profile),
               "train": phase_train(counters, on_path, args.profile)}
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
