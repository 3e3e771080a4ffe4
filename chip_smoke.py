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
   call's time beside the kernel's bound.  A kernel's time is read twice:
   by CUDA events around launches made from Python (median over
   repeats), which a slow host can floor, and by replaying a CUDA graph
   of the captured launches, which it cannot.  Kernel 1
   (``segment_max_window``) is also read from a torch.profiler trace, its
   fill and its main kernel apart, and timed on the float32 and the B=64
   inputs and at the part segmenter's shape (8, 3072, 384); each of its
   cases must take the kernel (bulk or direct) that its shape and
   alignment name.  Kernel 2 (``segment_argmax``) is on no
   path of the model and is held here only, also against kernel 1's
   values;
4. serving: the ModelNet40 classifier (``config.modelnet40()``, full
   width, seeded random weights) served through ``ServingEngine`` on the
   card for requests of 1, 8 and 13 clouds, with every kernel's launch
   count read from 0; logits checked for shape and finiteness and held
   against the same weights with scatter pooling; a small float32 model
   held against the same model on the CPU; the B=8 forward timed;
5. training: ``train.init_state`` and ``train.make_steps`` on the same
   configuration; the first PointNet's gradients, from a float32
   train-mode forward and from bf16 and float32 forwards with the running
   statistics, and the first train step's loss, held against the scatter
   pooling path; 10 train steps with every
   kernel's launch count read from 0, finite losses and gradients, every
   trainable tensor moved but the biases a BatchNorm follows; a small
   float32 train step held against the CPU; the loss falling over 10
   steps on one batch with dropout off; the B=8 train step timed; the
   state written as a checkpoint;
6. segment serving: phase 4 for the ShapeNetPart part segmenter
   (``config.shapenetpart()``, full width): requests carry the shape
   category, scores are (B', 1024, 50); the comparison with scatter
   pooling holds the head's un-permute, which a wrong use of the
   permutation would put far outside its tolerance;
7. segment training: phase 5 for the part segmenter, with the gradients
   of the first PointNet and of ``segmenter.layer1`` held against the
   scatter pooling path with the running statistics, as are the small
   float32 model's against the CPU;
8. run round trip: the trained segmenter written as a run (``config.json``
   and a checkpoint); restored into a fresh state bit for bit (weights,
   running statistics, Adam's state, step); ``ServingEngine.from_run`` on
   it answering exactly as ``from_model`` on the trained model;
   ``restore_encoder`` from phase 5's classifier checkpoint setting
   exactly the ``encoder.*`` entries of a segmenter state;
9. SOM: ``som.fit`` of 64 clouds of 1024 points on the card, 8x8 nodes,
   both schedules: finite nodes inside the clouds' bounds; one
   ``batch_update`` held against the CPU's; the fit's quantization error
   (the mean distance of a point to its nearest node) held against a CPU
   fit's and against the initial nodes'; the same bits with
   ``allow_tf32`` on and off and from one call to the next; the fit timed;
10. autoencoder serving: phase 4 for the Chamfer autoencoder
   (``config.autoencoder()``, full width), on SOM nodes fitted on the
   card from the same clouds; reconstructions are (B', 1280, 3);
11. autoencoder training: phase 5 for the autoencoder (the multi-scale
   Chamfer loss), on fitted nodes; the gradients of the first PointNet
   and of the decoder held against the scatter pooling path with the
   running statistics; the 64x64 decoder stage that nothing reads gets no
   gradient and does not move; then phase 8's round trip on the trained
   autoencoder's run;
12. trainer: ``sonet-torch classify`` (``cli.main``, as a user runs it)
   at ``config.modelnet40()``'s width on the synthetic dataset (320 train
   and 160 test clouds, nodes fitted on the card), point dropout from 0.8
   drawing from a CUDA generator, ``checkpoint_every=20``: one epoch with
   every kernel's launch count read from 0, ``config.json`` and a
   checkpoint written, the epoch's time a step with the loader in; then a
   ``train.Trainer`` on that run: it resumes at the run's step, its eval
   by hand over the 160 valid items equals the run's, the card's busy
   share over an epoch under torch.profiler, ``request_stop`` and a
   ``fit`` that checkpoints, a new ``Trainer`` that resumes at that step
   bit for bit, ``ServingEngine.from_run`` against ``Trainer.eval_step``;
13. retrieve: ``config.shrec16()`` at full width (som_k=0, 55 classes): a
   SHREC tree of 110 / 55 / 55 shapes of 6000 points written with nodes
   fitted on the card; ``sonet-torch classify`` for one epoch, evaluated
   on ``val`` (its loss equal to one by hand), and ``sonet-torch
   retrieve`` from its checkpoint, kernel launches read from 0 over both;
   its 55 rank files, named by the split's ids, byte-equal to the same
   checkpoint's test scores (``retrieval.extract_scores``) ranked by
   ``rank_all`` on the card, and that ranking held against the CPU's; a
   gallery exactly when matplotlib is installed; mAP and P@k; the
   extraction and the ranking timed;
14. a JSON line of every kernel with its launches on each of the eight
   paths, error and times;
15. last line: {"ok": true, "device": {...}}.

``--profile DIR`` also writes torch.profiler tables of each B=8 forward
and train step to ``DIR/profile_<forward|train_step>_<task>.txt``, of the
autoencoder's decoder alone (``profile_forward_decoder.txt``) and of each
SOM fit (``profile_som_fit_<schedule>.txt``), and prints the device-busy
shares.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# what each task's gradient comparison covers: the tensors under these
# prefixes, in these cases.  The segmenter's and the autoencoder's are held
# with the running statistics only.  In the classifier the first PointNet's last bias has a
# true gradient of 0 (the KNN layer's BatchNorm cancels a constant shift
# of the pooled features, its only reader), so both paths give it
# rounding noise and it is left out; in the segmenter ``layer1`` reads
# that output too, and the bias has a gradient whenever it is compared
GRAD_CHECKS = {
    "classify": (("encoder.first_pointnet.",), GRAD_POOL_CASES,
                 ("encoder.first_pointnet.PointLayer_3.Dense_0.bias",)),
    "segment": (("encoder.first_pointnet.", "segmenter.layer1."),
                GRAD_POOL_CASES[:2], ()),
    "autoencode": (("encoder.first_pointnet.", "decoder."),
                   GRAD_POOL_CASES[:2], ()),
}
# the decoder stage that is read only with 4096 conv points
UNREAD_STAGE = ("decoder.conv_decoder.UpConv_5.",
                "decoder.conv_decoder.ConvToPC_2.")
# SOM on the card vs the CPU: one update within 1e-5 (float32 sums over a
# node's points in another order); a whole fit by its quantization error,
# within 1%
SOM_UPDATE_TOL = 1e-5
SOM_QE_RTOL = 1e-2
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


def time_graph_ms(fn, reps: int, inner: int = 20) -> float:
    """Median over ``reps`` replays of a CUDA graph that holds ``inner``
    calls of ``fn``, per call.  The host starts one replay and the card
    runs the captured launches back to back, so a slow host cannot floor
    the reading as it can in ``time_ms``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_times_ms(fn, calls: int, first: str, second: str) -> dict:
    """Device durations from torch.profiler over ``calls`` calls of ``fn``,
    which launches a kernel whose name contains ``first`` and then one
    whose name contains ``second``: the median duration of each, and the
    median idle gap between the end of the first and the start of the
    second, in ms.  Raises if the trace holds fewer than half of the
    ``calls`` pairs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and (first in e.name or second in e.name))
    # pair each second kernel with the first one that ran just before it:
    # the profiler now and then drops a kernel from its trace
    pairs, last = [], None
    for s, t, n in spans:
        if first in n:
            last = (s, t)
        elif last is not None:
            pairs.append((last, (s, t)))
            last = None
    if len(pairs) < calls // 2:
        raise AssertionError(f"the profiler's trace holds {len(pairs)} pairs "
                             f"of a {first} and a {second} kernel, want "
                             f"{calls}")
    med = statistics.median
    return {first: med(t - s for (s, t), _ in pairs) / 1e3,
            second: med(t - s for _, (s, t) in pairs) / 1e3,
            "gap": med(y[0] - x[1] for x, y in pairs) / 1e3}


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


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds: the host clock
    around ``calls`` calls made without waiting for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel1_cases(torch, gen, dev):
    """Edge cases for kernel 1 as (name, data, ids, M, path): ``path`` is
    the kernel the case must take, "bulk" or "direct".  At C = 384 a tile
    of the bulk kernel is 32 rows in bf16 and 16 in f32."""
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rand_ids(shape, lo, hi, sort=False):
        i = torch.randint(lo, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(i, dim=1).values.contiguous() if sort else i

    def const_ids(per_cloud, n):
        i = torch.tensor(per_cloud, dtype=torch.int32, device=dev)
        return i[:, None].expand(len(per_cloud), n).contiguous()

    cases = [
        # a run longer than any tile, the same id on both sides of a cloud
        # boundary, and all nodes but one empty
        ("one node a cloud, bf16", rand((3, 1000, 384), bf16),
         const_ids([5, 5, 63], 1000), 64, "bulk"),
        ("N=7 below one tile, bf16", rand((3, 7, 384), bf16),
         rand_ids((3, 7), 0, 8, sort=True), 8, "bulk"),
        ("N=7 below one tile, f32", rand((3, 7, 384), f32),
         rand_ids((3, 7), 0, 8, sort=True), 8, "bulk"),
        # every run is one tile long: run, tile and cloud boundaries meet
        ("N=640, runs of one tile, bf16", rand((2, 640, 384), bf16),
         (torch.arange(640, device=dev, dtype=torch.int32) // 32)
         .expand(2, 640).contiguous(), 20, "bulk"),
        ("N=640, runs of one tile, f32", rand((2, 640, 384), f32),
         (torch.arange(640, device=dev, dtype=torch.int32) // 16)
         .expand(2, 640).contiguous(), 40, "bulk"),
        ("N=640 sorted, bf16", rand((2, 640, 384), bf16),
         rand_ids((2, 640), 0, 64, sort=True), 64, "bulk"),
        ("unsorted, bf16", rand((2, 1000, 384), bf16),
         rand_ids((2, 1000), 0, 64), 64, "bulk"),
        ("unsorted, f32", rand((2, 1000, 384), f32),
         rand_ids((2, 1000), 0, 64), 64, "bulk"),
        ("ids outside [0, M) sorted, bf16", rand((2, 1000, 384), bf16),
         rand_ids((2, 1000), -3, 20, sort=True), 16, "bulk"),
        ("ids outside [0, M) unsorted, f32", rand((2, 1000, 384), f32),
         rand_ids((2, 1000), -3, 20), 16, "bulk"),
        # 3003 rows: the last tile is partial and its ids no 16-byte multiple
        ("ragged N=1001, bf16", rand((3, 1001, 384), bf16),
         rand_ids((3, 1001), 0, 16, sort=True), 16, "bulk"),
        ("narrow rows C=128, bf16", rand((4, 999, 128), bf16),
         rand_ids((4, 999), 0, 16, sort=True), 16, "bulk"),
        ("wide rows C=512, f32", rand((2, 333, 512), f32),
         rand_ids((2, 333), 0, 16, sort=True), 16, "bulk"),
        ("rows over 2048 bytes C=2048, bf16", rand((2, 300, 2048), bf16),
         rand_ids((2, 300), 0, 16, sort=True), 16, "direct"),
        ("rows under 256 bytes C=64, bf16", rand((2, 1000, 64), bf16),
         rand_ids((2, 1000), 0, 16, sort=True), 16, "direct"),
    ]
    # zeros of both signs and -inf: a node of -inf alone reads -3e38
    data = rand((2, 640, 384), bf16)
    seg = rand_ids((2, 640), 0, 8, sort=True)
    data[seg == 1] = float("-inf")
    data[seg == 2] = -0.0
    data[seg == 3] = torch.where(rand((2, 640, 384), f32) > 0, 0.0, -0.0).to(
        bf16)[seg == 3]
    data[:, ::5, ::3] = float("-inf")
    cases.append(("zeros of both signs and -inf, bf16", data, seg, 8, "bulk"))
    cases.append(("zeros of both signs and -inf, f32", data.float(), seg, 8,
                  "bulk"))
    # views that start off a 16-byte boundary: data (direct kernel), then
    # ids (the bulk kernel's ids go by plain loads)
    flat = rand((2 * 500 * 384 + 1,), bf16)
    cases.append(("unaligned data view, bf16", flat[1:].view(2, 500, 384),
                  rand_ids((2, 500), 0, 16, sort=True), 16, "direct"))
    flat_ids = rand_ids((1, 2 * 500 + 1), 0, 16, sort=True)[0]
    cases.append(("unaligned ids view, bf16", rand((2, 500, 384), bf16),
                  flat_ids[1:].view(2, 500), 16, "bulk"))
    return cases


def _plain_by_clouds(plain, data, seg, m, clouds=8):
    """The plain version over ``clouds`` clouds at a time: its masked max
    holds a (clouds, N, 8, C) float32 temporary."""
    import torch
    return torch.cat([plain(data[b:b + clouds], seg[b:b + clouds], m)
                      for b in range(0, data.shape[0], clouds)])


def _time_kernel1(torch, data, ids, M):
    """Kernel 1 at one shape: event and graph times of the wrapper, the
    device durations of its two kernels, and the bound."""
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals

    def fn():
        return windowed_vals(data, ids, M)

    B, _, C = data.shape
    nbytes = (data.numel() * data.element_size() + ids.numel() * 4
              + B * M * C * 4)
    bound_ms, bound_by = _bound(nbytes, data.numel())
    t = {"event_ms": time_ms(fn, reps=30, inner=20),
         "graph_ms": time_graph_ms(fn, reps=30, inner=20),
         "bound_ms": bound_ms, "bound_by": bound_by, "nbytes": nbytes}
    dev = device_times_ms(fn, 20, "fill_empty", "segment_max_window_bulk")
    t.update(fill_ms=dev["fill_empty"], gap_ms=dev["gap"],
             main_ms=dev["segment_max_window_bulk"])
    log(f"segment_max_window at {tuple(data.shape)} "
        f"{str(data.dtype).split('.')[-1]}, M={M}: {t['event_ms']:.4f} ms by "
        f"events around launches from Python, {t['graph_ms']:.4f} ms by graph "
        f"replay; device durations: fill {t['fill_ms']:.4f} ms, gap "
        f"{t['gap_ms']:.4f} ms, main kernel {t['main_ms']:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / t['graph_ms']:.1%} of "
        f"bound by graph replay, {bound_ms / t['main_ms']:.1%} for the main "
        f"kernel alone")
    return t


def _check_segment_max_window(torch, gen, ids, M):
    """Kernel 1 on the flagship inputs (bf16 and f32 at B=8, bf16 at B=64),
    the part segmenter's input (8, 3072, 384) and edge cases, each equal
    to the plain version and on the kernel its shape and alignment name;
    then timed."""
    import ctypes
    from sonet_torch.ops import cuda
    from sonet_torch.ops.cuda.segment_max_window import (
        kernel_path, windowed_vals, windowed_vals_plain)
    dev = ids.device
    B, kN = ids.shape
    C = 384
    c_path = cuda.load("segment_max_window").sonet_segment_max_window_bulk_path
    c_path.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]

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
    ids64 = _flagship_ids(torch, 64, kN // 3, M, 3, gen, dev)
    ids_seg = _flagship_ids(torch, B, 1024, M, 3, gen, dev)      # (8, 3072)
    cases = [
        ("flagship bf16 sorted", rand((B, kN, C), torch.bfloat16), ids, M,
         "bulk"),
        ("flagship f32 sorted", rand((B, kN, C), torch.float32), ids, M,
         "bulk"),
        ("flagship B=64 bf16 sorted", rand((64, kN, C), torch.bfloat16),
         ids64, M, "bulk"),
        ("part segmenter bf16 sorted", rand((B, 3072, C), torch.bfloat16),
         ids_seg, M, "bulk"),
        ("unsorted f32", rand((2, 1000, 96), torch.float32), ids_small, 16,
         "bulk"),
        ("ragged N=1001, odd C=33, bf16",
         rand((3, 1001, 33), torch.bfloat16), ids_ragged, 16, "direct"),
        ("empty nodes f32", rand((2, 500, 128), torch.float32), ids_empty, 20,
         "bulk"),
    ] + kernel1_cases(torch, gen, dev)
    max_err = 0.0
    for name, data, seg, m, want_path in cases:
        path = kernel_path(data)
        in_c = "bulk" if c_path(data.data_ptr(), int(
            data.dtype == torch.bfloat16), data.shape[2]) else "direct"
        if not path == in_c == want_path:
            raise AssertionError(f"segment_max_window [{name}]: kernel_path "
                                 f"says {path}, the library {in_c}, want "
                                 f"{want_path}")
        got = windowed_vals(data, seg, m)
        torch.cuda.synchronize()
        want = _plain_by_clouds(windowed_vals_plain, data, seg, m)
        same = bool((got == want).all())
        # -inf never reaches the output, so the difference is finite
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"kernel segment_max_window [{name}] {tuple(data.shape)} M={m}, "
            f"{path} kernel: {'equal' if same else 'DIFFERENT'} (max abs err "
            f"{err})")
        if not same:
            raise AssertionError(f"segment_max_window differs from its plain "
                                 f"version on {name}")

    data, data_f32, data64 = cases[0][1], cases[1][1], cases[2][1]
    t = _time_kernel1(torch, data, ids, M)
    t_f32 = _time_kernel1(torch, data_f32, ids, M)
    t_b64 = _time_kernel1(torch, data64, ids64, M)
    t_seg = _time_kernel1(torch, cases[3][1], ids_seg, M)
    host_us = host_us_per_call(lambda: windowed_vals(data, ids, M))
    base = torch.empty((B, M, C), dtype=data.dtype, device=dev)
    idx = ids.long()[..., None].expand(B, kN, C).contiguous()
    plain_ms = time_ms(lambda: windowed_vals_plain(data, ids, M), reps=5)
    library_ms = time_ms(lambda: base.scatter_reduce(
        1, idx, data, reduce="amax", include_self=False), reps=30, inner=20)
    log(f"segment_max_window at {tuple(data.shape)} bf16, M={M}: the wrapper "
        f"takes the host {host_us:.2f} us a call; plain {plain_ms:.4f} ms, "
        f"scatter_reduce {library_ms:.4f} ms")
    return {"name": "segment_max_window", "route": "cuda",
            "source": "sonet_torch/csrc/segment_max_window.cu",
            "replaces": "sonet_tpu/ops/pallas/segment_max_window.py:127",
            "launches": None, "max_abs_err": max_err, "ms": t["event_ms"],
            "plain_ms": plain_ms, "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library_ms,
            "graph_ms": t["graph_ms"], "fill_device_ms": t["fill_ms"],
            "gap_device_ms": t["gap_ms"], "main_device_ms": t["main_ms"],
            "host_us_per_call": host_us,
            "f32_ms": t_f32["event_ms"], "f32_graph_ms": t_f32["graph_ms"],
            "f32_main_device_ms": t_f32["main_ms"],
            "f32_bound_ms": t_f32["bound_ms"],
            "b64_ms": t_b64["event_ms"], "b64_graph_ms": t_b64["graph_ms"],
            "b64_main_device_ms": t_b64["main_ms"],
            "b64_bound_ms": t_b64["bound_ms"],
            "seg_ms": t_seg["event_ms"], "seg_graph_ms": t_seg["graph_ms"],
            "seg_main_device_ms": t_seg["main_ms"],
            "seg_bound_ms": t_seg["bound_ms"]}


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
    graph_ms = time_graph_ms(lambda: segment_argmax(flagship, ids, M),
                             reps=30, inner=20)
    plain_ms = time_ms(lambda: segment_argmax_plain(flagship, ids, M), reps=5)
    nbytes = flagship.numel() * 4 + ids.numel() * 4 + B * M * C * 4
    bound_ms, bound_by = _bound(nbytes, flagship.numel())
    log(f"segment_argmax at {tuple(flagship.shape)} f32, M={M}: kernel "
        f"{ms:.4f} ms by events, {graph_ms:.4f} ms by graph replay, plain "
        f"{plain_ms:.4f} ms, no library call, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
        f"{bound_ms / graph_ms:.1%} of bound by graph replay")
    return {"name": "segment_argmax", "route": "cuda",
            "source": "sonet_torch/csrc/segment_argmax.cu",
            "replaces": "sonet_tpu/ops/pallas/segment_argmax.py:113",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "graph_ms": graph_ms,
            "note": "on no path of the model; held in phase 3 only"}


def _fit_nodes(pc, cfg):
    """SOM nodes of the clouds ``pc`` (n, N, 3), fitted on the card with
    the schedule the published datasets were built with."""
    from sonet_torch import som
    som_cfg = som.SOMConfig(rows=cfg.rows, cols=cfg.cols, dim=pc.shape[-1],
                            schedule="prep")
    return som.fit(pc, som_cfg, device="cuda").cpu().numpy()


def _clouds(np, n_items, cfg, seed):
    """Points on random ellipsoids with their normals, and SOM nodes, from
    ``seed``: nodes picked among the points, or for an autoencode
    configuration fitted to each cloud on the card; for a segment
    configuration also each cloud's shape category (``label``) and
    per-point part labels (``seg``): the category's parts as bands along
    the first axis."""
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
    out = {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
           "node": node.astype(np.float32)}
    if cfg.task == "autoencode":
        out["node"] = _fit_nodes(out["pc"], cfg)
    if cfg.task == "segment":
        from sonet_torch.ops.iou import PART_TABLE, PART_VALID
        label = rs.randint(0, len(PART_TABLE), n_items)
        n_parts = PART_VALID[label].sum(-1)[:, None]              # (n, 1)
        band = np.minimum(((u[..., 0] + 1) / 2 * n_parts).astype(np.int64),
                          n_parts - 1)
        out["label"] = label.astype(np.int32)
        out["seg"] = PART_TABLE[label[:, None], band]
    return out


def _input_names(cfg):
    from sonet_torch.serving import input_signature
    return [name for name, _, _ in input_signature(cfg)]


def _score_shape(cfg, n_items):
    """The shape of what the task serves for ``n_items`` clouds."""
    if cfg.task == "segment":
        return (n_items, cfg.input_pc_num, cfg.classes)
    if cfg.task == "autoencode":
        return (n_items, cfg.output_fc_pc_num + cfg.output_conv_pc_num, 3)
    return (n_items, cfg.classes)


def _served(cfg, model_out):
    """What the task serves, of a model's ``(output, encoder output)``:
    the scores, or the autoencoder's reconstructed cloud."""
    out = model_out[0]
    return out.pc if cfg.task == "autoencode" else out


def _describe(cfg):
    return (f"{cfg.task} ({cfg.dataset}): B={cfg.batch_size}, "
            f"N={cfg.input_pc_num}, M={cfg.node_num}, k={cfg.k}, "
            f"som_k={cfg.som_k} ({cfg.som_k_type}), F={cfg.feature_num}, "
            + (f"output points {cfg.output_fc_pc_num} + "
               f"{cfg.output_conv_pc_num}" if cfg.task == "autoencode"
               else f"classes={cfg.classes}")
            + f", {cfg.compute_dtype}, dropout {cfg.dropout}")


def phase_serve(cfg, small, kernel_counters, on_path, profile_dir=None):
    """Serve ``cfg``'s model (the ModelNet40 classifier, the ShapeNetPart
    part segmenter or the Chamfer autoencoder) on the card; returns the
    launches of every kernel
    during the served requests.  Each kernel named in ``on_path`` must
    launch for every request.  ``small`` is the float32 configuration
    held against the CPU."""
    import numpy as np
    import torch
    from sonet_torch.models import build_model
    from sonet_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    engine = ServingEngine.from_model(model, cfg, device="cuda")
    names = engine.input_names
    log(f"serving {_describe(cfg)}, inputs {names}, "
        f"pooling={engine.manifest['pooling']}")
    engine.warmup()
    clouds = _clouds(np, 13, cfg, seed=1)
    inputs = {n: clouds[n] for n in names}

    _reset(kernel_counters)
    outputs = {}
    for b in (1, 8, 13):
        before = {n: c.launches for n, c in kernel_counters.items()}
        out = engine.predict({n: a[:b] for n, a in inputs.items()})
        torch.cuda.synchronize()
        grew = {n: c.launches - before[n] for n, c in kernel_counters.items()}
        log(f"request B'={b}: scores {out.shape}, finite "
            f"{bool(np.isfinite(out).all())}, kernel launches {grew}")
        if out.shape != _score_shape(cfg, b) or not np.isfinite(out).all():
            raise AssertionError(f"bad scores for B'={b}: {out.shape}")
        if not all(grew[n] > 0 for n in on_path):
            raise AssertionError(f"a kernel was not launched for B'={b}: "
                                 f"{grew}")
        outputs[b] = out
    launches = _launch_counts(kernel_counters)
    log(f"served: {engine.stats()}; launches {launches}")

    # items are independent in eval mode: the 13-item request chunks to
    # 8 + 5 (padded) and must repeat the 1- and 8-item answers
    for b in (1, 8):
        diff = float(np.abs(outputs[13][:b] - outputs[b]).max())
        log(f"B'=13 vs B'={b} on the shared items: max abs diff {diff}")
        if diff > LOGIT_RTOL * max(1.0, float(np.abs(outputs[b]).max())):
            raise AssertionError("served scores depend on the request size")

    # the same weights through the scatter pooling path, which sorts and
    # un-permutes nothing
    scatter = build_model(cfg.replace(pooling="scatter"), device="cuda")
    scatter.load_state_dict(model.state_dict())
    dev_in = [torch.from_numpy(inputs[n][:8]).cuda() for n in names]
    with torch.inference_mode():
        ref = _served(cfg, scatter(*dev_in))
    ref = ref.float().cpu().numpy()
    diff = float(np.abs(ref - outputs[8]).max())
    scale = max(1.0, float(np.abs(ref).max()))
    log(f"sorted_window vs scatter scores: max abs diff {diff} "
        f"(max |score| {scale}, tolerance {LOGIT_RTOL} x that)")
    if diff > LOGIT_RTOL * scale:
        raise AssertionError("kernel path disagrees with the scatter path")

    # a small float32 model on the card against the same model on the CPU
    small_clouds = _clouds(np, 4, small, 2)
    small_in = [torch.from_numpy(small_clouds[n]) for n in names]
    on_cpu = build_model(small, device="cpu", seed=0)
    on_card = build_model(small, device="cuda", seed=0)
    with torch.inference_mode():
        want = _served(small, on_cpu(*small_in))
        got = _served(small, on_card(*(a.cuda() for a in small_in))).cpu()
    diff = float((got - want).abs().max())
    log(f"small float32 {small.task} model, card vs CPU: max abs diff {diff} "
        f"(tolerance {SMALL_F32_TOL} x max(1, max |score|))")
    if got.shape != _score_shape(small, 4) or diff > SMALL_F32_TOL * max(
            1.0, float(want.abs().max())):
        raise AssertionError("the model on the card disagrees with the CPU")

    def forward():
        with torch.inference_mode():
            model(*dev_in)

    fwd_ms = time_ms(forward, reps=20)
    req8 = {n: a[:8] for n, a in inputs.items()}
    t = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.predict(req8)
        t.append((time.perf_counter() - t0) * 1e3)
    req_ms = statistics.median(t)
    log(f"{cfg.task} B=8 forward on the card: {fwd_ms:.4f} ms "
        f"({8 / fwd_ms * 1e3:.1f} clouds/s); B'=8 request through "
        f"ServingEngine (host arrays in and out): {req_ms:.4f} ms "
        f"({8 / req_ms * 1e3:.1f} clouds/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")

    if profile_dir:
        profile_run(forward, profile_dir, f"forward_{cfg.task}")
        if cfg.task == "autoencode":
            with torch.inference_mode():
                feature = model.encoder(*dev_in).feature

            def decode():
                with torch.inference_mode():
                    model.decoder(feature)

            profile_run(decode, profile_dir, "forward_decoder")
    return launches


def _no_gradient(model, cfg):
    """Names of the parameters that get no gradient by design: the biases
    that a BatchNorm follows (``nn.layers.Dense.stop_bias_grad``) and,
    where the autoencoder emits no 4096 conv points, the 64x64 decoder
    stage that nothing reads."""
    from sonet_torch.nn.layers import Dense
    names = {f"{n}.bias" for n, m in model.named_modules()
             if isinstance(m, Dense) and m.stop_bias_grad}
    if cfg.task == "autoencode" and cfg.output_conv_pc_num != 4096:
        unread = {n for n, _ in model.named_parameters()
                  if n.startswith(UNREAD_STAGE)}
        if len(unread) != 10:     # conv kernel, bias, 2 x (norm, dense) pairs
            raise AssertionError(f"the unread stage has {len(unread)} "
                                 f"parameters, want 10")
        names |= unread
    return names


def _rel_err(a, b) -> float:
    return float((a - b).float().norm() / b.float().norm().clamp_min(1e-30))


def _train_loss(model, cfg, batch, generator):
    """The train-step loss of ``cfg.task`` on ``batch`` in the model's
    current mode, at epoch 0, with dropout masks from ``generator``."""
    from sonet_torch import train
    score, _ = model(*(batch[n] for n in _input_names(cfg)), epoch=0,
                     generator=generator)
    if cfg.task == "autoencode":
        return train.loops._ae_loss(cfg, score, batch["pc"])[0]
    if cfg.task == "segment":
        return train.losses.cross_entropy_seg(score, batch["seg"])
    return train.losses.cross_entropy(score, batch["label"])


def phase_train(cfg, small, kernel_counters, on_path, ckpt_dir,
                profile_dir=None):
    """Train ``cfg``'s model on the card through ``train.init_state`` and
    ``train.make_steps``, and write the state as a checkpoint under
    ``ckpt_dir``.  Returns the launches of every kernel during the
    TRAIN_STEPS steps, the train state, and the checkpoint's path.  Each
    kernel named in ``on_path`` must launch once per step.  ``small`` is
    the float32 configuration whose train step is held against the CPU."""
    import numpy as np
    import torch
    from sonet_torch import train
    from sonet_torch.models import build_model
    from sonet_torch.nn.encoder import resolve_pooling

    dev = torch.device("cuda")
    B, spe = cfg.batch_size, 100
    state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=spe)
    train_step, eval_step = train.make_steps(cfg, spe)
    model = state.model
    log(f"training {_describe(cfg)}, Adam lr {cfg.lr}, "
        f"pooling={resolve_pooling(cfg, dev)}")
    clouds = _clouds(np, 3 * B, cfg, seed=3)
    if cfg.task == "classify":
        clouds["label"] = np.random.RandomState(4).randint(0, cfg.classes,
                                                           3 * B)
    batches = [{n: torch.from_numpy(a[i * B:(i + 1) * B]).to(dev)
                for n, a in clouds.items()} for i in range(3)]
    stopped = _no_gradient(model, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    _pooling_gradient_checks(torch, cfg, batches[0], model.state_dict())
    # the first train step's loss against the same weights, batch and
    # dropout masks through scatter pooling
    twin = build_model(cfg.replace(pooling="scatter"), device=dev)
    twin.load_state_dict(model.state_dict())
    twin.train()
    with torch.no_grad():
        twin_loss = float(_train_loss(
            twin, cfg, batches[0],
            torch.Generator(device=dev).manual_seed(7)))
    del twin

    gen = torch.Generator(device=dev).manual_seed(7)
    _reset(kernel_counters)
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
    launches = _launch_counts(kernel_counters)
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
        f"tensors moved but {unmoved}; the {len(stopped)} tensors with no "
        f"gradient (biases a BatchNorm follows, a decoder stage nothing "
        f"reads) stayed but {moved}")
    if unmoved or moved:
        raise AssertionError("parameters moved where they should not, or "
                             "did not where they should")
    ev = eval_step(state, batches[0])
    served = "predicted_pc" if cfg.task == "autoencode" else "score"
    if ev[served].shape != _score_shape(cfg, B) or not all(
            bool(torch.isfinite(v).all()) for v in ev.values()):
        raise AssertionError("eval_step: bad scores or metrics")
    log("eval_step: " + ", ".join(f"{k} {float(v)}" for k, v in ev.items()
                                  if v.dim() == 0))

    _train_small_card_vs_cpu(torch, np, train, small)

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
    log(f"{cfg.task} B=8 train step on the card: {step_ms:.4f} ms "
        f"({B / step_ms * 1e3:.1f} clouds/s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    if profile_dir:
        profile_run(step, profile_dir, f"train_step_{cfg.task}")
    ckpt = train.save_checkpoint(ckpt_dir, state, state.step)
    log(f"checkpoint of step {state.step}: {os.path.basename(ckpt)}, "
        f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB")
    return launches, state, ckpt


def _pooling_gradient_checks(torch, cfg, batch, state_dict):
    """The gradients under ``GRAD_CHECKS[cfg.task]``'s prefixes through the
    kernel and through scatter pooling, from the same weights, batch and
    dropout masks, for each of its cases."""
    from sonet_torch.models import build_model
    prefixes, cases, skip = GRAD_CHECKS[cfg.task]
    for dtype, train_mode, tol in cases:
        stats = "batch" if train_mode else "running"
        grads = {}
        for pooling in ("sorted_window", "scatter"):
            m = build_model(cfg.replace(pooling=pooling, compute_dtype=dtype),
                            device="cuda")
            m.load_state_dict(state_dict)
            m.train(train_mode)
            gen = torch.Generator(device="cuda").manual_seed(7)
            _train_loss(m, cfg, batch, gen).backward()
            grads[pooling] = {n: p.grad for n, p in m.named_parameters()
                              if n.startswith(prefixes)
                              and p.grad is not None}
            del m
        kernel, scatter = grads["sorted_window"], grads["scatter"]
        errs = {n: _rel_err(kernel[n], g) for n, g in scatter.items()
                if n not in skip}
        worst = max(errs, key=errs.get)
        log(f"gradients under {', '.join(prefixes)} kernel vs scatter "
            f"pooling ({dtype}, {stats} statistics): {len(errs)} tensors, "
            f"worst relative error {errs[worst]:.3e} ({worst}; tolerance "
            f"{tol}); norms {float(kernel[worst].norm()):.6g} vs "
            f"{float(scatter[worst].norm()):.6g}")
        if set(kernel) != set(scatter) or not all(
                any(n.startswith(p) for n in errs) for p in prefixes):
            raise AssertionError(f"{cfg.task} gradients ({dtype}): a tensor "
                                 f"is missing on one path")
        if errs[worst] > tol:
            raise AssertionError(f"{cfg.task} gradients ({dtype}, {stats} "
                                 f"statistics): the kernel path disagrees "
                                 f"with scatter")


def _train_small_card_vs_cpu(torch, np, train, cfg):
    """One float32 train step of the small configuration ``cfg`` on the
    card against the same step on the CPU: the loss and every gradient.

    The segmenter's gradients are taken from a forward with the running
    statistics, just before the step.  With batch statistics its gradient
    is no continuous function of its inputs: on the CPU alone, a relative
    change of 2e-7 in the weights flips ReLUs and pooling winners and
    moves single gradients by up to 18% of a tensor's largest entry
    (tools/torch_grad_sensitivity.py), so card against CPU would hold or
    fail by the luck of the batch."""
    step, _ = train.make_steps(cfg, steps_per_epoch=10)
    small = _clouds(np, 4, cfg, seed=2)
    if cfg.task == "classify":
        small["label"] = np.random.RandomState(5).randint(0, cfg.classes, 4)
    running = cfg.task == "segment"

    def grads_of(model):
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                .detach().cpu() for n, p in model.named_parameters()}

    out = {}
    for dev in ("cpu", "cuda"):
        state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=10)
        batch = {n: torch.from_numpy(a).to(dev) for n, a in small.items()}
        if running:
            _train_loss(state.model.eval(), cfg, batch, None).backward()
            grads = grads_of(state.model)
        state, metrics = step(state, batch, None)
        if not running:
            grads = grads_of(state.model)
        out[dev] = float(metrics["loss"]), grads
    (want_loss, want), (got_loss, got) = out["cpu"], out["cuda"]
    errs = {n: float((got[n] - w).abs().max())
            / (GRAD_F32_RTOL * float(w.abs().max()) + GRAD_F32_ATOL)
            for n, w in want.items()}
    worst = max(errs, key=errs.get)
    log(f"small float32 {cfg.task} train step, card vs CPU: loss {got_loss} "
        f"vs {want_loss}; worst gradient ("
        f"{'running' if running else 'batch'} statistics) at "
        f"{errs[worst]:.3f} of its tolerance ({worst})")
    if abs(got_loss - want_loss) > SMALL_F32_TOL * max(1.0, abs(want_loss)):
        raise AssertionError("the train loss on the card disagrees with the "
                             "CPU")
    if errs[worst] > 1.0:
        raise AssertionError("the gradients on the card disagree with the "
                             "CPU")


def _same_tensors(torch, got, want, device) -> list:
    """Names under which two flat dicts of tensors differ in value, dtype
    or device (``want``'s device where ``device`` is None)."""
    if list(got) != list(want):
        return sorted(set(got) ^ set(want)) or ["order"]
    return [k for k, w in want.items()
            if not torch.equal(got[k], w) or got[k].dtype != w.dtype
            or got[k].device != (device or w.device)]


def phase_round_trip(cfg, state, run_dir, path, classifier_ckpt):
    """Make ``run_dir``, which holds the trained ``state``'s checkpoint
    ``path`` under ``ckpt/``, a whole run; restore it, serve it, and
    transfer the classifier's encoder into it."""
    import numpy as np
    import torch
    from sonet_torch import train
    from sonet_torch.serving import ServingEngine

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg.save(os.path.join(run_dir, "config.json"))
    fresh = train.init_state(cfg, device="cuda", seed=123)
    train.restore_checkpoint(path, fresh)
    bad = _same_tensors(torch, fresh.model.state_dict(),
                        state.model.state_dict(), dev)
    want_opt, got_opt = (s.optimizer.state_dict() for s in (state, fresh))
    if got_opt["param_groups"] != want_opt["param_groups"]:
        bad.append("optimizer param_groups")
    for i, entry in want_opt["state"].items():
        # moments beside their parameters; step counters where the live
        # optimizer keeps them
        bad += [f"optimizer state {i}: {k}" for k in _same_tensors(
            torch, got_opt["state"].get(i, {}), entry, None)]
        if entry["exp_avg"].device != dev:
            bad.append(f"optimizer state {i}: not on {dev}")
    n_opt = sum(len(e) for e in want_opt["state"].values())
    log(f"restore_checkpoint({os.path.basename(path)}, "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB) into a fresh state: "
        f"{len(state.model.state_dict())} model tensors and {n_opt} "
        f"optimizer tensors on {dev}, step {fresh.step} vs {state.step}; "
        f"different: {bad}")
    if bad or fresh.step != state.step:
        raise AssertionError("the restored state differs from the saved one")

    from_run = ServingEngine.from_run(run_dir, device="cuda")
    from_model = ServingEngine.from_model(state.model, cfg, device="cuda")
    clouds = _clouds(np, 13, cfg, seed=8)
    req = {n: clouds[n] for n in from_run.input_names}
    a, b = from_run.predict(req), from_model.predict(req)
    same = a.shape == _score_shape(cfg, 13) and np.array_equal(a, b)
    m = from_run.manifest
    log(f"ServingEngine.from_run vs from_model on the trained model, B'=13: "
        f"scores {a.shape}, equal {same} (max abs diff "
        f"{float(np.abs(a - b).max())}); manifest source {m['source']!r}, "
        f"checkpoint {os.path.basename(m['checkpoint'])}, pooling "
        f"{m['pooling']}")
    if not same or not np.isfinite(a).all() or m["source"] != "run" or (
            m["checkpoint"] != path):
        raise AssertionError("from_run does not answer as from_model")

    # the classifier's encoder into this state (the transfer path)
    saved = torch.load(classifier_ckpt, map_location=dev, weights_only=True)
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    train.restore_encoder(classifier_ckpt, fresh)
    after = fresh.model.state_dict()
    enc = [k for k in after if k.startswith("encoder.")]
    wrong = [k for k in enc if not torch.equal(after[k], saved["model"][k])]
    touched = [k for k in after if k not in enc
               and not torch.equal(after[k], before[k])]
    changed = sum(not torch.equal(after[k], before[k]) for k in enc)
    log(f"restore_encoder from the classifier's checkpoint: {len(enc)} "
        f"encoder entries set ({changed} changed), wrong {wrong}; "
        f"{len(after) - len(enc)} head entries, touched {touched}")
    if wrong or touched or not changed:
        raise AssertionError("restore_encoder set the wrong entries")


def _quantization_error(torch, x, nodes) -> float:
    """The mean distance of a point to its nearest node; x (B, N, C),
    nodes (B, M, C) on one device."""
    d = (x[:, :, None, :] - nodes[:, None, :, :]).norm(dim=-1)
    return float(d.min(-1).values.mean())


def phase_som(profile_dir=None):
    """``som.fit`` on the card: 64 clouds of 1024 points, 8x8 nodes, both
    schedules, held against the CPU's."""
    import numpy as np
    import torch
    from sonet_torch import config, som

    n_cpu = 16          # the CPU fits this many of the clouds (each cloud's
    #                     fit is its own)
    shape = config.autoencoder()
    x = _clouds(np, 64, shape.replace(task="classify"), seed=11)["pc"]
    x_card = torch.from_numpy(x).cuda()
    x_cpu = torch.from_numpy(x[:n_cpu])
    lo, hi = float(x.min()), float(x.max())
    log(f"SOM: {x.shape[0]} clouds of {x.shape[1]} points, "
        f"{shape.rows}x{shape.cols} nodes, coordinates in [{lo:.3f}, "
        f"{hi:.3f}]")
    for schedule in ("prep", "online"):
        cfg = som.SOMConfig(rows=shape.rows, cols=shape.cols, dim=3,
                            schedule=schedule)
        nodes = som.fit(x_card, cfg, device="cuda")
        if nodes.shape != (len(x), cfg.node_num, 3) or nodes.dtype != torch.float32 or (
                not nodes.is_cuda) or not bool(torch.isfinite(nodes).all()):
            raise AssertionError(f"som.fit ({schedule}): bad nodes "
                                 f"{tuple(nodes.shape)} {nodes.dtype}")
        if float(nodes.min()) < lo or float(nodes.max()) > hi:
            raise AssertionError(f"som.fit ({schedule}): nodes outside the "
                                 f"clouds' bounds")
        # one update, from the initial nodes and from the fitted ones
        init = som.init_nodes(cfg, n_cpu, device="cpu")
        for name, start in (("initial", init), ("fitted", nodes[:n_cpu].cpu())):
            want = som.batch_update(start, x_cpu, 0.5, 0.4, cfg)
            got = som.batch_update(start.cuda(), x_card[:n_cpu], 0.5, 0.4, cfg)
            diff = float((got.cpu() - want).abs().max())
            log(f"som.batch_update ({schedule}) from the {name} nodes, card "
                f"vs CPU: max abs diff {diff} (tolerance {SOM_UPDATE_TOL})")
            if diff > SOM_UPDATE_TOL:
                raise AssertionError("som.batch_update on the card disagrees "
                                     "with the CPU")
        # the whole fit, by what it is for
        on_cpu = som.fit(x_cpu, cfg, device="cpu")
        q_init = _quantization_error(torch, x_cpu, init)
        q_cpu = _quantization_error(torch, x_cpu, on_cpu)
        q_card = _quantization_error(torch, x_card[:n_cpu], nodes[:n_cpu])
        diff = float((nodes[:n_cpu].cpu() - on_cpu).abs().max())
        log(f"som.fit ({schedule}), {n_cpu} clouds, card vs CPU: quantization "
            f"error {q_card} vs {q_cpu} (initial nodes {q_init}; tolerance "
            f"{SOM_QE_RTOL} x the CPU's), largest node difference {diff}")
        if abs(q_card - q_cpu) > SOM_QE_RTOL * q_cpu or not q_card < q_init:
            raise AssertionError("som.fit on the card disagrees with the CPU, "
                                 "or does not bring the nodes to the points")
        # true float32 whatever the matmul switch says, and no atomics
        again = som.fit(x_card, cfg, device="cuda")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with_tf32 = som.fit(x_card, cfg, device="cuda")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        same = torch.equal(with_tf32, nodes), torch.equal(again, nodes)
        log(f"som.fit ({schedule}): same bits with allow_tf32 on {same[0]}, "
            f"same bits from a second call {same[1]}")
        if not all(same):
            raise AssertionError("som.fit depends on allow_tf32 or differs "
                                 "from call to call")
        n_updates = len(som.som._schedule(cfg)[0])
        fit_ms = time_ms(lambda: som.fit(x_card, cfg, device="cuda"), reps=5)
        log(f"som.fit ({schedule}) of {len(x)} clouds on the card: "
            f"{fit_ms:.4f} ms ({n_updates} updates, "
            f"{fit_ms / n_updates:.4f} ms an update, "
            f"{len(x) / fit_ms * 1e3:.1f} clouds/s)")
        if profile_dir:
            profile_run(lambda: som.fit(x_card, cfg, device="cuda"),
                        profile_dir, f"som_fit_{schedule}")


def _launch_counts(kernel_counters):
    return {n: c.launches for n, c in kernel_counters.items()}


def _reset(kernel_counters):
    for counter in kernel_counters.values():
        counter.launches = 0


def _to_card(batch):
    import torch
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()
            if k != "valid"}


def _busy_share(fn):
    """(wall s, device-busy s, device rows) of one call of ``fn`` under
    torch.profiler: the card's busy share is the second over the first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof.key_averages())
    return wall, sum(e.self_device_time_total for e in rows) / 1e6, sum(
        e.count for e in rows)


def _cli(argv):
    """``sonet-torch <argv>``, as a user runs it, in this process."""
    from sonet_torch import cli
    log(f"sonet-torch {' '.join(argv)}")
    t0 = time.perf_counter()
    rc = cli.main(argv)
    import torch
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"sonet-torch {argv[0]} exited with {rc}")
    return time.perf_counter() - t0


def _logged(run_dir, key):
    """The last record with ``key`` in the run's metric log."""
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f if f'"{key}"' in ln][-1]


def _eval_by_hand(state, eval_step, loader):
    """(mean loss over the valid items, their count) of ``loader``."""
    loss_sum, count = 0.0, 0
    for batch in loader:
        valid = int(batch["valid"])
        m = eval_step(state, _to_card(batch))
        loss_sum += float(m["loss_i"][:valid].double().sum())
        count += valid
    return loss_sum / count, count


def phase_trainer(kernel_counters, on_path, runs):
    """``sonet-torch classify`` (``cli.main``) on the card at
    ``config.modelnet40()``'s width, on the synthetic dataset (nodes fitted
    on the card), with point dropout drawing from a CUDA generator: one
    epoch, its eval over every test item, a periodic checkpoint, the epoch
    time with the loader in.  Then a ``Trainer`` on that run: the resume,
    the eval by hand, the card's busy share over an epoch, a graceful stop
    and a resume bit for bit, ``ServingEngine.from_run``.  Returns the
    launches of every kernel in the command's run."""
    import numpy as np
    import torch
    from sonet_torch import config, train
    from sonet_torch.config import load_config
    from sonet_torch.serving import ServingEngine
    from sonet_torch.train.trainer import Trainer

    flags = ["--preset", "modelnet40", "--dataset", "synthetic",
             "--random_pc_dropout_lower_limit", "0.8",
             "--checkpoint_every", "20", "--epochs", "1",
             "--checkpoints_dir", runs, "--name", "trainer"]
    cfg = config.parse_args(flags)
    B = cfg.batch_size
    run = os.path.join(runs, "trainer")
    _reset(kernel_counters)
    cli_s = _cli(["classify", "--device", "cuda"] + flags)
    launches = _launch_counts(kernel_counters)
    summary = _logged(run, "train_sec_per_step")
    logged = _logged(run, "test_loss")
    sec = summary["train_sec_per_step"]
    ckpt = train.latest_checkpoint(os.path.join(run, "ckpt"))
    log(f"{_describe(cfg)}, point dropout from "
        f"{cfg.random_pc_dropout_lower_limit}: the command took {cli_s:.3f} "
        f"s (datasets, nodes fitted on the card, one epoch, its eval, "
        f"checkpoints); test loss {logged['test_loss']}, accuracy "
        f"{logged['test_accuracy']}; last train loss {summary['train_loss']}; "
        f"checkpoint {ckpt}; kernel launches {launches}")
    log(f"Trainer epoch with the loader in: {sec * 1e3:.4f} ms a step "
        f"({B / sec:.1f} clouds/s)")
    if (load_config(os.path.join(run, "config.json")).to_dict()
            != cfg.to_dict() or ckpt is None
            or not np.isfinite(logged["test_loss"])):
        raise AssertionError("sonet-torch classify: bad run or metrics")

    t0 = time.perf_counter()
    trainer = Trainer(cfg, quiet=True, device="cuda")
    steps = trainer.steps_per_epoch
    n_eval = -(-len(trainer.test_set) // B)
    log(f"a Trainer on the run: {len(trainer.train_set)} train and "
        f"{len(trainer.test_set)} test clouds, {steps} steps an epoch, built "
        f"in {time.perf_counter() - t0:.3f} s, resumed at step "
        f"{trainer.state.step}")
    if (len(trainer.train_set), len(trainer.test_set)) != (320, 160):
        raise AssertionError("the synthetic splits are not 320 and 160")
    if trainer.state.step != steps:
        raise AssertionError("the Trainer did not resume the command's run")
    for n in on_path:
        if launches[n] != steps + n_eval:
            raise AssertionError(f"{n} launched {launches[n]} times in an "
                                 f"epoch of {steps} steps and {n_eval} eval "
                                 f"batches")
    loss, count = _eval_by_hand(trainer.state, trainer.eval_step,
                                trainer.test_loader)
    log(f"eval by hand over {count} valid items: loss {loss} vs the run's "
        f"{logged['test_loss']}")
    if (count != 160 or abs(loss - logged["test_loss"])
            > 1e-5 * max(1.0, logged["test_loss"])):
        raise AssertionError("Trainer: the eval is not weighted by the "
                             "valid items")

    wall, busy, rows = _busy_share(lambda: trainer.train_epoch(1))
    log(f"a second epoch under torch.profiler: {wall * 1e3 / steps:.4f} ms "
        f"a step by the host clock, the card busy {busy * 1e3 / steps:.4f} "
        f"ms a step ({busy / wall:.1%} of the epoch), {rows // steps} "
        f"device rows a step; that device time over the command's "
        f"{sec * 1e3:.4f} ms a step: {busy / steps / sec:.1%}")

    trainer.request_stop()
    trainer.fit(epochs=1)
    stopped = trainer.state.step
    resumed = Trainer(cfg, quiet=True, device="cuda")
    bad = _same_tensors(torch, resumed.model.state_dict(),
                        trainer.model.state_dict(), None)
    log(f"request_stop: stopped at step {stopped}, checkpoint "
        f"{os.path.basename(train.latest_checkpoint(os.path.join(run, 'ckpt')))}; "
        f"a new Trainer resumed at step {resumed.state.step}, tensors "
        f"differing {bad}")
    if resumed.state.step != stopped or stopped != 2 * steps + 1 or bad:
        raise AssertionError("Trainer: the stop or the resume is wrong")
    del resumed

    engine = ServingEngine.from_run(run, device="cuda")
    batch = next(iter(trainer.test_loader))
    got = engine.predict({n: batch[n] for n in engine.input_names})
    want = trainer.eval_step(trainer.state, _to_card(batch))["score"]
    want = want.float().cpu().numpy()
    diff = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    log(f"ServingEngine.from_run vs Trainer.eval_step: max abs diff {diff} "
        f"(tolerance {LOGIT_RTOL} x {scale})")
    if got.shape != want.shape or diff > LOGIT_RTOL * scale:
        raise AssertionError("from_run does not answer as the Trainer")
    return launches


def _shrec_tree(np, root, cfg, counts=(("train", 110), ("val", 55),
                                       ("test", 55)), points=6000):
    """A SHREC16 tree in the prepared layout of the JAX package's
    ``data/modelnet.py`` under ``root``: the synthetic dataset's surfaces,
    one class a shape in turn, nodes fitted on the card."""
    from sonet_torch.data.synthetic import _shape_cloud
    rng = np.random.default_rng(0)
    cats = [f"cat{i:02d}" for i in range(cfg.classes)]
    n = sum(c for _, c in counts)
    pc = np.zeros((n, points, 3), np.float32)
    sn = np.zeros((n, points, 3), np.float32)
    for i in range(n):
        cls = i % cfg.classes
        p, q = _shape_cloud(cls, points, rng)
        pc[i], sn[i] = p * (0.5 + 0.05 * (cls // 4)), q
    nodes = _fit_nodes(pc, cfg)
    with open(os.path.join(root, "category.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    i = 0
    for mode, count in counts:
        d = os.path.join(root, f"{cfg.rows}x{cfg.rows}", mode)
        os.makedirs(d)
        lines = []
        for _ in range(count):
            name = f"{i:06d}"
            np.savez(os.path.join(d, f"model_{name}.npz"), pc=pc[i],
                     sn=sn[i], som_node=nodes[i])
            lines.append(name if mode == "test"
                         else f"{name},{cats[i % cfg.classes]}")
            i += 1
        with open(os.path.join(root, f"{mode}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def phase_retrieve(kernel_counters, on_path, runs):
    """SHREC16 retrieval at ``config.shrec16()``'s width (som_k=0), as a
    user runs it: ``sonet-torch classify`` for one epoch on a written tree,
    evaluated on ``val``, then ``sonet-torch retrieve`` from its checkpoint
    over the test split.  Its rank files are held against the test split's
    scores from the same checkpoint ranked by ``retrieval.rank_all`` on the
    card, and that ranking against the CPU's; metrics.  Returns the
    launches of every kernel in the two commands' runs."""
    import numpy as np
    import torch
    from sonet_torch import config, retrieval, train
    from sonet_torch.data.pipeline import BatchLoader
    from sonet_torch.train.trainer import build_dataset
    from sonet_torch.utils import visualize

    root = os.path.join(runs, "shrec16")
    os.makedirs(root)
    data = ["--preset", "shrec16", "--dataroot", root]
    cfg = config.parse_args(data)
    t0 = time.perf_counter()
    _shrec_tree(np, root, cfg)
    log(f"retrieval {_describe(cfg)}: SHREC tree of 110 / 55 / 55 shapes of "
        f"6000 points written in {time.perf_counter() - t0:.3f} s")
    run = os.path.join(runs, "retrieve")
    out = os.path.join(runs, "rank")
    _reset(kernel_counters)
    _cli(["classify", "--device", "cuda", "--epochs", "1", "--checkpoints_dir",
          runs, "--name", "retrieve"] + data)
    ckpt = train.latest_checkpoint(os.path.join(run, "ckpt"))
    if ckpt is None:
        raise AssertionError("sonet-torch classify left no checkpoint")
    retrieve_s = _cli(["retrieve", "--device", "cuda", "--checkpoint", ckpt,
                       "--output_dir", out] + data)
    launches = _launch_counts(kernel_counters)
    n_batches = -(-55 // cfg.batch_size)
    want_launches = 110 // cfg.batch_size + 2 * n_batches
    log(f"sonet-torch retrieve took {retrieve_s:.3f} s; kernel launches in "
        f"both commands {launches}")
    for n in on_path:
        if launches[n] != want_launches:
            raise AssertionError(f"{n} launched {launches[n]} times, want "
                                 f"{want_launches}")

    # the same checkpoint, scored and ranked here
    state = train.init_state(cfg, device="cuda", seed=cfg.seed)
    train.restore_checkpoint(ckpt, state)
    _, eval_step = train.make_steps(cfg, 1)
    loss, count = _eval_by_hand(state, eval_step, BatchLoader(
        build_dataset(cfg, "val", "cuda"), cfg.batch_size, shuffle=False,
        drop_last=False, pad_last=True))
    logged = _logged(run, "test_loss")["test_loss"]
    log(f"the val split's loss by hand {loss} over {count} items vs the "
        f"run's {logged}")
    if count != 55 or abs(loss - logged) > 1e-5 * max(1.0, logged):
        raise AssertionError("sonet-torch classify did not evaluate on val")
    loader = BatchLoader(build_dataset(cfg, "test", "cuda"), cfg.batch_size,
                         shuffle=False, drop_last=False, pad_last=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, labels, ids = retrieval.extract_scores(eval_step, state, loader,
                                                   _to_card)
    extract_ms = (time.perf_counter() - t0) * 1e3
    card = torch.from_numpy(scores).cuda()
    retrieval.rank_all(card)
    rank_ms = time_ms(lambda: retrieval.rank_all(card), reps=5)
    results = retrieval.rank_all(card)
    mine = os.path.join(runs, "rank_here")
    retrieval.write_rank_files(results, ids, mine)
    files = sorted(os.listdir(mine))

    def same(name):
        with open(os.path.join(out, name), "rb") as x, open(
                os.path.join(mine, name), "rb") as y:
            return x.read() == y.read()

    same_files = [f for f in files if same(f)]
    log(f"extract_scores over {len(scores)} test shapes: {extract_ms:.4f} ms; "
        f"rank_all on the card: {rank_ms:.4f} ms; the command's rank files "
        f"byte-equal to these: {len(same_files)} of {len(files)}")
    if sorted(f for f in os.listdir(out) if f != "gallery") != files or (
            same_files != files):
        raise AssertionError("sonet-torch retrieve wrote other rank files")
    if os.path.isdir(os.path.join(out, "gallery")) != visualize.available():
        raise AssertionError("the gallery is not drawn exactly when "
                             "matplotlib is there")

    on_cpu = retrieval.rank_all(scores)
    # |a|^2 + |b|^2 - 2 a.b in float32 is exact to about C eps (|a|^2 +
    # |b|^2) on each side, whatever the order of its sums: the bound the
    # squared distances of the two devices are held to (a query's
    # distance to itself, 0 up to that rounding, included)
    n2 = (scores.astype(np.float64) ** 2).sum(1)
    eps = float(np.finfo(np.float32).eps)
    worst, lists_equal = 0.0, True
    for q, ((gi, gd), (wi, wd)) in enumerate(zip(results, on_cpu)):
        lists_equal &= np.array_equal(gi, wi)
        if not lists_equal:
            break
        bound = 2 * scores.shape[1] * eps * (n2[q] + n2[gi])
        diff = np.abs(gd.astype(np.float64) ** 2 - wd.astype(np.float64) ** 2)
        worst = max(worst, float((diff / bound).max()))
    log(f"rank_all on the card: candidate lists equal to the CPU's "
        f"{lists_equal}; squared distances apart by at most {worst:.3f} of "
        f"the float32 rounding bound C eps (|a|^2 + |b|^2) of the two sides; "
        f"score norms {float(np.sqrt(n2.min())):.4g} to "
        f"{float(np.sqrt(n2.max())):.4g}")
    if not lists_equal or worst > 1.0:
        raise AssertionError("rank_all on the card disagrees with the CPU")
    scores_m = retrieval.retrieval_metrics(results, labels)
    log(f"{len(files)} rank files ({files[0]} .. {files[-1]}); metrics "
        f"{scores_m}")
    if files != [f"{int(i):06d}" for i in sorted(ids)] or len(files) != 55 or (
            not all(np.isfinite(v) and 0.0 <= v <= 1.0
                    for v in scores_m.values())):
        raise AssertionError("retrieval: bad rank files or metrics")
    return launches


def _device_rows(events):
    """The device rows of a profiler's ``key_averages()``: kernels, copies
    and memsets.  The operator rows repeat their kernels' time, and so
    does the span that the optimizer step marks on the device, gaps
    between its kernels included."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.step")]


def profile_run(fn, out_dir, what):
    """torch.profiler over 5 calls of ``fn``: the kernel table to
    ``out_dir/profile_<what>.txt`` and the device-busy share of the window
    to stdout."""
    import torch
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
    kernels = _device_rows(events)
    busy_us = sum(e.self_device_time_total for e in kernels)
    path = os.path.join(out_dir, f"profile_{what}.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"profile: 5 x {what}, wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%} under the "
        f"profiler) in {sum(e.count for e in kernels) // 5} kernels, copies "
        f"and memsets a call; table in {path}")
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
    from sonet_torch import config
    classify, segment = config.modelnet40(), config.shapenetpart()
    autoenc = config.autoencoder()
    small = config.tiny_test()
    small_seg = small.replace(task="segment", classes=segment.classes)
    small_ae = small.replace(task="autoencode")
    by_path = {}
    with tempfile.TemporaryDirectory() as runs:
        by_path["serve"] = phase_serve(classify, small, counters, on_path,
                                       args.profile)
        by_path["train"], _, classifier_ckpt = phase_train(
            classify, small.replace(dropout=0.0), counters, on_path,
            os.path.join(runs, "classify", "ckpt"), args.profile)
        by_path["serve_segment"] = phase_serve(segment, small_seg, counters,
                                               on_path, args.profile)
        seg_run = os.path.join(runs, "segment")
        by_path["train_segment"], seg_state, seg_ckpt = phase_train(
            segment, small_seg.replace(dropout=0.0), counters, on_path,
            os.path.join(seg_run, "ckpt"), args.profile)
        phase_round_trip(segment, seg_state, seg_run, seg_ckpt,
                         classifier_ckpt)
        phase_som(args.profile)
        by_path["serve_autoencode"] = phase_serve(autoenc, small_ae, counters,
                                                  on_path, args.profile)
        ae_run = os.path.join(runs, "autoencode")
        by_path["train_autoencode"], ae_state, ae_ckpt = phase_train(
            autoenc, small_ae.replace(dropout=0.0), counters, on_path,
            os.path.join(ae_run, "ckpt"), args.profile)
        phase_round_trip(autoenc, ae_state, ae_run, ae_ckpt, classifier_ckpt)
        for name, phase in (("trainer", phase_trainer),
                            ("retrieve", phase_retrieve)):
            t1 = time.perf_counter()
            by_path[name] = phase(counters, on_path, runs)
            log(f"phase {name}: {time.perf_counter() - t1:.1f} s")
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
