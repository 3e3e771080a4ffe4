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
   inputs, at the part segmenter's shape (8, 3072, 384) and at the MNIST
   classifier's (8, 1536, 384) with M=25 (ids from a real top-k
   assignment of fabricated digits to nodes fitted on the card), and at
   the bucketed artifact's (B, 15000, 384) for B = 1, 2, 4 (each equal to
   those rows of the B=8 call), and at the per-rank shapes of the mesh
   phases, (4, 15000, 384) and (8, 7500, 384); each of its
   cases must take the kernel (bulk or direct) that its shape and
   alignment name, and equal (``==``) on every occupied node two more
   plain versions of the function, ``ops.segment_max_sorted`` and
   ``ops.segment_max_onehot``.  Kernel 2 (``segment_argmax``) is on no
   path of the model and is held here only, also against kernel 1's
   values.  The fused BatchNorm (``batchnorm_act``: train forward, eval
   forward, backward) at each main-path shape in bf16 against its plain
   version, timed by graph beside its bound, the plain version and
   ``F.batch_norm`` with ``relu``; its launches are counted by mode on
   every path (``batchnorm_act.train``, ``.eval``, ``.backward``).  Node
   pooling's backward (``segment_max_grad``, two kernels) against its
   plain version, ``route_max_grad_plain``, at the three main-path shapes
   (8, 15000, 384), (8, 3072, 384) and (8, 1536, 384) with M=25, in bf16
   with sorted ids from a real assignment and unsorted ids, at the
   flagship in float32 and on edge cases (``pool_grad_cases``), each
   ``==`` but the point0 row of a cloud with an empty node (one rounding);
   timed by graph beside its bound, its two kernels' device durations and
   the plain chain's time; its calls are counted on every path, once a
   train step and never in a served forward.  Node recentering's segment
   sums (``segment_sums``) against their plain version (the float32
   one-hot arithmetic) and a float64 sum at (8, 15000, 3), (8, 3072, 3),
   (8, 1536, 2) with M=25 and (1, 15000, 3), with sorted ids from a real
   assignment, and on edge cases (``segment_sums_cases``): counts ``==``,
   sums within 1e-5 of the absolute sums of their rows, two calls the
   same bits; timed by graph beside its bound, the plain version and the
   float32 one-hot ``bmm`` it replaces; its launches are counted on every
   path, like kernel 1's: once in each encoder forward that Python runs.
   Adam's update (``adam_step``, both groups in one call) at each cell's
   parameter set against ``torch.optim.Adam(foreach=True,
   capturable=True)`` (``==``) and its plain version over three steps,
   timed by graph beside its bound (28 bytes a parameter) and the foreach
   Adam; its calls are counted on every path: once a train step that
   Python runs, and on exactly the paths that run a backward.  The train
   step's three sorts (``node_sort``, ``smallest_k``, ``subset_select``)
   against their plain versions, the stable ``torch.sort`` code they
   replace, at every cell's shapes (``SORT_SHAPES``) and on edge cases,
   bit for bit (NaN and signed zeros included), timed by graph beside
   their bound, the plain version and ``torch.sort`` alone; the node
   sort's launches are held to kernel 1's on every path, the top-k
   selection's to at least kernel 1's and to two a train step, and the
   subsample's to the device pipeline's sampled steps;
4. serving: the ModelNet40 classifier (``config.modelnet40()``, full
   width, seeded random weights) served through ``ServingEngine`` on the
   card, its forward a captured CUDA graph: the warm-up captures it
   (kernel 1 at (8, 15000, 384), M=64, in the warm-up step and the
   capture, every launch count read from 0 before it), then requests of
   1, 8 and 13 clouds replay it once a chunk of 8 and launch nothing;
   logits checked for shape and finiteness, held against the eager
   ``build_serve_fn`` on the same inputs and against the same weights with
   scatter pooling; a small float32 model held against the same model on
   the CPU; the B=8 forward timed eager and replayed, in turns, by events
   and by device time;
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
   every kernel's launch count read from 0, its train and eval steps
   captured graphs (2 captures, kernel 1 at (8, 15000, 384) only, a replay
   a step and an eval batch), ``config.json`` and a checkpoint written,
   the epoch's time a step with the loader in; then a ``train.Trainer`` on
   that run: it resumes at the run's step, its eval by hand over the 160
   valid items equals the run's, the card's busy share over an epoch
   under torch.profiler, ``request_stop`` and a ``fit`` that checkpoints,
   a new ``Trainer`` that resumes at that step bit for bit,
   ``ServingEngine.from_run`` against ``Trainer.eval_step``, a captured
   host-pipeline train step against the eager one from the same state,
   batch and generator (``CAPTURED_RTOL``), ``evaluate()`` twice to the
   same bits;
13. retrieve: ``config.shrec16()`` at full width (som_k=0, 55 classes): a
   SHREC tree of 110 / 55 / 55 shapes of 6000 points written with nodes
   fitted on the card; ``sonet-torch classify`` for one epoch, evaluated
   on ``val`` (its loss equal to one by hand), and ``sonet-torch
   retrieve`` from its checkpoint, kernel launches and graph replays read
   from 0 over both (3 captured steps, a replay a batch);
   its 55 rank files, named by the split's ids, byte-equal to the same
   checkpoint's test scores (``retrieval.extract_scores``) ranked by
   ``rank_all`` on the card, and that ranking held against the CPU's; a
   gallery exactly when matplotlib is installed; mAP and P@k; the
   extraction and the ranking timed;
14. reproduce: 40 classes of superellipsoid meshes (3 a class) sampled by
   ``sonet-torch prep sample --points 10000 --normalize`` and packed as a
   ModelNet40 ``.tar.gz``; ``sonet-torch reproduce --preset modelnet40
   --epochs 1`` ingests it, fits its nodes on the card (``prep som``),
   checks the tree, trains one epoch at B=8, N=5000 (captured steps, a
   replay a batch) and prints the
   verdict: below the 0.918 gate, rc 1; the same command again reuses the
   tree and the run and gives the same ``best``; ``prep som``'s fit of 64
   clouds of 4096 points timed;
15. infer: ``sonet-torch infer`` on that run's test split (41 items, the
   last batch padded): 41 rows from 6 replays of the captured eval step,
   its accuracy equal to the run's own ``Trainer.evaluate()`` over the
   same items; clouds/s; the eval step alone eager and replayed;
16. mnist: a fabricated ``mnist.npz`` (2,048 train and 512 test digits),
   ``sonet-torch classify --preset mnist --epochs 1`` (nodes fitted on the
   card) and ``sonet-torch infer``: finite metrics, 3 captured steps
   replayed once a batch, every call of kernel 1 at (8, 1536, 384) with
   M=25, the nodes' quantization error within 1% of a CPU fit's; a train
   step timed eager and replayed;
17. serve_http: the reproduce run through ``ServingEngine.from_run`` with
   ``start_microbatch(5)`` behind ``tasks.serve.make_server`` on
   127.0.0.1: 16 concurrent B'=1 requests, each within the bf16 rule of
   the engine's direct predict, sharing dispatches, a replay each
   (the micro-batcher's thread only replays); B'=1 request times
   with micro-batching on and off; ``drain_server`` with a request in
   flight: /healthz and a new predict answer 503, the request finishes;
18. trainer_device (run after 14, on its tree of 10,000-point clouds):
   ``sonet-torch classify --input_pipeline device`` at
   ``config.modelnet40()``'s width, two epochs, the learning rate and the
   BatchNorm momentum new each epoch: the split on the card, each step a
   captured CUDA graph (gather, 5,000-point subsample, augmentation,
   forward, loss, backward, Adam) replayed once per row of the epoch's
   table, kernel 1 captured at (8, 15000, 384) only, graph captures and
   replays counted; then a ``Trainer`` on the run: a captured step equal
   to the eager one from the same state (``CAPTURED_RTOL``) with epoch 3's
   learning rate and momentum, two replays drawing anew as eager calls
   do, ``evaluate()`` twice to the same bits, the run restored into a
   host-pipeline ``Trainer`` (captured too) bit for bit; fresh device and host
   ``Trainer``s timed on the tree in alternating epochs (a step with the
   loader in; device time and busy share under torch.profiler);
19. trainer_chunked: the same command for one epoch with a
   ``--device_budget_gb`` that streams the split in 4 chunks: the resident
   run's weights after that epoch, bit for bit;
20. trainer_native: ``sonet-torch classify --input_pipeline native`` on
   the tree for one epoch and ``sonet-torch infer --input_pipeline
   native`` on the run (its accuracy equal to the run's
   ``Trainer.evaluate()``), 3 captured steps replayed once a batch; the
   run restored into a device-pipeline ``Trainer`` bit for bit; native
   and host ``Trainer``s timed in alternating epochs;
21. export: the reproduce run exported by ``sonet-torch export --check``
   as a ``cuda`` artifact (kernel 1 kept as the operator
   ``sonet_torch::windowed_vals``), a bucketed ``--poly_batch`` one and a
   portable symbolic one (``--platforms cpu,cuda``); each served by
   ``ServingEngine.from_artifact`` (a captured graph a program's batch,
   kernel 1 at (B, 15000, 384) for B = 1, 2, 4, 8) on 41 clouds at
   B' = 1, 3, 8 and 41 within the bf16 rule of ``from_run`` (of a scatter
   ``from_run`` for the portable one); a process that cannot import
   ``sonet_torch`` loads the portable ``model.pt2`` and answers as its
   engine; ``make_server`` on the artifact answers 16 concurrent B'=1
   requests and ``sonet-torch serve --artifact``, as a process, one;
   bytes and export times;
22. import_ckpt: the reproduce run written out as the reference's
   ``.pth`` files (``compat.export_reference_checkpoint``), read back by
   ``sonet-torch import-ckpt`` into a new run, and that run served by
   ``ServingEngine.from_run``: every answer equal (``==``) to the
   original run's, kernel 1 at (8, 15000, 384); the same files against
   ``--classes 10`` refused before anything is written;
23. train_remat: a ``config.modelnet40()`` train step with ``remat=True``
   (the first PointNet run again in the backward), captured, against the
   same step without it from the same weights, batch and generator state:
   loss, gradients, update and running statistics equal (``==``), or
   within ``CAPTURED_RTOL`` with the largest difference printed; each
   step's peak memory (eager and over its capture) and time;
24. profile: ``utils.tprof.device_time`` of the ``config.modelnet40()``
   forward and train step within 3% of the reading by hand
   (``_busy_share``) in the same run, the kernels bucketed by
   ``utils.hlocat.categorize`` (the pooling bucket exactly kernel 1's
   launches), ``utils.profiling.scan_bench`` of kernel 1 at
   (8, 15000, 384) within 5% of phase 3's graph reading;
25. monitor: ``utils.dashboard.make_dashboard_server`` over the trainer
   run answering one request with that run's metric rows;
26. quality: the quality chain's tools at full width on tiny generated
   trees: ``tools/torch_make_modelnet_scale.py`` (40 classes of 2 train
   and 1 test shapes of 10,000 points, hardness 0.15), ``prep som`` on
   the card, and ``tools/torch_soak.py --epochs 1 --band --input_pipeline
   device`` in this process: rc 1 and its band line ``OUTSIDE`` (one
   epoch on 80 shapes cannot reach modelnet40's band), read by
   ``tools/torch_quality.py``'s parser; the same for shapenetpart on
   ``tools/torch_make_shapenet_scale.py``'s 16 categories of 2 train and
   1 test shapes (its captured eval computes the IoU); then
   ``tools/torch_make_shrec_scale.py`` (55 classes of 6 shapes) and
   ``tools/torch_soak_retrieval.py`` for one epoch: 55 rank files, the
   test split's ground truth (id // 6) from every class; 7 captures,
   kernel 1 in a warm-up and a capture of each, with every launch count
   read from 0 before the three soaks;
27. mesh: ``config.modelnet40()`` on two ranks of the one card, launched
   as a user launches them (``python -m torch.distributed.run
   --standalone --nproc_per_node 2``; this script's ``--mesh_steps``
   mode), ``--device cuda:0``: the ranks share the card, so their group
   runs over gloo and every step eagerly.  First kernel 1 under (1, 2)
   at (8, 7500, 384) a rank: the kernel and the all-reduce MAX `==` the
   plain version with the same all-reduce, and `==` the kernel on the
   whole clouds.  On meshes (2, 1) and (1, 2)
   kernel 1 is launched once a step on each rank at (4, 15000, 384) and
   (8, 7500, 384), M=64, counted in the ranks from 0; the first train
   step's loss within 2% of the one-process step from the same weights
   and batch (bf16), ten steps finite and falling on one batch, each
   timed with its gloo collectives apart; then the same first step in
   float32, its loss within ``MESH_F32_LOSS_RTOL``, its gradients and
   update within ``MESH_GRAD_RTOL`` and ``MESH_UPDATE_RTOL`` of one
   process's by the relative norm of the difference (in bf16 the train-mode gradients move by ~25% under the
   statistics' other order, and Adam's first step with their signs:
   ``MESH_UPDATE_DTYPE``), read beside one process's step from weights
   one rounding away (``NUDGE``); under (1, 2) a planted fault, node-level
   gradients summed over ``points``, must fail the gradient gate; every
   rank counts both kernels' launches and the graph replays from 0 around
   its main path.  Beside phase 30, a world of
   one over NCCL (``--mesh_nccl``, ``--device cuda``): the train step
   over its (1, 1) mesh, gradients and metrics all-reduced by NCCL inside
   the graph, captured, and one replay `==` the captured step over no
   mesh;
28. mesh_segment: phase 27's (1, 2) step at ``config.shapenetpart()``
   width;
29. mesh_autoencode: the same at ``config.autoencoder()`` width, with the
   Chamfer pairs whose nearest point moves, over the mesh and from the
   nudged weights, counted against one process's;
30. mesh_trainer: ``sonet-torch classify --distributed auto --device
   cuda:0`` on two ranks over the "reproduce" tree (this script's
   ``--rank_cli`` mode counts each rank's launches around ``cli.main``):
   the host pipeline for two epochs, a SIGTERM to rank 1 alone once
   epoch 0's eval is logged stopping both ranks in epoch 1 with one
   checkpoint, the run directory written once (by rank 0: every record
   once), the run restored in one process bit for bit; the device
   pipeline for one epoch with the train split sharded over the two
   ranks; ``sonet-torch infer --mesh_shape 2 --dump_arrays`` on the
   run against one process's ``infer``: the accuracy equal, the loss
   within 2%, the same rows, each item's class scores within the bf16
   rule and its predicted class the same wherever the two best scores
   are further apart than that;
31. kernel 1's calls by shape over every phase after 3, and a JSON line
   of every kernel with its launches on each of the twenty-five paths
   beside its graph replays there, error and times;
32. last line: {"ok": true, "device": {...}}.

``--profile DIR`` also writes torch.profiler tables of each B=8 forward
and train step to ``DIR/profile_<forward|train_step>_<task>.txt``, of the
autoencoder's decoder alone (``profile_forward_decoder.txt``) and of each
SOM fit (``profile_som_fit_<schedule>.txt``), and prints the device-busy
shares and buckets; phase 24 writes its rows (ms, launches, bucket,
kernel name) to ``DIR/profile_tprof_<forward|train_step>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
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
# a captured train step against the eager step from the same weights,
# batch and generator state, by the relative norm of the difference of
# their updates over every tensor: the bf16 rule (2%).  The two run the
# same kernels on the same inputs; a graph that kept another epoch's
# learning rate or BatchNorm momentum moves the weights by another
# factor (halved here: 100%) and the running statistics by another
# momentum (0.06 against 0.036: 67%)
CAPTURED_RTOL = 2e-2
# the device pipeline's runs: the "reproduce" tree, lr halved and
# BatchNorm momentum decayed every epoch, so each epoch's step reads new
# values, point dropout drawing from the step's generator
DEVICE_FLAGS = ["--preset", "modelnet40", "--dataset", "modelnet",
                "--lr_decay_step", "1", "--bn_momentum_decay_step", "1",
                "--random_pc_dropout_lower_limit", "0.8",
                "--checkpoint_every", "10"]
# a budget that streams the 80 train clouds (19.3 MB) in chunks of 24
CHUNK_BUDGET_GB = "0.012"


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


def _digits(np, n, seed):
    """``n`` 28x28 uint8 images of the ten digit classes and their labels:
    each class a Lissajous stroke of its own, drawn bright with a random
    offset, scale and phase."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 10, n)
    t = np.linspace(0.0, 1.0, 160)[None]                       # (1, 160)
    fa, fb = (labels % 5 + 1)[:, None], (labels // 5 + 1)[:, None]
    phase = rs.uniform(0, np.pi, (n, 1))
    r = rs.uniform(6.0, 10.0, (n, 2))
    c = rs.uniform(12.0, 16.0, (n, 2))
    x = np.rint(c[:, :1] + r[:, :1] * np.sin(2 * np.pi * fa * t + phase))
    y = np.rint(c[:, 1:] + r[:, 1:] * np.sin(2 * np.pi * fb * t))
    img = np.zeros((n, 28, 28), np.uint8)
    rows = np.repeat(np.arange(n), t.shape[1])
    img[rows, np.clip(y, 0, 27).astype(int).ravel(),
        np.clip(x, 0, 27).astype(int).ravel()] = rs.randint(
            160, 256, rows.shape)
    return img, labels.astype(np.uint8)


def _mnist_ids(torch, np, dev):
    """Sorted node ids of ``config.mnist()``'s first pooling, (8, 1536):
    a real ``assign_topk`` (k=3) of 8 fabricated digits' 512-point clouds
    to their 5x5 nodes, fitted on the card."""
    from sonet_torch import som
    from sonet_torch.data.mnist import image_to_points
    from sonet_torch.ops import assign_topk
    img, _ = _digits(np, 8, seed=5)
    rng = np.random.default_rng(0)
    pc = torch.from_numpy(np.stack([image_to_points(i, 512, rng)
                                    for i in img])).to(dev)
    nodes = som.fit(pc, som.SOMConfig(5, 5, 2), device=dev)
    ids = assign_topk(pc, nodes, 3).min_idx
    return torch.sort(ids, dim=1).values.contiguous()


def phase_kernels():
    """Every kernel vs its plain version; returns their lines of the
    result."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, k, M = 8, 5000, 3, 64
    ids = _flagship_ids(torch, B, N, M, k, gen, dev)           # (8, 15000)
    ids_mnist = _mnist_ids(torch, np, dev)
    pool_ids = dict(zip(POOL_GRAD_SHAPES, (
        ids, _flagship_ids(torch, B, 1024, M, k, gen, dev), ids_mnist)))
    sums_ids = dict(zip(SUMS_SHAPES, (ids, pool_ids[POOL_GRAD_SHAPES[1]],
                                      ids_mnist, ids[:1].contiguous())))
    return [_check_segment_max_window(torch, gen, ids, M, ids_mnist),
            _check_segment_argmax(torch, gen, ids, M),
            *_check_batchnorm_act(torch, gen),
            _check_segment_max_grad(torch, gen, pool_ids),
            _check_segment_sums(torch, gen, sums_ids),
            _check_adam_step(torch), *_check_sorts(torch, gen)]


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


def _same_as_oracles(torch, got, data, seg, m) -> bool:
    """Kernel 1's output ``got`` against two more plain versions of its
    function, ``ops.segment_max_sorted`` (on the stably sorted points) and
    ``ops.segment_max_onehot``, each ``==`` on every occupied node whose
    maximum is finite.  Their empty nodes take point 0's feature where the
    kernel writes -3e38, and a node whose points are all -inf reads -3e38
    in the kernel (-inf and the one-hot's fill, -1e10, in theirs): there
    the kernel must read -3e38."""
    from sonet_torch.ops import (segment_counts, segment_max_onehot,
                                 segment_max_sorted, sort_by_segment)
    sids, _, _, sdata = sort_by_segment(seg, data)
    by_sorted = _plain_by_clouds(segment_max_sorted, sdata, sids, m).float()
    by_onehot = _plain_by_clouds(segment_max_onehot, data, seg, m).float()
    live = (segment_counts(seg, m) > 0)[..., None].expand_as(got)
    finite = live & torch.isfinite(by_sorted)
    return (bool((got[finite] == by_sorted[finite]).all())
            and bool((got[finite] == by_onehot[finite]).all())
            and bool((got[live & ~finite] == -3.0e38).all()))


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


def _check_segment_max_window(torch, gen, ids, M, ids_mnist):
    """Kernel 1 on the flagship inputs (bf16 and f32 at B=8, bf16 at B=64),
    the part segmenter's input (8, 3072, 384), the MNIST classifier's
    (8, 1536, 384) with M=25 (``ids_mnist``) and edge cases, each equal to
    the plain version and on the kernel its shape and alignment name; then
    timed."""
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
    # a rank of a (1, 2) mesh sorts its own half of the stacked points
    ids_half = _flagship_ids(torch, B, kN // 6, M, 3, gen, dev)  # (8, 7500)
    cases = [
        ("flagship bf16 sorted", rand((B, kN, C), torch.bfloat16), ids, M,
         "bulk"),
        ("flagship f32 sorted", rand((B, kN, C), torch.float32), ids, M,
         "bulk"),
        ("flagship B=64 bf16 sorted", rand((64, kN, C), torch.bfloat16),
         ids64, M, "bulk"),
        ("part segmenter bf16 sorted", rand((B, 3072, C), torch.bfloat16),
         ids_seg, M, "bulk"),
        ("MNIST classifier bf16 sorted, M=25",
         rand((B, 1536, C), torch.bfloat16), ids_mnist, 25, "bulk"),
        ("a rank of a (1, 2) mesh bf16 sorted",
         rand((B, kN // 2, C), torch.bfloat16), ids_half, M, "bulk"),
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
        oracles = _same_as_oracles(torch, got, data, seg, m)
        log(f"kernel segment_max_window [{name}] {tuple(data.shape)} M={m}, "
            f"{path} kernel: {'equal' if same else 'DIFFERENT'} (max abs err "
            f"{err}); to segment_max_sorted and segment_max_onehot: "
            f"{'equal' if oracles else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"segment_max_window differs from its plain "
                                 f"version on {name}")
        if not oracles:
            raise AssertionError(f"segment_max_window differs from "
                                 f"segment_max_sorted or segment_max_onehot "
                                 f"on {name}")

    data, data_f32, data64 = cases[0][1], cases[1][1], cases[2][1]
    t = _time_kernel1(torch, data, ids, M)
    t_f32 = _time_kernel1(torch, data_f32, ids, M)
    t_b64 = _time_kernel1(torch, data64, ids64, M)
    t_seg = _time_kernel1(torch, cases[3][1], ids_seg, M)
    t_mnist = _time_kernel1(torch, cases[4][1], ids_mnist, 25)
    # the bucketed artifact's smaller programs give kernel 1 the flagship
    # rows of 1, 2 and 4 clouds: equal to those rows of the B=8 call
    whole = windowed_vals(data, ids, M)
    t_buckets = {}
    for b in (1, 2, 4):
        part = windowed_vals(data[:b], ids[:b], M)
        if not bool((part == whole[:b]).all()):
            raise AssertionError(f"segment_max_window at B={b} differs from "
                                 f"the B=8 call's rows")
        t_buckets[b] = _time_kernel1(torch, data[:b], ids[:b], M)
    # the per-rank shapes of the mesh phases: a rank of (2, 1) holds 4
    # clouds (the B=4 rows above), a rank of (1, 2) half of each cloud's
    # stacked points; the rule-2 watch reads their share of the bound
    t_mesh = {"4x15000": t_buckets[4],
              "8x7500": _time_kernel1(torch, cases[5][1], ids_half, M)}
    for shape, tm in t_mesh.items():
        log(f"segment_max_window per rank of a mesh, {shape}: "
            f"{tm['bound_ms'] / tm['graph_ms']:.1%} of its bound by graph "
            f"replay")
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
            "seg_bound_ms": t_seg["bound_ms"],
            "mnist_ms": t_mnist["event_ms"],
            "mnist_graph_ms": t_mnist["graph_ms"],
            "mnist_main_device_ms": t_mnist["main_ms"],
            "mnist_bound_ms": t_mnist["bound_ms"],
            "bucket_graph_ms": {b: t["graph_ms"] for b, t in t_buckets.items()},
            "bucket_main_device_ms": {b: t["main_ms"]
                                      for b, t in t_buckets.items()},
            "bucket_bound_ms": {b: t["bound_ms"]
                                for b, t in t_buckets.items()},
            "mesh_rank_graph_ms": {s: t["graph_ms"]
                                   for s, t in t_mesh.items()},
            "mesh_rank_main_device_ms": {s: t["main_ms"]
                                         for s, t in t_mesh.items()},
            "mesh_rank_bound_ms": {s: t["bound_ms"]
                                   for s, t in t_mesh.items()}}


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



# node pooling's backward (B, N, C, M) on the main path: the classifier's
# and the autoencoder's first pooling over 8 x 15,000 stacked points, the
# segmenter's over 8 x 3,072, the MNIST classifier's over 8 x 1,536 nodes
POOL_GRAD_SHAPES = ((8, 15000, 384, 64), (8, 3072, 384, 64),
                    (8, 1536, 384, 25))


def pool_grad_inputs(torch, gen, data, ids, M, planted_ties=False):
    """The other inputs of node pooling's backward for ``data`` (B, N, C)
    and ``ids`` (B, N): the forward's maxima in data's type (kernel 1 on a
    card; an empty node takes point 0's row), the int32 counts and a
    cotangent in data's type.
    ``planted_ties`` first copies the row of each node's first point onto
    its second (in place, sorted ids), so that every channel of those
    nodes has an exact tie at its maximum or below it."""
    from sonet_torch.ops import segment_counts, segment_max_windowed
    if planted_ties:
        for b in range(ids.shape[0]):
            same = ids[b, 1:] == ids[b, :-1]
            first = torch.nonzero(same & torch.cat(
                [same.new_ones(1), ~same[:-1]]))[:, 0]
            data[b, first + 1] = data[b, first]
    counts = segment_counts(ids, M)
    out = segment_max_windowed(data, ids, M, counts)
    g = torch.randn(out.shape, generator=gen, device=data.device).to(
        data.dtype)
    return out, counts, g


def pool_grad_cases(torch, gen, dev):
    """Edge cases for node pooling's backward as (name, data, ids, out,
    counts, g, point0_idx, vector): ``vector`` is whether the kernels take
    16 bytes a thread there (``vector_path``)."""
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rand_ids(shape, lo, hi, sort=False):
        i = torch.randint(lo, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(i, dim=1).values.contiguous() if sort else i

    cases = []

    def add(name, data, ids, M, vector, point0=None, counts_dtype=None,
            g_dtype=None, ties=False):
        out, counts, g = pool_grad_inputs(torch, gen, data, ids, M, ties)
        if counts_dtype is not None:
            counts = counts.to(counts_dtype)
        if g_dtype is not None:
            g = rand(g.shape, g_dtype)
        cases.append((name, data, ids, out, counts, g, point0, vector))

    # nodes 3 and 14-19 empty; their cotangent goes to point0's row
    empty = rand_ids((2, 700), 0, 14, sort=True)
    empty[empty == 3] = 2
    empty = torch.sort(empty, dim=1).values.contiguous()
    p0 = torch.tensor([5, 611], device=dev)
    add("planted ties, bf16", rand((3, 999, 384), bf16),
        rand_ids((3, 999), 0, 16, sort=True), 16, True, ties=True)
    add("planted ties, f32", rand((3, 999, 384), f32),
        rand_ids((3, 999), 0, 16, sort=True), 16, True, ties=True)
    add("empty nodes, point0_idx int64, f32 counts, bf16",
        rand((2, 700, 384), bf16), empty, 20, True, point0=p0,
        counts_dtype=f32)
    add("empty nodes, point0_idx int32, f32 cotangent, bf16",
        rand((2, 700, 384), bf16), empty, 20, True,
        point0=p0.to(torch.int32), g_dtype=f32)
    add("empty nodes, no point0_idx, int64 counts, f32",
        rand((2, 700, 384), f32), empty, 20, True, counts_dtype=torch.int64)
    add("unsorted with ties, bf16", rand((2, 1000, 384), bf16),
        rand_ids((2, 1000), 0, 64), 64, True)
    add("ids outside [0, M) sorted, bf16", rand((2, 1000, 384), bf16),
        rand_ids((2, 1000), -3, 20, sort=True), 16, True)
    add("ids outside [0, M) unsorted, f32", rand((2, 1000, 384), f32),
        rand_ids((2, 1000), -3, 20), 16, True)
    add("ragged N=1001, one node a cloud, bf16", rand((3, 1001, 384), bf16),
        torch.full((3, 1001), 7, dtype=torch.int32, device=dev), 8, True)
    add("narrow rows C=64, bf16", rand((4, 999, 64), bf16),
        rand_ids((4, 999), 0, 16, sort=True), 16, True)
    add("wide rows C=2048, bf16", rand((2, 300, 2048), bf16),
        rand_ids((2, 300), 0, 16, sort=True), 16, True)
    add("odd C=33, f32", rand((3, 500, 33), f32),
        rand_ids((3, 500), 0, 16, sort=True), 16, False)
    flat = rand((2 * 500 * 384 + 1,), bf16)
    add("unaligned data view, bf16", flat[1:].view(2, 500, 384),
        rand_ids((2, 500), 0, 16, sort=True), 16, False)
    # zeros of both signs, and -inf at a node's maximum
    data = rand((2, 640, 384), bf16)
    seg = rand_ids((2, 640), 0, 8, sort=True)
    data[seg == 1] = float("-inf")
    data[seg == 2] = torch.where(rand((2, 640, 384), f32) > 0, 0.0, -0.0).to(
        bf16)[seg == 2]
    add("zeros of both signs and -inf, bf16", data, seg, 8, True)
    return cases


def pool_grad_mismatch(torch, got, want, counts, g, point0_idx):
    """Where the kernels' ``got`` leaves the plain version's ``want``: a
    list of what differs, empty if every row is ``==`` but the
    ``point0_idx`` rows of clouds with an empty node, which may differ by
    one rounding in the data's type of their value plus the float32
    reordering of the empty nodes' sum (M ulps of its terms' sizes)."""
    B, N, C = want.shape
    M = counts.shape[1]
    eps = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2.0 ** -23
    rows = torch.zeros((B, N), dtype=torch.bool, device=want.device)
    batch = torch.arange(B, device=want.device)
    p0 = (torch.zeros_like(batch) if point0_idx is None
          else point0_idx.long())
    empty = counts == 0
    rows[batch, p0] = empty.any(1)
    bad = []
    if got.shape != want.shape or got.dtype != want.dtype:
        return [f"got {tuple(got.shape)} {got.dtype}, want "
                f"{tuple(want.shape)} {want.dtype}"]
    if not torch.equal(got[~rows], want[~rows]):
        n = int((got[~rows] != want[~rows]).sum())
        bad.append(f"{n} elements off the point0 rows differ")
    if bool(rows.any()):
        size = torch.where(empty[..., None], g.float().abs(), 0.0).sum(1)
        a, w = got[rows].float(), want[rows].float()
        tol = eps * w.abs() + M * 2.0 ** -23 * size[rows.any(1)]
        if not bool(((a - w).abs() <= tol).all()):
            bad.append(f"point0 rows off by up to "
                       f"{float((a - w).abs().max()):.3g}")
    return bad

def _check_segment_max_grad(torch, gen, ids_by_shape):
    """Node pooling's backward (``csrc/segment_max_grad.cu``) against its
    plain version, ``route_max_grad_plain``, on the card: at each main-path
    shape in bf16 with node-sorted ids from a real top-k assignment
    (``ids_by_shape``) and unsorted ids, at the flagship in float32, and on
    the edge cases of ``pool_grad_cases``, each ``==`` but the point0 row
    of a cloud with an empty node (``pool_grad_mismatch``); then timed by
    graph replay beside its bound (each input byte read once, each output
    byte written once), its two kernels' device durations, and the plain
    chain's time by graph.  No PyTorch call computes this function, so
    there is no library time."""
    from sonet_torch.ops.cuda import segment_max_grad as smg
    from sonet_torch.ops.cuda.segment_max_grad import route_max_grad_plain
    dev = torch.device("cuda")
    row = {"name": "segment_max_grad", "route": "cuda",
           "source": "sonet_torch/csrc/segment_max_grad.cu",
           "replaces": "none (sonet_tpu/ops/segment.py route_max_grad's "
                       "one-hot products run on the MXU)",
           "launches": None, "library_ms": None, "shapes": {}}
    cases = []
    for shape in POOL_GRAD_SHAPES:
        B, N, C, M = shape
        ids = ids_by_shape[shape]
        for dtype in ((torch.bfloat16, torch.float32) if shape ==
                      POOL_GRAD_SHAPES[0] else (torch.bfloat16,)):
            data = torch.randn((B, N, C), generator=gen, device=dev).to(dtype)
            cases.append((f"{shape} {str(dtype).split('.')[-1]} sorted",
                          shape, data, ids))
        unsorted = ids[:, torch.randperm(N, generator=gen, device=dev)]
        cases.append((f"{shape} bfloat16 unsorted", shape,
                      torch.randn((B, N, C), generator=gen,
                                  device=dev).to(torch.bfloat16),
                      unsorted.contiguous()))
    for name, shape, data, ids in cases:
        out, counts, g = pool_grad_inputs(torch, gen, data, ids, shape[3])
        cases_in = (data, ids, out, counts, g, None)
        got = smg.segment_max_grad(*cases_in)
        torch.cuda.synchronize()
        bad = pool_grad_mismatch(torch, got, route_max_grad_plain(*cases_in),
                                 counts, g, None)
        log(f"segment_max_grad at {name}, M={shape[3]}, "
            f"{int((counts == 0).sum())} empty nodes: "
            f"{'equal' if not bad else bad}")
        if bad:
            raise AssertionError(f"segment_max_grad differs from its plain "
                                 f"version at {name}: {bad}")
    for name, data, ids, out, counts, g, p0, vector in pool_grad_cases(
            torch, gen, dev):
        if smg.vector_path(data) != vector:
            raise AssertionError(f"segment_max_grad [{name}]: not on the "
                                 f"path its shape names")
        got = smg.segment_max_grad(data, ids, out, counts, g, p0)
        torch.cuda.synchronize()
        bad = pool_grad_mismatch(torch, got, route_max_grad_plain(
            data, ids, out, counts, g, p0), counts, g, p0)
        log(f"segment_max_grad [{name}] {tuple(data.shape)}: "
            f"{'equal' if not bad else bad}")
        if bad:
            raise AssertionError(f"segment_max_grad differs from its plain "
                                 f"version on {name}: {bad}")

    for shape in POOL_GRAD_SHAPES:
        B, N, C, M = shape
        for dtype in ((torch.bfloat16, torch.float32) if shape ==
                      POOL_GRAD_SHAPES[0] else (torch.bfloat16,)):
            data = torch.randn((B, N, C), generator=gen, device=dev).to(dtype)
            args = (data, ids_by_shape[shape],
                    *pool_grad_inputs(torch, gen, data, ids_by_shape[shape],
                                      M))
            el = data.element_size()
            nbytes = 2 * B * N * C * el + B * N * 4 + 2 * B * M * C * el \
                + B * M * 4
            bound_ms, bound_by = _bound(nbytes, B * N * C)
            graph_ms = time_graph_ms(lambda: smg.segment_max_grad(*args),
                                     reps=20, inner=20)
            plain_ms = time_graph_ms(lambda: route_max_grad_plain(*args),
                                     reps=10, inner=5)
            dev_ms = device_times_ms(lambda: smg.segment_max_grad(*args), 20,
                                     "pool_grad_ties", "pool_grad_route")
            key = f"{B}x{N}x{C} M={M} {str(dtype).split('.')[-1]}"
            row["shapes"][key] = {
                "graph_ms": graph_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "nbytes": nbytes,
                "plain_graph_ms": plain_ms,
                "ties_ms": dev_ms["pool_grad_ties"],
                "route_ms": dev_ms["pool_grad_route"], "gap_ms": dev_ms["gap"]}
            log(f"segment_max_grad at {key}: {graph_ms:.4f} ms by graph "
                f"replay (the table's zeroing and both kernels), bound "
                f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
                f"{HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / graph_ms:.1%}; "
                f"device durations: ties {dev_ms['pool_grad_ties']:.4f} ms, "
                f"gap {dev_ms['gap']:.4f} ms, route "
                f"{dev_ms['pool_grad_route']:.4f} ms; the plain chain "
                f"{plain_ms:.4f} ms by graph")
    return row


# node recentering's segment sums (B, N, D, M) on the main path: the
# classifier's and the autoencoder's 8 x 15,000 stacked points, the
# segmenter's 8 x 3,072, the MNIST classifier's 8 x 1,536 2-D points on 25
# nodes, and a served request of one cloud of 15,000
SUMS_SHAPES = ((8, 15000, 3, 64), (8, 3072, 3, 64), (8, 1536, 2, 25),
               (1, 15000, 3, 64))
# the sums' tolerance against a float64 sum and against the plain version,
# a share of the sum of the absolute values they add: each adds a node's
# rows in float32, one rounding an add; on these random rows that stays
# far inside 1e-5 at every run length here (up to 15,000 rows)
SUMS_RTOL = 1e-5


def segment_sums_cases(torch, gen, dev):
    """Edge cases for the segment sums as (name, ids, x, M), the ids sorted
    in each cloud, as the kernel takes them."""
    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand_ids(shape, lo, hi):
        i = torch.randint(lo, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        return torch.sort(i, dim=1).values.contiguous()

    # nodes 3 and 14-19 empty
    empty = rand_ids((2, 700), 0, 14)
    empty[empty == 3] = 2
    one = torch.tensor([0, 31, 63], dtype=torch.int32, device=dev)
    cases = [("empty nodes", empty, rand((2, 700, 3)), 20),
             ("all rows on one node: the first, a middle, the last",
              one[:, None].expand(3, 15000).contiguous(),
              rand((3, 15000, 3)), 64),
             ("ids outside [0, M)", rand_ids((2, 1000), -3, 20),
              rand((2, 1000, 3)), 16),
             ("M=1", rand_ids((2, 500), 0, 1), rand((2, 500, 3)), 1),
             ("N=0", torch.zeros((2, 0), dtype=torch.int32, device=dev),
              rand((2, 0, 3)), 4),
             ("a node a row, every other node empty",
              (2 * torch.arange(30, dtype=torch.int32, device=dev))
              .expand(2, 30).contiguous(), rand((2, 30, 2)), 64)]
    # the search's rounds: a range of 128 ids or fewer is read whole
    for n in (1, 127, 128, 129, 257, 16385):
        cases.append((f"N={n}, D=2", rand_ids((2, n), 0, 8), rand((2, n, 2)),
                      8))
    return cases


def segment_sums_mismatch(torch, got, want, ids, x, M):
    """Where the kernel's (counts, sums) ``got`` leave the plain version's
    ``want``: a list of what differs, empty if the counts are ``==`` and
    each sum lies within ``SUMS_RTOL`` of the sum of the absolute values
    of its rows from a float64 sum and from the plain version's."""
    from sonet_torch.ops import one_hot
    (counts, sums), (want_counts, want_sums) = got, want
    if (counts.shape != want_counts.shape or sums.shape != want_sums.shape
            or counts.dtype != torch.float32 or sums.dtype != torch.float32):
        return [f"got {tuple(counts.shape)} {counts.dtype} and "
                f"{tuple(sums.shape)} {sums.dtype}, want "
                f"{tuple(want_counts.shape)} and {tuple(want_sums.shape)} "
                "float32"]
    onehot_t = one_hot(ids, M, torch.float64).transpose(1, 2)
    exact = torch.bmm(onehot_t, x.double())
    tol = SUMS_RTOL * torch.bmm(onehot_t, x.double().abs())
    bad = []
    if not torch.equal(counts, want_counts):
        bad.append(f"{int((counts != want_counts).sum())} counts differ")
    for name, ref in (("float64", exact), ("plain", want_sums.double())):
        off = (sums.double() - ref).abs() > tol
        if bool(off.any()):
            bad.append(f"{int(off.sum())} sums off the {name} sum, by up to "
                       f"{float((sums.double() - ref).abs().max()):.3g}")
    return bad


def _check_segment_sums(torch, gen, ids_by_shape):
    """Node recentering's segment sums (``csrc/segment_sums.cu``) against
    their plain version, ``segment_sums_plain``, and a float64 sum on the
    card (``segment_sums_mismatch``): at each main-path shape with sorted
    ids from a real top-k assignment (``ids_by_shape``), where the sums
    must also equal the plain version's (the card's one-hot product, which
    adds a node's rows in the same order at B >= 2) bit for bit, and on the
    edge cases of ``segment_sums_cases``, two calls giving the same bits; then
    timed by graph replay beside its bound (each input byte read once,
    each output byte written once), the plain version's time by graph and
    the float32 one-hot ``bmm`` it replaces in the step (``library_ms``,
    the one-hot made beforehand)."""
    from sonet_torch.ops import one_hot
    from sonet_torch.ops.cuda import segment_sums as ss
    dev = torch.device("cuda")
    row = {"name": "segment_sums", "route": "cuda",
           "source": "sonet_torch/csrc/segment_sums.cu",
           "replaces": "none (sonet_tpu/nn/encoder.py recenters the nodes "
                       "with one-hot products on the MXU)",
           "launches": None, "library_ms": None, "shapes": {}}
    cases = [(f"{shape}", ids_by_shape[shape],
              torch.randn(shape[:3], generator=gen, device=dev), shape[3])
             for shape in SUMS_SHAPES]
    for name, ids, x, M in cases + segment_sums_cases(torch, gen, dev):
        got = ss.segment_sums(ids, x, M)
        again = ss.segment_sums(ids, x, M)
        want = ss.segment_sums_plain(ids, x, M)
        torch.cuda.synchronize()
        bad = segment_sums_mismatch(torch, got, want, ids, x, M)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            bad.append("two calls differ")
        # at B = 1 cuBLAS picks another kernel, which adds in another order
        in_order = name in [c[0] for c in cases] and x.shape[0] > 1
        if in_order and not torch.equal(got[1], want[1]):
            bad.append(f"{int((got[1] != want[1]).sum())} sums not the "
                       "one-hot product's bits")
        log(f"segment_sums at {name} {tuple(x.shape)}, M={M}, "
            f"{int((got[0] == 0).sum())} empty nodes: "
            + (str(bad) if bad else "equal counts, sums " + (
                "equal" if torch.equal(got[1], want[1]) else
                "within tolerance")))
        if bad:
            raise AssertionError(f"segment_sums differs from its plain "
                                 f"version at {name}: {bad}")

    for shape in SUMS_SHAPES:
        B, N, D, M = shape
        ids = ids_by_shape[shape]
        x = torch.randn((B, N, D), generator=gen, device=dev)
        nbytes = B * N * D * 4 + B * N * 4 + B * M * 4 + B * M * D * 4
        bound_ms, bound_by = _bound(nbytes, B * N * D)
        graph_ms = time_graph_ms(lambda: ss.segment_sums(ids, x, M),
                                 reps=20, inner=20)
        plain_ms = time_graph_ms(lambda: ss.segment_sums_plain(ids, x, M),
                                 reps=10, inner=5)
        onehot_t = one_hot(ids, M, torch.float32).transpose(1, 2)
        library_ms = time_graph_ms(lambda: torch.bmm(onehot_t, x), reps=20,
                                   inner=20)
        key = f"{B}x{N}x{D} M={M}"
        row["shapes"][key] = {
            "graph_ms": graph_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "nbytes": nbytes, "plain_graph_ms": plain_ms,
            "library_ms": library_ms}
        if shape == SUMS_SHAPES[0]:
            row["library_ms"] = library_ms
        log(f"segment_sums at {key}: {graph_ms:.4f} ms by graph replay, "
            f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / graph_ms:.1%}; "
            f"the plain version {plain_ms:.4f} ms by graph; the float32 "
            f"one-hot bmm alone {library_ms:.4f} ms by graph")
    return row


# the cells' parameter sets, each updated by the Adam kernel
ADAM_PRESETS = ("modelnet40", "shapenetpart", "autoencoder", "mnist")
# the plain version on the card against the kernel, a parameter each
# step: an ulp of it and 1e-6 of the largest update, lr (1 - beta1) /
# sqrt(1 - beta2) (the plain version's per-tensor lerp and addcmul may
# round an fma otherwise than ATen's foreach functors)
ADAM_PLAIN_REL = 1e-6


def _adam_twins(torch, cfg, dev):
    """Three copies of ``cfg``'s parameters on the card, as a train step
    leaves them (``.grad`` None where the model gives none), each under a
    ``torch.optim.Adam`` of the port's two groups, the head's rate half the
    encoder's: the reference (``foreach=True, capturable=True``), the
    kernel's (``capturable``) and the plain version's.  Returns the
    [(params, optimizer)] and the names without gradient."""
    from sonet_torch.models import build_model
    from sonet_torch.train import make_optimizer
    model = build_model(cfg, device=dev, seed=0)
    stopped = _no_gradient(model, cfg)
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    sides = []
    for kw in (dict(foreach=True, capturable=True), dict(capturable=True),
               dict(capturable=True)):
        twin = build_model(cfg, device=dev, seed=0)
        twin.load_state_dict(model.state_dict())
        opt, _ = make_optimizer(twin, cfg, 100)
        for group in opt.param_groups:
            group.update(kw)
            group["lr"] = cfg.lr if group["name"] == "encoder" else cfg.lr / 2
        sides.append(([p for _, p in twin.named_parameters()], opt))
    return sides, [n for n, _ in named], stopped


def _adam_state(opt, p):
    st = opt.state.get(p, {})
    return [st[k] for k in ("exp_avg", "exp_avg_sq", "step") if k in st]


def _check_adam_step(torch):
    """Adam's update (``csrc/adam_step.cu`` through
    ``train.state.adam_update``) at each cell's parameter set
    (``ADAM_PRESETS``, the tensors without gradient left out as a train
    step leaves them): three steps against ``torch.optim.Adam(foreach=
    True, capturable=True)``, parameters, moments and counters ``==``, and
    against the plain version (``adam_step_plain``) on the card within
    ``ADAM_PLAIN_REL``; then timed by graph replay beside its bound (28
    bytes a parameter that has a gradient: p, g, m, v read, p, m, v
    written), the plain version's and the foreach Adam's times by graph,
    and its host time a call beside the foreach Adam's."""
    import numpy as np
    from sonet_torch import config
    from sonet_torch.ops.cuda import adam_step as adam
    from sonet_torch.train.state import adam_update
    dev = torch.device("cuda")
    row = {"name": "adam_step", "route": "cuda",
           "source": "sonet_torch/csrc/adam_step.cu",
           "replaces": "none (optax's Adam, fused by XLA on the TPU; the "
                       "port's torch.optim.Adam foreach chain on the card)",
           "launches": None, "library_ms": None, "shapes": {}}
    gen = torch.Generator(device=dev).manual_seed(4)
    for preset in ADAM_PRESETS:
        cfg = getattr(config, preset)()
        sides, names, stopped = _adam_twins(torch, cfg, dev)
        (ref_p, ref), (our_p, ours), (pl_p, plain) = sides
        live = [i for i, n in enumerate(names) if n not in stopped]
        def plain_step():
            args = [[], [], [], [], [], []]
            for group in plain.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    st = plain.state[p]
                    if not st:
                        st.update(step=torch.zeros((), device=dev),
                                  exp_avg=torch.zeros_like(p),
                                  exp_avg_sq=torch.zeros_like(p))
                    for a, t in zip(args, (p, p.grad, st["exp_avg"],
                                           st["exp_avg_sq"], st["step"],
                                           group["lr"])):
                        a.append(t)
            adam.adam_step_plain(*args, (0.9, 0.999), 1e-8)

        for _ in range(3):
            for i in live:
                g = torch.randn(ref_p[i].shape, generator=gen, device=dev) \
                    * 10.0 ** (i % 5 - 4)
                ref_p[i].grad, our_p[i].grad, pl_p[i].grad = g, g.clone(), \
                    g.clone()
            ref.step()
            adam_update(ours)
            plain_step()
        torch.cuda.synchronize()
        differ = [names[i] for i in range(len(names))
                  if not torch.equal(ref_p[i], our_p[i]) or not all(
                      torch.equal(a, b.to(a.device)) for a, b in zip(
                          _adam_state(ref, ref_p[i]),
                          _adam_state(ours, our_p[i])))]
        untouched = [names[i] for i in range(len(names)) if i not in live
                     and (our_p[i] in ours.state
                          or not torch.equal(our_p[i], pl_p[i]))]
        worst = 0.0
        for i in live:
            lr = cfg.lr if names[i].startswith("encoder.") else cfg.lr / 2
            want = our_p[i].detach().double()
            room = 3 * (torch.from_numpy(np.spacing(np.abs(
                want.cpu().numpy()).astype(np.float32))).to(dev).double()
                + ADAM_PLAIN_REL * lr * 0.1 / 0.001 ** 0.5)
            worst = max(worst, float(((pl_p[i].detach().double() - want)
                                      .abs() / room).max()))
        n_params = sum(our_p[i].numel() for i in live)
        log(f"adam_step at {preset}: {len(live)} of {len(names)} tensors "
            f"with a gradient, {n_params:,} parameters; 3 steps against the "
            f"capturable foreach Adam: {len(differ)} tensors differ "
            f"{differ[:4]}; the plain version's worst gap {worst:.3f} of its "
            f"room; tensors without gradient touched or given state: "
            f"{untouched}")
        if differ or untouched or worst > 1:
            raise AssertionError(f"adam_step at {preset}: differs from the "
                                 f"foreach Adam at {differ}, from the plain "
                                 f"version by {worst:.3f} of its room, "
                                 f"touched {untouched}")
        nbytes = 28 * n_params
        bound_ms, bound_by = _bound(nbytes, 15 * n_params)
        graph_ms = time_graph_ms(lambda: adam_update(ours), reps=20,
                                 inner=10)
        foreach_ms = time_graph_ms(ref.step, reps=20, inner=10)
        plain_ms = time_graph_ms(plain_step, reps=10, inner=5)
        host_us = host_us_per_call(lambda: adam_update(ours), calls=50)
        foreach_host_us = host_us_per_call(ref.step, calls=50)
        row["shapes"][preset] = {
            "tensors": len(live), "parameters": n_params,
            "graph_ms": graph_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "nbytes": nbytes, "plain_graph_ms": plain_ms,
            "library_ms": foreach_ms, "host_us_per_call": host_us,
            "library_host_us_per_call": foreach_host_us}
        if preset == ADAM_PRESETS[0]:
            row["library_ms"] = foreach_ms
        log(f"adam_step at {preset}: {graph_ms:.4f} ms by graph replay, "
            f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / graph_ms:.1%}; the "
            f"plain version {plain_ms:.4f} ms and the capturable foreach "
            f"Adam {foreach_ms:.4f} ms by graph; {host_us:.1f} us of host a "
            f"call (the foreach Adam {foreach_host_us:.1f})")
        del sides
        torch.cuda.empty_cache()
    return row


# the three sorts at every cell's shapes: (cells, B, raw points a cloud, N
# points kept, D, M nodes, k, som_k); the subsample runs only where raw > N
SORT_SHAPES = (("modelnet40", 8, 10000, 5000, 3, 64, 3, 9),
               ("shapenetpart, autoencoder", 8, 2048, 1024, 3, 64, 3, 9),
               ("mnist", 8, 512, 512, 2, 25, 3, 9))


def same_bits(torch, got, want) -> bool:
    """Whether two tensors have one shape, one dtype and the same bits (NaN
    equal to a NaN of its bits, -0.0 unequal to +0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.is_floating_point:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return bool(torch.equal(got, want))


def sort_inputs(torch, gen, dev, B, raw, N, D, M, k):
    """Realistic inputs of the three sorts at one cell's shapes: uniform
    subsample keys (B, raw), the squared distances (B, N, M) of random
    points to nodes drawn among them and (B, M, M) of the nodes to each
    other with the diagonal pinned at -1, and the node ids (B, kN) of the
    points' top-k assignment, unsorted as the encoder gives them."""
    from sonet_torch.ops import pairwise
    keys = torch.rand((B, raw), generator=gen, device=dev)
    pc = torch.randn((B, N, D), generator=gen, device=dev)
    pick = torch.randperm(N, generator=gen, device=dev)[:M]
    nodes = pc[:, pick] + 0.01 * torch.randn((B, M, D), generator=gen,
                                             device=dev)
    d_assign = pairwise.pairwise_sqdist(pc, nodes).contiguous()
    d_knn = pairwise.pairwise_sqdist(nodes, nodes).masked_fill(
        torch.eye(M, dtype=torch.bool, device=dev), -1.0).contiguous()
    idx = torch.sort(d_assign, dim=-1, stable=True).indices[..., :k]
    ids = idx.transpose(1, 2).reshape(B, k * N).to(torch.int32).contiguous()
    return keys, d_assign, d_knn, ids


def smallest_k_cases(torch, gen, dev):
    """Edge cases of the top-k selection as (name, d, k)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen,
                             device=dev).float()

    signed_zeros = torch.where(rand(64, 64) < 0.5, 0.0, -0.0)
    signed_zeros[:, ::7] = rand(64, 10)
    nan = ints(4, 64, 64)
    nan[rand(64, 64) < 0.3] = float("nan")
    nan[:, 5] = float("inf")
    nan[:, 9] = -float("inf")
    nan[3] = float("nan")                        # a row of NaN alone
    dup = torch.randn((8, 64, 3), generator=gen, device=dev)
    dup[:, 32:] = dup[:, :32]                    # every node twice
    from sonet_torch.ops import pairwise
    d_dup = pairwise.pairwise_sqdist(dup, dup).masked_fill(
        torch.eye(64, dtype=torch.bool, device=dev), -1.0).contiguous()
    cases = [("ties: 4 distinct values, k=3", ints(4, 8, 5000, 64), 3),
             ("ties: 3 distinct values, k=16", ints(3, 300, 64), 16),
             ("every value equal, k=16", torch.ones((50, 64), device=dev),
              16),
             ("-0.0 and +0.0, k=9", signed_zeros, 9),
             ("-0.0 and +0.0, k=3, M=25", signed_zeros[:, :25].contiguous(),
              3),
             ("NaN, inf and -inf, k=16", nan, 16),
             ("knn of doubled nodes: the diagonal at -1, ties, k=9", d_dup,
              9),
             ("k = L = 7", rand(5, 7), 7), ("L = 1", rand(9, 1), 1),
             ("4-d rows", rand(2, 3, 40, 25), 5),
             ("long rows", rand(3, 5000), 16),
             ("one row", rand(1, 64), 9)]
    for k in range(1, 17):
        cases.append((f"k={k} of 33", ints(9, 257, 33), k))
    return cases


def node_sort_cases(torch, gen, dev):
    """Edge cases of the node sort as (name, ids, M)."""
    def ids(B, L, lo, hi):
        return torch.randint(lo, hi, (B, L), generator=gen, device=dev,
                             dtype=torch.int32)

    one = torch.tensor([0, 31, 63], dtype=torch.int32, device=dev)
    empty = ids(2, 700, 0, 14)
    empty[empty == 3] = 2                         # nodes 3, 14-19 empty
    cases = [("all ids on one node: the first, a middle, the last",
              one[:, None].expand(3, 15000).contiguous(), 64),
             ("empty nodes", empty, 20), ("M=1", ids(2, 500, 0, 1), 1),
             ("M=1024", ids(4, 20000, 0, 1024), 1024),
             ("M=1024, few ids", ids(2, 100, 0, 1024), 1024),
             ("a node an id", torch.randperm(64, generator=gen, device=dev)
              .to(torch.int32).expand(2, 64).contiguous(), 64),
             ("sorted", torch.sort(ids(2, 3000, 0, 64), dim=1).values
              .contiguous(), 64),
             ("reversed", torch.sort(ids(2, 3000, 0, 64), dim=1,
                                     descending=True).values.contiguous(),
              64),
             ("long clouds", ids(2, 100000, 0, 64), 64),
             ("one cloud", ids(1, 15000, 0, 64), 64)]
    for L in (1, 31, 32, 33, 1024, 1025, 4097):
        cases.append((f"L={L}", ids(3, L, 0, 8), 8))
    return cases


def subset_select_cases(torch, gen, dev):
    """Edge cases of the subset selection as (name, keys, n)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    ties = torch.randint(0, 16, (4, 10000), generator=gen,
                         device=dev).float() / 16
    signed = torch.randn((4, 3000), generator=gen, device=dev)
    signed[:, ::3] = 0.0
    signed[:, 1::6] = -0.0
    nan = rand(2, 3000)
    nan[:, ::5] = float("nan")
    nan[:, 1::7] = float("inf")
    cases = [("ties: 16 values", ties, 5000),
             ("every key equal", torch.full((2, 10000), 0.5, device=dev),
              5000),
             ("zeros of both signs and negatives", signed, 3000),
             ("NaN and inf, every index", nan, 3000),
             ("n = 0", rand(2, 100), 0), ("n = 1", rand(2, 100), 1),
             ("n = L", rand(3, 777), 777),
             ("long rows", rand(2, 40000), 20000),
             ("keys crowding two buckets", 0.5 + rand(2, 3000) * 1e-3, 1500),
             ("descending", torch.sort(rand(2, 10000), dim=1,
                                       descending=True).values.contiguous(),
              5000)]
    for L in (1, 31, 32, 33, 1024, 1025, 2048, 4097):
        cases.append((f"L={L}", rand(3, L), (L + 1) // 2))
    return cases


def sorts_mismatch(torch, got, want):
    """The outputs of ``got`` that do not have the bits of ``want``'s, by
    position."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return [i for i, (a, b) in enumerate(zip(got, want))
            if not same_bits(torch, a, b)]


def sort_references(torch):
    """Per operator, the stable PyTorch sort its kernel must equal, run
    where the input lies: the op's plain version."""
    from sonet_torch.ops.cuda import sorts
    return {"node_sort": sorts.node_sort_plain,
            "smallest_k": sorts.smallest_k_plain,
            "subset_select": sorts.subset_select_plain}


def _check_sorts(torch, gen):
    """The three sort kernels (``csrc/sorts.cu``) against their plain
    versions, the stable ``torch.sort`` / ``argsort`` code they replace, run
    on the card: the same bits (``==``, NaN and signed zeros included) at
    every cell's shapes (``SORT_SHAPES``) on realistic inputs and on the
    edge cases of ``node_sort_cases``, ``smallest_k_cases`` and
    ``subset_select_cases``, two calls the same bits; then timed by graph
    replay beside its bound (each input byte read once, each output byte
    written once), the plain version's time by graph and ``torch.sort``'s
    alone (``library_ms``).  Returns one row a kernel."""
    from sonet_torch.ops.cuda import sorts
    dev = torch.device("cuda")
    plain = sort_references(torch)
    rows = {name: {"name": name, "route": "cuda",
                   "source": "sonet_torch/csrc/sorts.cu",
                   "replaces": "none (the JAX package leaves its sorts, "
                               "lax.top_k and argsort, to XLA)",
                   "launches": None, "library_ms": None, "shapes": {}}
            for name in plain}
    # (op, shape key, args, bytes, the torch.sort alone)
    timed = []
    for cells, B, raw, N, D, M, k, som_k in SORT_SHAPES:
        keys, d_assign, d_knn, ids = sort_inputs(torch, gen, dev, B, raw, N,
                                                 D, M, k)
        calls = [("smallest_k", f"{cells}: assign {tuple(d_assign.shape)} "
                  f"k={k}", (d_assign, k),
                  d_assign.numel() * 4 + d_assign[..., :k].numel() * 12,
                  lambda d=d_assign: torch.sort(d, dim=-1, stable=True)),
                 ("smallest_k", f"{cells}: knn {tuple(d_knn.shape)} "
                  f"k={som_k}", (d_knn, som_k),
                  d_knn.numel() * 4 + d_knn[..., :som_k].numel() * 12,
                  lambda d=d_knn: torch.sort(d, dim=-1, stable=True)),
                 ("node_sort", f"{cells}: {tuple(ids.shape)} M={M}",
                  (ids, M), ids.numel() * (4 + 4 + 8 + 8) + B * 8,
                  lambda i=ids: torch.sort(i, dim=1, stable=True))]
        if raw > N:
            calls.append(("subset_select", f"{cells}: {tuple(keys.shape)} "
                          f"n={N}", (keys, N), keys.numel() * 4 + B * N * 8,
                          lambda x=keys: torch.sort(x, dim=1, stable=True)))
        timed += calls
    cases = ([("node_sort", n, (i, m)) for n, i, m in node_sort_cases(
                 torch, gen, dev)]
             + [("smallest_k", n, (d, k)) for n, d, k in smallest_k_cases(
                 torch, gen, dev)]
             + [("subset_select", n, (x, m)) for n, x, m in
                subset_select_cases(torch, gen, dev)])
    bad = {}
    for op, name, args in [(o, n, a) for o, n, a, _, _ in timed] + cases:
        fn = getattr(sorts, op)
        got, again = fn(*args), fn(*args)
        want = plain[op](*args)
        torch.cuda.synchronize()
        off = sorts_mismatch(torch, got, want)
        if sorts_mismatch(torch, got, again):
            off.append("two calls differ")
        if off:
            bad[f"{op} at {name}"] = off
    log(f"the sorts at {len(timed)} main-path calls and {len(cases)} edge "
        f"cases: " + (f"differing {bad}" if bad else "every output equal "
                      "to the stable sort's, bit for bit"))
    if bad:
        raise AssertionError(f"a sort kernel differs from its plain "
                             f"version: {bad}")

    for op, key, args, nbytes, library in timed:
        fn = getattr(sorts, op)
        bound_ms, bound_by = _bound(nbytes, 0)
        graph_ms = time_graph_ms(lambda: fn(*args), reps=20, inner=20)
        plain_ms = time_graph_ms(lambda: plain[op](*args), reps=10, inner=5)
        library_ms = time_graph_ms(library, reps=10, inner=5)
        row = rows[op]
        row["shapes"][key] = {
            "graph_ms": graph_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "nbytes": nbytes, "plain_graph_ms": plain_ms,
            "library_ms": library_ms}
        if row["library_ms"] is None:
            row["library_ms"] = library_ms
        log(f"{op} at {key}: {graph_ms:.4f} ms by graph replay, bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.3f} MB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / graph_ms:.1%}; the "
            f"plain version {plain_ms:.4f} ms, torch.sort alone "
            f"{library_ms:.4f} ms by graph")
    return list(rows.values())


# the fused BatchNorm's (rows, width) on the main path: the first
# PointNet over 8 x 15,000 stacked points, the segmenter head's first
# layer over 24,576, the kNN layer's 4,608 (two-pass) and a head's rank 2
BATCHNORM_SHAPES = ((120000, 64), (120000, 128), (120000, 256),
                    (24576, 1024), (4608, 512), (8, 512))
BATCHNORM_MODES = ("train", "eval", "backward")


class _BatchNormCounter:
    """One mode of ``batchnorm_act.launches`` read and reset as a kernel
    counter's ``launches``."""

    def __init__(self, mode):
        self.mode = mode

    @property
    def launches(self):
        from sonet_torch.ops.cuda import batchnorm_act
        return batchnorm_act.launches[self.mode]

    @launches.setter
    def launches(self, n):
        from sonet_torch.ops.cuda import batchnorm_act
        batchnorm_act.launches[self.mode] = n


def batchnorm_counters():
    """The fused BatchNorm's launch counters by mode, named as its rows."""
    return {f"batchnorm_act.{m}": _BatchNormCounter(m)
            for m in BATCHNORM_MODES}


def _check_batchnorm_act(torch, gen):
    """The fused BatchNorm kernels (``csrc/batchnorm_act.cu``) in bf16 at
    each main-path shape: train forward, eval forward and backward, each
    against its plain version run on the card (the plain chain's rounding
    points: a train forward within one bf16 step an element, as its sums
    run in another order; an eval forward ``==``; a backward within 2e-2
    of its largest entry), then timed by graph replay beside its bound
    (bytes read once and written once: 4 bytes an element forward, 6
    backward), the plain version's time and the library's
    (``F.batch_norm`` and ``relu``, which the port never calls).  Returns
    one row a mode, its shapes inside."""
    import torch.nn.functional as F
    from sonet_torch.ops.cuda import batchnorm_act as bna
    dev = torch.device("cuda")
    rows = {m: {"name": f"batchnorm_act.{m}", "route": "cuda",
                "source": "sonet_torch/csrc/batchnorm_act.cu",
                "replaces": "none (sonet_tpu/nn/layers.py:52 BatchNorm is "
                            "left to XLA's fusion on the TPU)",
                "launches": None, "shapes": {}} for m in BATCHNORM_MODES}
    ops = torch.ops.sonet_torch
    for R, C in BATCHNORM_SHAPES:
        y = (torch.randn((R, C), generator=gen, device=dev) * 2
             + 0.3).bfloat16()
        b = torch.randn(C, generator=gen, device=dev).bfloat16()
        g = torch.randn((R, C), generator=gen, device=dev).bfloat16()
        w = torch.rand(C, generator=gen, device=dev) + 0.5
        beta = torch.rand(C, generator=gen, device=dev) - 0.5
        rm = torch.randn(C, generator=gen, device=dev) * 0.1 + 0.3
        rv = torch.rand(C, generator=gen, device=dev) + 3.0
        out, mean, var = bna.batchnorm_act_train(y, b, w, beta, 1e-5, True)
        want, want_mean, want_var = bna.batchnorm_act_train_plain(
            y, b, w, beta, 1e-5, True)
        train_err = float((out.float() - want.float()).abs().max())
        stat_err = max(float((mean - want_mean).abs().max()),
                       float((var - want_var).abs().max()))
        one_step = bool(((out.float() - want.float()).abs()
                         <= 2 ** -7 * want.float().abs() + 1e-4).all())
        ev = bna.batchnorm_act_eval(y, b, w, beta, rm, rv, 1e-5, True)
        ev_same = torch.equal(ev, bna.batchnorm_act_eval_plain(
            y, b, w, beta, rm, rv, 1e-5, True))
        back = ops.batchnorm_act_backward(g, y, b, w, beta, mean, var, 1e-5,
                                          True, True, ["data"])
        back_want = bna.batchnorm_act_backward_plain(
            g, y, b, w, beta, mean, var, 1e-5, True, True)
        back_err = max(float((a.float() - c.float()).abs().max())
                       / float(c.float().abs().max())
                       for a, c in zip(back, back_want))
        torch.cuda.synchronize()
        log(f"batchnorm_act at ({R}, {C}) bf16: train forward within "
            f"{train_err:.3g} of the plain chain (one bf16 step an element: "
            f"{one_step}), statistics within {stat_err:.3g}; eval forward "
            f"== {ev_same}; backward within {back_err:.3g} of the largest")
        if not (one_step and ev_same and back_err <= 2e-2
                and stat_err <= 1e-5 * float(want_var.max())):
            raise AssertionError(f"batchnorm_act at ({R}, {C}) differs from "
                                 "its plain version")
        el = R * C * 2
        fns = {
            "train": (lambda: bna.batchnorm_act_train(y, b, w, beta, 1e-5,
                                                      True),
                      lambda: bna.batchnorm_act_train_plain(
                          y, b, w, beta, 1e-5, True), 2 * el),
            "eval": (lambda: bna.batchnorm_act_eval(y, b, w, beta, rm, rv,
                                                    1e-5, True),
                     lambda: bna.batchnorm_act_eval_plain(
                         y, b, w, beta, rm, rv, 1e-5, True), 2 * el),
            "backward": (lambda: ops.batchnorm_act_backward(
                g, y, b, w, beta, mean, var, 1e-5, True, True, ["data"]),
                lambda: bna.batchnorm_act_backward_plain(
                    g, y, b, w, beta, mean, var, 1e-5, True, True), 3 * el),
        }
        h = (y + b).requires_grad_()

        def library(train):
            return F.relu(F.batch_norm(h, None if train else rm,
                                       None if train else rv, w, beta,
                                       train, 0.0, 1e-5))
        lib_fwd = {"train": time_ms(lambda: library(True), reps=20, inner=10),
                   "eval": time_ms(lambda: library(False), reps=20, inner=10)}
        lib_out = library(True)
        lib_fwd["backward"] = time_ms(lambda: torch.autograd.grad(
            lib_out, (h,), g, retain_graph=True), reps=20, inner=10)
        for m, (kernel, plain, nbytes) in fns.items():
            bound_ms, bound_by = _bound(nbytes, 0)
            graph_ms = time_graph_ms(kernel, reps=20, inner=20)
            plain_ms = time_graph_ms(plain, reps=20, inner=5)
            rows[m]["shapes"][f"{R}x{C}"] = {
                "graph_ms": graph_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "plain_graph_ms": plain_ms,
                "library_ms": lib_fwd[m],
                "max_abs_err": {"train": train_err, "eval": 0.0,
                                "backward": back_err}[m]}
            log(f"batchnorm_act.{m} at ({R}, {C}) bf16: {graph_ms:.4f} ms by "
                f"graph replay, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB"
                f" at {HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / graph_ms:.1%}"
                f"; plain {plain_ms:.4f} ms by graph; F.batch_norm + relu "
                f"{lib_fwd[m]:.4f} ms by events")
    return [rows[m] for m in BATCHNORM_MODES]


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
    part segmenter or the Chamfer autoencoder) on the card through the
    captured engine; returns (the launches of every kernel from the
    engine's warm-up on, the graph replays of the served requests).  The
    warm-up captures the forward (kernel 1 launched by its warm-up step
    and its capture, at the main path's shape); every request replays
    the graph once a chunk of B, and the captured forward is held against
    the eager ``build_serve_fn`` on the same inputs.  Every BatchNorm the
    forward runs takes the fused eval kernel once in the warm-up step and
    once in the capture.  ``small`` is the float32 configuration held
    against the CPU."""
    import numpy as np
    import torch
    from sonet_torch.models import build_model
    from sonet_torch.serving import ServingEngine, build_serve_fn

    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0)
    engine = ServingEngine.from_model(model, cfg, device="cuda")
    names = engine.input_names
    B = engine.batch_size
    log(f"serving {_describe(cfg)}, inputs {names}, "
        f"pooling={engine.manifest['pooling']}")
    record, shapes = _kernel1_shapes()
    _reset(kernel_counters)
    norms = []
    with record(), _batchnorm_calls(norms):
        engine.warmup()
    clouds = _clouds(np, 13, cfg, seed=1)
    inputs = {n: clouds[n] for n in names}
    # every task's forward pools the k * N stacked points of 384 channels
    # onto its M nodes: (8, 15000, 384, 64) for the classifier, (8, 3072,
    # 384, 64) for the segmenter and the autoencoder; kernel 1 is called
    # by the warm-up step and by the capture, and by nothing else
    want_shape = {(B, cfg.k * cfg.input_pc_num, 384, cfg.node_num): 2}
    warm = _launch_counts(kernel_counters)
    log(f"warm-up: {engine.graph.captures} capture, kernel 1 by (B, N, C, "
        f"M) {shapes}, launches {warm}")
    if (engine.graph.captures != 1 or shapes != want_shape
            or any(warm[n] != 2 for n in on_path)):
        raise AssertionError(f"the warm-up did not capture kernel 1 in the "
                             f"forward at {want_shape}: {shapes}, {warm}")
    if warm["segment_max_grad"] or warm["adam_step"]:
        raise AssertionError(f"the served forward ran pooling's backward or "
                             f"Adam's update: {warm}")
    _check_batchnorm_calls(norms, warm, 2, _served_norms(model, cfg),
                           "serving warm-up")

    outputs = {}
    replays = 0
    for b in (1, 8, 13):
        before = {n: c.launches for n, c in kernel_counters.items()}
        r0 = engine.graph.replays
        out = engine.predict({n: a[:b] for n, a in inputs.items()})
        torch.cuda.synchronize()
        grew = {n: c.launches - before[n] for n, c in kernel_counters.items()}
        replayed = engine.graph.replays - r0
        replays += replayed
        log(f"request B'={b}: scores {out.shape}, finite "
            f"{bool(np.isfinite(out).all())}, graph replays {replayed}, "
            f"kernel launches {grew}")
        if out.shape != _score_shape(cfg, b) or not np.isfinite(out).all():
            raise AssertionError(f"bad scores for B'={b}: {out.shape}")
        if replayed != -(-b // B) or any(grew.values()):
            raise AssertionError(f"B'={b}: want {-(-b // B)} replays and no "
                                 f"launch, got {replayed} and {grew}")
        outputs[b] = out
    launches = _launch_counts(kernel_counters)
    log(f"served: {engine.stats()}; launches {launches}, replays {replays}")

    # the captured forward against the eager one on the same inputs
    serve = build_serve_fn(model, cfg)       # eval mode, as built
    dev_in = [torch.from_numpy(inputs[n][:8]).cuda() for n in names]
    eager = serve(*dev_in).float().cpu().numpy()
    diff = float(np.abs(eager - outputs[8]).max())
    scale = max(1.0, float(np.abs(eager).max()))
    log(f"captured vs eager forward: max abs diff {diff} (bit-equal "
        f"{bool(np.array_equal(eager, outputs[8]))}; tolerance {LOGIT_RTOL} "
        f"x {scale})")
    if diff > LOGIT_RTOL * scale:
        raise AssertionError("the captured forward disagrees with the eager")

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

    def replay():
        engine.graph(*dev_in)

    req8 = {n: a[:8] for n, a in inputs.items()}

    def request():
        t = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.predict(req8)
            t.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(t)

    # eager and captured in turns: eager, captured, captured, eager
    fwd_ms, rep_ms = [time_ms(forward, reps=20)], [time_ms(replay, reps=20)]
    rep_ms.append(time_ms(replay, reps=20))
    fwd_ms.append(time_ms(forward, reps=20))
    req_ms = request()
    _, dev_fwd, rows_fwd = _busy_share(lambda: [forward() for _ in range(5)])
    _, dev_rep, rows_rep = _busy_share(lambda: [replay() for _ in range(5)])
    log(f"{cfg.task} B=8 forward on the card by events, eager then captured "
        f"in turns: eager {fwd_ms} ms, captured (a copy of the inputs and "
        f"one replay) {rep_ms} ms; device time under torch.profiler a "
        f"call: eager {dev_fwd * 1e3 / 5:.4f} ms in {rows_fwd // 5} device "
        f"rows, captured {dev_rep * 1e3 / 5:.4f} ms in {rows_rep // 5} "
        f"rows; B'=8 request through ServingEngine (host arrays in and "
        f"out, one replay): {req_ms:.4f} ms ({8 / req_ms * 1e3:.1f} "
        f"clouds/s); peak memory "
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
    return launches, replays


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
    kernel named in ``on_path`` must launch once per step, and every
    BatchNorm takes the fused kernels once a step forward and, where it
    runs with a gradient, once backward.  ``small`` is the float32
    configuration whose train step is held against the CPU."""
    import numpy as np
    import torch
    from sonet_torch import train
    from sonet_torch.models import build_model
    from sonet_torch.nn.encoder import resolve_pooling
    from sonet_torch.nn.layers import BatchNorm

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
    losses, norms = [], []
    for i in range(TRAIN_STEPS):
        with _batchnorm_calls(norms):
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
    for n in (*on_path, "segment_max_grad", "adam_step"):
        if launches[n] != TRAIN_STEPS:
            raise AssertionError(f"{n} launched {launches[n]} times in "
                                 f"{TRAIN_STEPS} train steps, want one a step")
    # the top-k selection: the assignment's and the nodes' kNN a step
    if (launches["smallest_k"], launches["subset_select"]) != (
            2 * TRAIN_STEPS, 0):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched the top-k "
                             f"selection {launches['smallest_k']} times and "
                             f"the subsample {launches['subset_select']}, "
                             f"want {2 * TRAIN_STEPS} and 0")
    _check_batchnorm_calls(norms, launches, TRAIN_STEPS,
                           [n for n, m in model.named_modules()
                            if isinstance(m, BatchNorm)],
                           f"{TRAIN_STEPS} train steps", model)
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    wall, busy, rows = _busy_share(lambda: [step() for _ in range(5)])
    if profile_dir:
        profile_run(step, profile_dir, f"train_step_{cfg.task}")
    # the same step captured, as the Trainer runs it on a card (Adam
    # capturable while the graph lives; the checkpoint is written eager)
    from sonet_torch.train.graphs import StepGraph
    from sonet_torch.train.state import set_capturable
    set_capturable(state.optimizer, True)
    names = tuple(batches[0])
    graph = StepGraph(
        lambda *t: train_step(state, dict(zip(names, t)), gen)[1], dev,
        generators=(gen,))

    def replay():
        graph(*batches[0].values())

    replay_ms = time_ms(replay, reps=20)
    rwall, rbusy, rrows = _busy_share(lambda: [replay() for _ in range(5)])
    graph.reset()
    del graph
    set_capturable(state.optimizer, False)
    log(f"{cfg.task} B=8 train step on the card by events: eager "
        f"{step_ms:.4f} ms ({B / step_ms * 1e3:.1f} clouds/s), captured "
        f"{replay_ms:.4f} ms ({B / replay_ms * 1e3:.1f} clouds/s); under "
        f"torch.profiler a step: eager {busy * 1e3 / 5:.4f} ms of device "
        f"time in {rows // 5} rows, busy {busy / wall:.1%}; captured "
        f"{rbusy * 1e3 / 5:.4f} ms in {rrows // 5} rows, busy "
        f"{rbusy / rwall:.1%}; peak memory {peak:.0f} MiB")
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


def _check_selections(path, launches):
    """Every encoder forward on the card takes the top-k selection at least
    once (the assignment; the nodes' kNN, the SOM's fits and the scatter
    path's checks add more): raises if ``path`` launched it fewer times
    than kernel 1."""
    if launches["smallest_k"] < launches["segment_max_window"]:
        raise AssertionError(f"path {path}: the top-k selection launched "
                             f"{launches['smallest_k']} times, kernel 1 "
                             f"{launches['segment_max_window']}")


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
    time with the loader in, each train step and eval batch one replay of
    a captured graph.  Then a ``Trainer`` on that run: the resume, the
    eval by hand, the card's busy share over an epoch, a graceful stop and
    a resume bit for bit, ``ServingEngine.from_run``, a captured train
    step against the eager one from the same state, batch and generator
    (``CAPTURED_RTOL``), ``evaluate()`` twice to the same bits.  Returns
    (the launches of every kernel in the command's run, its replays)."""
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
    record, shapes = _kernel1_shapes()
    _reset(kernel_counters)
    with _GraphCounter() as graphs, record():
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
        f"checkpoint {ckpt}; {graphs.captures} captures, {graphs.replays} "
        f"replays; kernel launches {launches} (warm-ups and captures) by "
        f"(B, N, C, M) {shapes}")
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
    # a warm-up and a capture of the train step and of the eval step
    if ((graphs.captures, graphs.replays) != (2, steps + n_eval)
            or shapes != {(B, 15000, 384, 64): 4}):
        raise AssertionError(f"want 2 captures, {steps + n_eval} replays "
                             f"and kernel 1 at (8, 15000, 384, 64) only")
    for n in on_path:
        if launches[n] != 4:
            raise AssertionError(f"{n} launched {launches[n]} times")
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

    eager, graph, rel = captured_and_eager_host_step(
        trainer, next(iter(trainer.train_loader)))
    log(f"a host-pipeline step, eager vs captured from the same state, "
        f"batch and generator: loss {eager} vs {graph}, updates {rel:.3e} "
        f"apart (bit-equal {rel == 0.0}; tolerance {CAPTURED_RTOL})")
    if (abs(eager - graph) > CAPTURED_RTOL * abs(eager)
            or not rel <= CAPTURED_RTOL):
        raise AssertionError("the captured host step is not the eager step")
    ev = [trainer.evaluate() for _ in range(2)]
    log(f"evaluate() twice through the captured eval step: {ev[0]} and "
        f"{ev[1]}")
    if ev[0] != ev[1]:
        raise AssertionError("the captured eval is not reproducible")
    return launches, graphs.replays


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
    card, and that ranking against the CPU's; metrics.  The train and eval
    steps and ``extract_scores``'s eval step are captured graphs, replayed
    once a batch.  Returns (the launches of every kernel in the two
    commands' runs, their replays)."""
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
    with _GraphCounter() as graphs:
        _cli(["classify", "--device", "cuda", "--epochs", "1",
              "--checkpoints_dir", runs, "--name", "retrieve"] + data)
        ckpt = train.latest_checkpoint(os.path.join(run, "ckpt"))
        if ckpt is None:
            raise AssertionError("sonet-torch classify left no checkpoint")
        retrieve_s = _cli(["retrieve", "--device", "cuda", "--checkpoint",
                           ckpt, "--output_dir", out] + data)
    launches = _launch_counts(kernel_counters)
    n_batches = -(-55 // cfg.batch_size)
    want_replays = 110 // cfg.batch_size + 2 * n_batches
    log(f"sonet-torch retrieve took {retrieve_s:.3f} s; in both commands "
        f"{graphs.captures} captures, {graphs.replays} replays, kernel "
        f"launches {launches}")
    # classify: the train and the eval step; retrieve: its eval step
    if (graphs.captures, graphs.replays) != (3, want_replays):
        raise AssertionError(f"want 3 captures and {want_replays} replays")
    for n in on_path:
        if launches[n] != 6:
            raise AssertionError(f"{n} launched {launches[n]} times, want "
                                 f"a warm-up and a capture of 3 steps")

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
    # the command scores epoch 1's point draws, as sonet retrieve does
    loader.skip_epoch()
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
    return launches, graphs.replays


class _Tee:
    """A text stream that writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        import io
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _cli_output(argv):
    """(exit code, standard output) of ``sonet-torch <argv>`` run in this
    process; its output is shown as it comes."""
    import contextlib
    import torch
    from sonet_torch import cli
    log(f"sonet-torch {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, tee.copy.getvalue()


def _superellipsoid_obj(np, path, e1, e2, axes, turn, nu=24, nv=48):
    """A superellipsoid mesh as a Wavefront .obj of quads: latitude
    exponent ``e1``, longitude exponent ``e2``, semi-axes ``axes``, turned
    by ``turn`` radians about the vertical axis."""
    def spow(x, e):
        return np.sign(x) * np.abs(x) ** e
    th = np.linspace(-np.pi / 2, np.pi / 2, nu)[:, None]
    ph = np.linspace(-np.pi, np.pi, nv, endpoint=False)[None]
    x = axes[0] * spow(np.cos(th), e1) * spow(np.cos(ph), e2)
    y = axes[1] * spow(np.cos(th), e1) * spow(np.sin(ph), e2)
    z = np.broadcast_to(axes[2] * spow(np.sin(th), e1), x.shape)
    c, s_ = np.cos(turn), np.sin(turn)
    v = np.stack([c * x - s_ * y, s_ * x + c * y, z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = i * nv + (j + 1) % nv
    quads = np.stack([a, b, b + nv, a + nv], -1).reshape(-1, 4) + 1
    with open(path, "w") as f:
        f.write("".join(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in v))
        f.write("".join(f"f {q[0]} {q[1]} {q[2]} {q[3]}\n" for q in quads))


def _modelnet_archive(np, root, classes=40, shapes=3):
    """A ModelNet40 archive as a user meets one: 40 classes of
    superellipsoids (8 pairs of exponents x 5 sets of semi-axes), 3 meshes
    a class and one more in the first, sampled by ``sonet-torch prep
    sample`` at 10,000 points with normals, packed in the ModelNet layout
    (``<class>/<name>.npy`` of (10000, 6); split lists of 2 train shapes a
    class and the rest for test: 80 and 41, so that a test split in
    batches of 8 ends in a padded batch) as a ``.tar.gz``.  Returns its
    path."""
    import tarfile
    rs = np.random.RandomState(7)
    exps = [(0.3, 0.3), (0.3, 1.0), (1.0, 0.3), (1.0, 1.0), (1.0, 2.0),
            (2.0, 1.0), (2.0, 2.0), (0.6, 1.6)]
    ratios = [(1.0, 1.0, 1.0), (1.0, 0.5, 0.5), (0.5, 0.5, 1.0),
              (1.0, 0.7, 0.3), (0.4, 1.0, 0.8)]
    meshes, tree = os.path.join(root, "meshes"), os.path.join(root, "tree")
    names = [f"shape{c:02d}" for c in range(classes)]
    counts = [shapes + (c == 0) for c in range(classes)]
    for c, cls in enumerate(names):
        os.makedirs(os.path.join(meshes, cls))
        e1, e2 = exps[c % 8]
        for j in range(counts[c]):
            axes = np.asarray(ratios[c // 8]) * rs.uniform(0.9, 1.1, 3)
            _superellipsoid_obj(np, os.path.join(
                meshes, cls, f"{cls}_{j + 1:04d}.obj"), e1, e2, axes,
                rs.uniform(0, 2 * np.pi))
    sampled = os.path.join(root, "sampled")
    rc, _ = _cli_output(["prep", "sample", "--root", meshes, "--out",
                         sampled, "--points", "10000", "--normalize"])
    if rc:
        raise AssertionError(f"sonet-torch prep sample exited with {rc}")
    splits = {"train": [], "test": []}
    for cls, count in zip(names, counts):
        os.makedirs(os.path.join(tree, cls))
        for j in range(count):
            name = f"{cls}_{j + 1:04d}"
            with np.load(os.path.join(sampled, cls, name + ".npz")) as z:
                pc, sn = z["pc"], z["sn"]
            if pc.shape != (10000, 3) or not np.isfinite(pc).all():
                raise AssertionError(f"prep sample: bad cloud {pc.shape}")
            np.save(os.path.join(tree, cls, name + ".npy"),
                    np.concatenate([pc, sn], 1).astype(np.float32))
            splits["test" if j >= shapes - 1 else "train"].append(name)
    with open(os.path.join(tree, f"modelnet{classes}_shape_names.txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")
    for mode, entries in splits.items():
        with open(os.path.join(tree, f"modelnet{classes}_{mode}.txt"),
                  "w") as f:
            f.write("\n".join(entries) + "\n")
    path = os.path.join(root, "modelnet40.tar.gz")
    with tarfile.open(path, "w:gz") as t:
        t.add(tree, arcname="modelnet40")
    return path


def _verdict(out):
    lines = [ln for ln in out.splitlines() if ln.startswith('{"reproduce"')]
    if len(lines) != 1:
        raise AssertionError("sonet-torch reproduce printed no verdict")
    return json.loads(lines[0])


def phase_reproduce(kernel_counters, on_path, runs):
    """A published-archive reproduction as a user runs it: 40 classes of
    meshes sampled by ``sonet-torch prep sample`` and packed as a ModelNet40
    archive (80 train, 41 test shapes); ``sonet-torch reproduce --preset
    modelnet40`` ingests it, fits its SOM nodes on the card (``prep som``,
    batches of 64 clouds of 4096 points), checks the tree, trains one
    epoch at B=8, N=5000 (captured steps, one replay a batch) and prints
    the verdict, below the 0.918 gate (rc 1); the same command again
    reuses the tree and the run.  Returns (the first command's kernel
    launches, its replays, the run directory)."""
    import numpy as np
    import torch
    from sonet_torch import som

    root = os.path.join(runs, "reproduce_data")
    os.makedirs(root)
    t0 = time.perf_counter()
    arch = _modelnet_archive(np, root)
    log(f"reproduce: 40 x 3 + 1 superellipsoid meshes sampled and packed in "
        f"{time.perf_counter() - t0:.3f} s ({os.path.getsize(arch) / 1e6:.1f} "
        f"MB archive)")
    dest = os.path.join(root, "modelnet40")
    argv = ["reproduce", "--preset", "modelnet40", "--archive", arch,
            "--dest", dest, "--epochs", "1", "--checkpoint_every", "1",
            "--checkpoints_dir", runs, "--name", "reproduce",
            "--device", "cuda"]
    _reset(kernel_counters)
    t0 = time.perf_counter()
    with _GraphCounter() as graphs:
        rc, out = _cli_output(argv)
    took = time.perf_counter() - t0
    launches = _launch_counts(kernel_counters)
    v = _verdict(out)
    log(f"sonet-torch reproduce took {took:.3f} s (ingest, prep som, check, "
        f"one epoch, its eval): rc {rc}, verdict {v}; {graphs.captures} "
        f"captures, {graphs.replays} replays; kernel launches {launches}")
    nodes = os.path.join(dest, "8x8_som_nodes")
    n_nodes = sum(len(f) for _, _, f in os.walk(nodes))
    if (rc != 1 or v["pass"] is not False or v["gate"] != 0.918
            or v["metric"] != "accuracy" or not 0.0 <= v["best"] <= 0.918
            or n_nodes != 121 or "fitting 8x8 SOM nodes" not in out
            or '"ok": true' not in out):
        raise AssertionError("sonet-torch reproduce: want the whole chain, "
                             "a verdict below the gate and rc 1")
    if (graphs.captures, graphs.replays) != (2, 10 + 6):
        raise AssertionError("want 2 captures and a replay for each of 10 "
                             "steps and 6 eval batches")
    for n in on_path:
        if launches[n] != 4:
            raise AssertionError(f"{n} launched {launches[n]} times")
    rc2, out2 = _cli_output(argv)
    v2 = _verdict(out2)
    log(f"again: rc {rc2}, best {v2['best']} (first run {v['best']})")
    if (rc2 != 1 or "reusing ingested tree" not in out2
            or "1/1 epochs already trained" not in out2
            or "fitting" in out2 or v2["best"] != v["best"]):
        raise AssertionError("sonet-torch reproduce: the second run did not "
                             "resume the first")

    # prep som's fit alone, at its batch: 64 clouds of 4096 points
    import glob
    rng = np.random.default_rng(0)
    files = sorted(glob.glob(os.path.join(dest, "shape*", "*.npy")))[:64]
    x = torch.from_numpy(np.stack([
        np.load(f)[rng.choice(10000, 4096, replace=False), :3]
        for f in files])).cuda()
    cfg = som.SOMConfig(8, 8, 3)
    fit_ms = time_ms(lambda: som.fit(x, cfg, device="cuda"), reps=5)
    log(f"prep som's fit of {len(x)} clouds of 4096 points on the card: "
        f"{fit_ms:.4f} ms ({len(x) / fit_ms * 1e3:.1f} clouds/s)")
    return launches, graphs.replays, os.path.join(runs, "reproduce")


def _timed_clouds(items, batch, chunk=16):
    """The clouds that ``sonet-torch infer`` times: those after its first
    chunk of ``min(chunk, (batches + 1) // 2)`` batches (padding left out,
    as infer counts only valid items)."""
    batches = -(-items // batch)
    return items - batch * max(1, min(chunk, (batches + 1) // 2))


def phase_infer(kernel_counters, on_path, run, card, runs):
    """``sonet-torch infer`` on the reproduce run's test split: 41 items in
    6 batches, the last padded (1 valid row of 8); its accuracy equal to
    the run's own ``Trainer.evaluate()`` on the card over the same items,
    the eval step one replay of a captured graph a batch.  Then infer's
    rate at ModelNet40 width over more items, the "trainer" run's 160 test
    clouds three times, against the eval step alone by events, eager and
    replayed.  Returns (the command's kernel launches, its replays)."""
    import csv
    import numpy as np
    from sonet_torch.config import load_config
    from sonet_torch.train.trainer import Trainer

    out_dir = os.path.join(run, "infer")
    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        rc, out = _cli_output(["infer", "--run", run, "--device", "cuda",
                               "--out", out_dir])
    launches = _launch_counts(kernel_counters)
    summary = json.loads(out.strip().splitlines()[-1])
    with open(os.path.join(out_dir, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    log(f"sonet-torch infer: {summary}; {len(rows) - 1} rows from 6 "
        f"batches of 8, the last with {41 - 5 * 8} valid; {graphs.captures} "
        f"capture, {graphs.replays} replays; kernel launches {launches}")
    if (rc != 0 or summary["items"] != 41 or len(rows) != 42
            or rows[0] != ["index", "label", "pred", "correct"]
            or [int(r[0]) for r in rows[1:]] != list(range(41))):
        raise AssertionError("sonet-torch infer: bad summary or rows")
    if (graphs.captures, graphs.replays) != (1, 6):
        raise AssertionError("want 1 capture and 6 replays for 6 batches")
    for n in on_path:
        if launches[n] != 2:
            raise AssertionError(f"{n} launched {launches[n]} times")
    # the run's Trainer over the same items: its test loader one epoch on,
    # as infer's is (both draw the points of the JAX package's inference)
    trainer = Trainer(load_config(os.path.join(run, "config.json")),
                      quiet=True, device="cuda")
    trainer.test_loader.skip_epoch()
    ev = trainer.evaluate()
    log(f"Trainer.evaluate() on the run: {ev}")
    if (ev["accuracy"] != summary["accuracy"]
            or abs(ev["loss"] - summary["loss"]) > 1e-6 * max(1.0, ev["loss"])
            or abs(sum(int(r[3]) for r in rows[1:]) / 41
                   - summary["accuracy"]) > 1e-12):
        raise AssertionError("sonet-torch infer disagrees with the run's "
                             "Trainer")

    # infer's rate at this width: 160 clouds, 4 batches to a fetch, the
    # first fetch's 32 left out; the eval step alone on one batch by events
    rates = []
    for i in range(3):
        rc, out = _cli_output(["infer", "--run", os.path.join(runs, "trainer"),
                               "--device", "cuda", "--scan_chunk", "4",
                               "--out", os.path.join(runs, f"infer_rate{i}")])
        got = json.loads(out.strip().splitlines()[-1])
        if rc != 0 or got["items"] != 160 or not got["clouds_per_sec"] > 0:
            raise AssertionError("sonet-torch infer on the trainer run failed")
        rates.append(got["clouds_per_sec"])
    batch = _to_card(next(iter(trainer.test_loader)))
    step_ms = time_ms(lambda: trainer.eval_step(trainer.state, batch), reps=20)
    replay_ms = time_ms(lambda: trainer.eval_graph(**batch), reps=20)
    log(f"infer on {card}, B=8, N=5000: {rates} clouds/s over "
        f"{_timed_clouds(160, 8, 4)} timed clouds each, host clock after "
        f"the first chunk; the eval step alone by events: eager "
        f"{step_ms:.4f} ms ({8 / step_ms * 1e3:.1f} clouds/s), captured "
        f"{replay_ms:.4f} ms ({8 / replay_ms * 1e3:.1f} clouds/s); the "
        f"41-item split: {summary['clouds_per_sec']} clouds/s over "
        f"{_timed_clouds(41, 8)} timed clouds")
    return launches, graphs.replays


def phase_mnist(kernel_counters, on_path, runs, card):
    """MNIST as a user runs it: a fabricated ``mnist.npz`` (2,048 train and
    512 test digits drawn from a seed), ``sonet-torch classify --preset
    mnist`` for one epoch (its datasets fit their 5x5 2-D nodes on the
    card), then ``sonet-torch infer`` on the run, each step a replay of a
    captured graph.  Kernel 1 must see only the (8, 1536, 384) bf16, M=25
    shape; the nodes are held by their quantization error against a CPU
    fit; a train step timed eager and replayed.  Returns (the kernel
    launches of the two commands, their replays)."""
    import numpy as np
    import torch
    from sonet_torch import config, som
    from sonet_torch.data.mnist import MNISTPointCloudDataset
    from sonet_torch.ops.cuda import segment_max_window as smw
    from sonet_torch.train.trainer import Trainer

    root = os.path.join(runs, "mnist_data")
    os.makedirs(root)
    xtr, ytr = _digits(np, 2048, seed=1)
    xte, yte = _digits(np, 512, seed=2)
    np.savez(os.path.join(root, "mnist.npz"), x_train=xtr, y_train=ytr,
             x_test=xte, y_test=yte)
    flags = ["--preset", "mnist", "--dataroot", root, "--epochs", "1",
             "--checkpoints_dir", runs, "--name", "mnist"]
    cfg = config.parse_args(flags)
    run = os.path.join(runs, "mnist")

    # every launch of kernel 1 in the two commands, by its shape
    real, shapes = smw._kernel, {}

    def recording(*args):
        key = _kernel1_key(args)                    # B, N, C, M
        shapes[key] = shapes.get(key, 0) + 1
        return real(*args)
    _reset(kernel_counters)
    smw._kernel = recording
    try:
        with _GraphCounter() as graphs:
            t0 = time.perf_counter()
            _cli(["classify", "--device", "cuda"] + flags)
            took = time.perf_counter() - t0
            rc, out = _cli_output(["infer", "--run", run, "--device",
                                   "cuda"])
    finally:
        smw._kernel = real
    launches = _launch_counts(kernel_counters)
    summary = json.loads(out.strip().splitlines()[-1])
    logged = _logged(run, "test_loss")
    step = _logged(run, "train_sec_per_step")["train_sec_per_step"]
    log(f"{_describe(cfg)}: sonet-torch classify took {took:.3f} s (2,048 + "
        f"512 digits to clouds, nodes fitted on the card, 256 steps, 64 "
        f"eval batches): test loss {logged['test_loss']}, accuracy "
        f"{logged['test_accuracy']}; a step with the loader in "
        f"{step * 1e3:.4f} ms; infer {summary}; {graphs.captures} "
        f"captures, {graphs.replays} replays; kernel launches {launches} "
        f"by (B, N, C, M) {shapes}")
    # a warm-up and a capture of the train, the eval and infer's step
    want = {(8, 1536, 384, 25): 6}
    if (rc != 0 or summary["items"] != 512 or shapes != want
            or (graphs.captures, graphs.replays) != (3, 256 + 64 + 64)
            or not np.isfinite(logged["test_loss"])
            or not np.isfinite(summary["loss"])):
        raise AssertionError("MNIST: bad metrics, replays or kernel 1 "
                             "shapes")
    for n in on_path:
        if launches[n] != 6:
            raise AssertionError(f"{n} launched {launches[n]} times")

    # the nodes the command fitted on the card, against a CPU fit
    ds = MNISTPointCloudDataset(root, "train", cfg, device="cuda")  # cache
    n_cpu = 256
    som_cfg = som.SOMConfig(cfg.rows, cfg.cols, 2)
    on_cpu = som.fit(ds.points[:n_cpu], som_cfg, device="cpu")
    x = torch.from_numpy(ds.points[:n_cpu])
    q_card = _quantization_error(torch, x, torch.from_numpy(
        ds.som_node[:n_cpu]))
    q_cpu = _quantization_error(torch, x, on_cpu)
    log(f"MNIST nodes ({ds.som_node.shape}) fitted on the card: "
        f"quantization error {q_card} vs the CPU fit's {q_cpu} over "
        f"{n_cpu} clouds (tolerance {SOM_QE_RTOL} x)")
    if ds.som_node.shape != (2048, 25, 2) or abs(q_card - q_cpu) > (
            SOM_QE_RTOL * q_cpu):
        raise AssertionError("MNIST: the card's nodes disagree with the CPU")

    # one train step and one eval step alone, by events
    trainer = Trainer(cfg, quiet=True, device="cuda")
    batch = _to_card(next(iter(trainer.train_loader)))

    def step():
        trainer.train_step(trainer.state, batch, trainer.generator)

    def replay():
        trainer.train_graph(**batch)

    step_ms = time_ms(step, reps=20)
    replay_ms = time_ms(replay, reps=20)
    wall, busy, rows = _busy_share(lambda: [step() for _ in range(5)])
    rwall, rbusy, rrows = _busy_share(lambda: [replay() for _ in range(5)])
    log(f"MNIST train step at B=8 on the card by events: eager "
        f"{step_ms:.4f} ms ({8 / step_ms * 1e3:.1f} clouds/s), captured "
        f"{replay_ms:.4f} ms ({8 / replay_ms * 1e3:.1f} clouds/s); under "
        f"torch.profiler, eager {busy * 1e3 / 5:.4f} ms of device time in "
        f"{rows // 5} device rows a step, the card busy {busy / wall:.1%} "
        f"of the 5 steps; captured {rbusy * 1e3 / 5:.4f} ms in "
        f"{rrows // 5} rows, busy {rbusy / rwall:.1%}")
    eval_ms = time_ms(lambda: trainer.eval_step(trainer.state, batch),
                      reps=20)
    log(f"MNIST infer on {card}, B=8, N=512: {summary['clouds_per_sec']} "
        f"clouds/s over {_timed_clouds(512, 8)} timed clouds, host clock "
        f"after the first chunk; the eval step alone {eval_ms:.4f} ms by "
        f"events ({8 / eval_ms * 1e3:.1f} clouds/s)")
    return launches, graphs.replays


def _post(url, body, ctype):
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _status(fn):
    """The HTTP status of ``fn()``'s request, an error status included."""
    import urllib.error
    try:
        return fn()[0]
    except urllib.error.HTTPError as e:
        return e.code


def phase_serve_http(kernel_counters, on_path, run):
    """The reproduce run served over HTTP as a user runs it:
    ``ServingEngine.from_run`` with the micro-batcher on (5 ms window) and
    ``tasks.serve.make_server`` on 127.0.0.1; 16 concurrent B'=1 npz
    requests, each answer held against the engine's direct predict of the
    same cloud and nearer to it than to any other cloud's; 200 requests in
    a row and 8 bursts of 16 with micro-batching on and as many off, in
    alternating rounds; then ``drain_server`` with a request in flight.
    The engine's warm-up captures the forward; every dispatch, the
    micro-batcher's included, is one replay.  Returns (the kernel
    launches from the warm-up to the first 16 requests' answers, their
    replays)."""
    import io
    import threading
    import numpy as np
    from sonet_torch.config import load_config
    from sonet_torch.serving import ServingEngine
    from sonet_torch.tasks import serve

    engine = ServingEngine.from_run(run, device="cuda")
    _reset(kernel_counters)
    engine.warmup()                     # kernel 1: a warm-up and a capture
    names = engine.input_names
    clouds = _clouds(np, 16, load_config(os.path.join(run, "config.json")),
                     seed=21)
    want = engine.predict({n: clouds[n] for n in names})

    def body(i):
        buf = io.BytesIO()
        np.savez(buf, **{n: clouds[n][i:i + 1] for n in names})
        return buf.getvalue()
    bodies = [body(i) for i in range(16)]
    engine.start_microbatch(5.0)
    srv = serve.make_server(engine, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def predict(i):
        _, raw = _post(url + "/v1/predict?format=npz", bodies[i],
                       "application/x-npz")
        with np.load(io.BytesIO(raw)) as z:
            return z["output"]

    def concurrent():
        got = [None] * 16
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, predict(i))) for i in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return got, (time.perf_counter() - t0) * 1e3

    # how far each cloud's direct answer lies from every other's: an
    # answer routed to another caller would be at least this far off
    scale = max(1.0, float(np.abs(want).max()))
    apart = np.abs(want[:, None] - want[None]).max(-1) / scale
    np.fill_diagonal(apart, np.inf)

    def misrouted(got):
        """The rows of ``got`` not within LOGIT_RTOL of their own cloud's
        direct answer, or nearer to another cloud's; and the worst
        distance to the own answer."""
        d = np.abs(np.stack([g[0] for g in got])[:, None] - want[None]
                   ).max(-1) / scale
        own = np.diag(d).copy()
        np.fill_diagonal(d, np.inf)
        bad = [i for i in range(len(got))
               if own[i] > LOGIT_RTOL or own[i] >= d[i].min()]
        return bad, float(own.max())

    try:
        before = engine.stats()
        r0 = engine.graph.replays
        got, wall_ms = concurrent()
        launches = _launch_counts(kernel_counters)
        replays = engine.graph.replays - r0
        s = engine.stats()
        bad, worst = misrouted(got)
        log(f"16 concurrent B'=1 HTTP requests, micro-batching on (5 ms): "
            f"{wall_ms:.4f} ms in all; {s['requests'] - before['requests']} "
            f"requests in {s['dispatches'] - before['dispatches']} "
            f"dispatches, {s['coalesced_requests']} coalesced; each answer "
            f"within {worst:.3g} of the largest score of its direct predict "
            f"(tolerance {LOGIT_RTOL}), two clouds' direct answers at least "
            f"{apart.min():.3g} apart; answers off or nearer another cloud's "
            f"{bad}; {replays} replays, kernel launches {launches}")
        if (bad or s["coalesced_requests"] == 0
                or s["dispatches"] - before["dispatches"] >= 16
                or s["requests"] - before["requests"] != 16):
            raise AssertionError("micro-batched HTTP serving is wrong")
        if (replays != s["dispatches"] - before["dispatches"]
                or engine.graph.captures != 1
                or any(launches[n] != 2 for n in on_path)):
            raise AssertionError(f"want a replay a dispatch of the forward "
                                 f"captured at the warm-up, got {replays} "
                                 f"and launches {launches}")

        # 4 rounds, the modes' order alternating: 50 requests in a row and
        # 2 bursts of 16 each; every burst's answers held as the first's
        lone = {"on": [], "off": []}
        burst = {"on": [], "off": []}
        for r in range(4):
            for mode in (("on", "off"), ("off", "on"))[r % 2]:
                if mode == "on":
                    engine.start_microbatch(5.0)
                else:
                    engine.stop_microbatch()
                for i in range(50):
                    t0 = time.perf_counter()
                    predict(i % 16)
                    lone[mode].append((time.perf_counter() - t0) * 1e3)
                for _ in range(2):
                    got, ms = concurrent()
                    if misrouted(got)[0]:
                        raise AssertionError(f"a burst with micro-batching "
                                             f"{mode} misrouted answers")
                    burst[mode].append(ms)
        engine.start_microbatch(5.0)
        for mode in ("on", "off"):
            q = statistics.quantiles(lone[mode], n=10)
            log(f"HTTP B'=1 request, micro-batching {mode}, {len(lone[mode])} "
                f"in a row: median {statistics.median(lone[mode]):.4f} ms, "
                f"p10 {q[0]:.4f}, p90 {q[-1]:.4f}, max {max(lone[mode]):.4f}; "
                f"{len(burst[mode])} bursts of 16: median "
                f"{statistics.median(burst[mode]):.4f} ms, min "
                f"{min(burst[mode]):.4f}, max {max(burst[mode]):.4f}")

        # drain with one request held in flight on the engine's lock
        held_out = {}
        with engine._lock:
            held = threading.Thread(target=lambda: held_out.update(
                out=predict(0)))
            held.start()
            deadline = time.time() + 30
            while srv._inflight == 0 and time.time() < deadline:
                time.sleep(0.01)
            drained = {}
            d = threading.Thread(target=lambda: drained.update(
                clean=serve.drain_server(srv, engine)))
            d.start()
            srv.draining.wait(30)
            health = _status(lambda: _get(url + "/healthz"))
            refused = _status(lambda: _post(url + "/v1/predict?format=npz",
                                            bodies[1], "application/x-npz"))
        held.join(60)
        d.join(60)
        held_ok = "out" in held_out and float(np.abs(
            held_out["out"][0] - want[0]).max()) <= LOGIT_RTOL * max(
                1.0, float(np.abs(want[0]).max()))
        log(f"draining: /healthz {health}, a new predict {refused}; the "
            f"request in flight answered {held_ok}, drain clean "
            f"{drained.get('clean')}")
        if (health, refused, drained.get("clean"), held_ok) != (
                503, 503, True, True) or engine.stats()["microbatch"]:
            raise AssertionError("drain_server: wrong answers while draining")
    finally:
        serve.drain_server(srv, engine)
    return launches, replays


class _GraphCounter:
    """Counts CUDA graph captures and replays, wherever they happen, and,
    by kernel counter (``_mesh_counters``), the replays of the graphs whose
    capture launched that kernel (``ran``): what a kernel's row reports
    as its graph replays.  A graph keeps what its capture launched, so a
    replay counts in whatever counter is open when it runs."""

    def __enter__(self):
        import torch
        self.cls = torch.cuda.CUDAGraph
        self.real = (self.cls.capture_begin, self.cls.capture_end,
                     self.cls.replay)
        self.captures = self.replays = 0
        counters = _mesh_counters()
        self.ran = dict.fromkeys(counters, 0)
        begin, end, replay = self.real

        def counted_begin(graph, *a, **k):
            self.captures += 1
            graph.smoke_launches = _launch_counts(counters)
            return begin(graph, *a, **k)

        def counted_end(graph, *a, **k):
            out = end(graph, *a, **k)
            now = _launch_counts(counters)
            graph.smoke_holds = [n for n, c in now.items()
                                 if c > graph.smoke_launches[n]]
            return out

        def counted_replay(graph, *a, **k):
            self.replays += 1
            for n in getattr(graph, "smoke_holds", ()):
                self.ran[n] += 1
            return replay(graph, *a, **k)
        self.cls.capture_begin = counted_begin
        self.cls.capture_end = counted_end
        self.cls.replay = counted_replay
        return self

    def __exit__(self, *exc):
        (self.cls.capture_begin, self.cls.capture_end,
         self.cls.replay) = self.real


def _batchnorm_calls(calls):
    """A context that records each BatchNorm call that takes the fused
    kernels (``BatchNorm._fused``) into ``calls`` as (module, training,
    gradient enabled)."""
    import contextlib

    import torch
    from sonet_torch.nn import layers

    @contextlib.contextmanager
    def ctx():
        real = layers.BatchNorm._fused

        def recording(self, *a):
            calls.append((self, self.training, torch.is_grad_enabled()))
            return real(self, *a)
        layers.BatchNorm._fused = recording
        try:
            yield
        finally:
            layers.BatchNorm._fused = real
    return ctx()


def _plain_batchnorm_calls(calls):
    """A context that records into ``calls`` the shape of each CUDA tensor
    that a BatchNorm runs through its plain chain (``BatchNorm.forward``):
    on the card there should be none."""
    import contextlib

    from sonet_torch.nn import layers

    @contextlib.contextmanager
    def ctx():
        real = layers.BatchNorm.forward

        def watched(self, x, *a, **k):
            if x.is_cuda:
                calls.append(tuple(x.shape))
            return real(self, x, *a, **k)
        layers.BatchNorm.forward = watched
        try:
            yield
        finally:
            layers.BatchNorm.forward = real
    return ctx()


def _served_norms(model, cfg):
    """The names of the BatchNorms that ``model``'s eval forward runs: all
    of them but the autoencoder's 64x64 decoder stage where nothing reads
    it (``nn/decoder.py``)."""
    from sonet_torch.nn.layers import BatchNorm
    unread = cfg.task == "autoencode" and cfg.output_conv_pc_num != 4096
    return [n for n, m in model.named_modules() if isinstance(m, BatchNorm)
            and not (unread and n.startswith(UNREAD_STAGE))]


def _check_batchnorm_calls(calls, launches, times, want, what, model=None):
    """Holds what ``_batchnorm_calls`` recorded (``calls``) against the
    fused BatchNorm's launches counted over the same work: each of the
    ``want`` BatchNorms (by name) took the kernels ``times`` times, all in
    train mode or all in eval mode, and each mode's counter grew by one a
    call (backward: a train call with a gradient).  ``model`` names the
    recorded modules; without it (a served snapshot of the model) they
    are held by count."""
    names = ({id(m): n for n, m in model.named_modules()}
             if model is not None else {})
    by = {}
    for m, _, _ in calls:
        key = names.get(id(m), id(m))
        by[key] = by.get(key, 0) + 1
    train = sum(t for _, t, _ in calls)
    grad = sum(t and g for _, t, g in calls)
    modes = {"batchnorm_act.train": train,
             "batchnorm_act.eval": len(calls) - train,
             "batchnorm_act.backward": grad}
    got = {n: launches[n] for n in modes}
    log(f"{what}: {len(by)} BatchNorms took the fused kernels, "
        f"{len(calls)} calls ({train} in train mode, {grad} of them with a "
        f"gradient); launches {got}")
    same = (sorted(by) == sorted(want) if model is not None
            else len(by) == len(want))
    if (not same or set(by.values()) != {times}
            or train not in (0, len(calls)) or got != modes):
        raise AssertionError(f"{what}: want each of {len(want)} BatchNorms "
                             f"{times} times through the fused kernels, one "
                             f"launch a call: calls {by}, launches {got}")


def _kernel1_key(args):
    """(B, N, C, M) of a call of kernel 1's C function, with "direct"
    added where the input would not take the bulk kernel: its pointer and
    row bytes, read as ``kernel_path`` reads them (inside a graph as
    well)."""
    from sonet_torch.ops.cuda import segment_max_window as smw
    ptr, code, B, N, C, M = args[0], args[1], *args[4:8]
    row = C * (4 if code == 0 else 2)
    lo, hi = smw._BULK_ROW_BYTES
    bulk = ptr % 16 == 0 and row % 16 == 0 and lo <= row <= hi
    return (B, N, C, M) if bulk else (B, N, C, M, "direct")


def _kernel1_shapes():
    """(record context, shapes) that counts each call of kernel 1's C
    function by ``_kernel1_key``; in a graph a call is its capture."""
    import contextlib
    from sonet_torch.ops.cuda import segment_max_window as smw
    shapes = {}

    @contextlib.contextmanager
    def record():
        real = smw._kernel

        def recording(*args):
            key = _kernel1_key(args)
            shapes[key] = shapes.get(key, 0) + 1
            return real(*args)
        smw._kernel = recording
        try:
            yield
        finally:
            smw._kernel = real
    return record, shapes


def _state_tensors(t):
    return {k: v.detach().clone() for k, v in t.model.state_dict().items()}


def update_rel_diff(before, eager, graph) -> float:
    """The relative norm, over every float tensor, of the difference
    between two updates from ``before``: the eager step's and the
    replay's."""
    num = den = 0.0
    for k, b in before.items():
        if b.is_floating_point():
            de = (eager[k] - b).double()
            dg = (graph[k] - b).double()
            num += float((de - dg).square().sum())
            den += float(de.square().sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def captured_and_eager_step(t):
    """One train step of the device-pipeline ``Trainer`` ``t`` on the first
    row of its next epoch's table, eagerly and then as a graph replay, from
    the same weights, Adam state and generator state.  Returns (eager
    loss, replayed loss, the relative difference of their updates); ``t``
    is left after the replay."""
    import torch
    epoch = t.state.step // t.steps_per_epoch
    table, _ = t._device_epoch_index(t.device_train, True, epoch)
    row = table[:1]
    before = _state_tensors(t)
    restore, gen = t._snapshot(), t.generator.get_state()
    step0 = t.state.step
    eager_loss = float(t._device_train_step(
        t.device_train, torch.from_numpy(row[0]).to(t.device))["loss"])
    eager = _state_tensors(t)
    restore()
    t.generator.set_state(gen)
    loss = float(t.train_graph.run(t.device_train, row)["loss"][0])
    if t.state.step != step0 + 1:
        raise AssertionError("a replay did not advance the step")
    return eager_loss, loss, update_rel_diff(before, eager,
                                              _state_tensors(t))


def captured_and_eager_host_step(t, batch):
    """One train step of the host- or native-pipeline ``Trainer`` ``t`` on
    ``batch`` (host arrays), eagerly (``t.train_step`` on the batch on the
    card) and then as a replay of ``t.train_graph``, from the same
    weights, Adam state and generator state.  Returns (eager loss,
    replayed loss, the relative difference of their updates); ``t`` is
    left after the replay."""
    import torch
    host = t._pinned_batch(batch)
    before = _state_tensors(t)
    restore, gen = t._snapshot(), t.generator.get_state()
    step0 = t.state.step
    _, m = t.train_step(t.state, {k: v.to(t.device) for k, v in
                                  host.items()}, t.generator)
    eager_loss = float(m["loss"])
    eager = _state_tensors(t)
    restore()
    t.generator.set_state(gen)
    loss = float(t.train_graph(**host)["loss"])
    torch.cuda.synchronize()
    if t.state.step != step0 + 1:
        raise AssertionError("a replay did not advance the step")
    return eager_loss, loss, update_rel_diff(before, eager,
                                              _state_tensors(t))


def _replays_draw_anew(t):
    """Two replays of the device pipeline's sampling, captured over ``t``'s
    train split on one row twice, against two eager calls from the same
    generator state: (the replays differ in points, normals and nodes,
    the replays equal the eager calls)."""
    import numpy as np
    import torch
    from sonet_torch.data.device_pipeline import sample_batch
    from sonet_torch.train.graphs import EpochGraph
    gen = torch.Generator(device="cuda").manual_seed(11)

    def step(data, idx):
        b = sample_batch(data, idx, gen, t.cfg, train=True)
        return {k: b[k] for k in ("pc", "sn", "node")}

    table = np.stack([np.arange(t.cfg.batch_size)] * 2)
    state = gen.get_state()
    got = EpochGraph(step, t.device, generators=(gen,)).run(t.device_train,
                                                            table)
    gen.set_state(state)
    want = [step(t.device_train, torch.from_numpy(r).cuda()) for r in table]
    differ = all(not np.array_equal(got[k][0], got[k][1]) for k in got)
    equal = all(np.array_equal(got[k][i], want[i][k].cpu().numpy())
                for k in got for i in range(2))
    return differ, equal


def _epoch_readings(runs, tree, pipelines):
    """Fresh ``Trainer``s on ``tree`` at ``config.modelnet40()``'s width,
    one a pipeline, with the preset's schedules (no new learning rate or
    momentum for 20 epochs, so a captured step is captured once): a
    warm-up epoch each, then epochs in alternating order (A B B A):
    {pipeline: [ms a step with the loader in, ...]}; then one more epoch
    of each under torch.profiler: {pipeline: (ms a step by the host clock,
    device ms a step, busy share)}; and the graph captures and replays of
    the timed epochs."""
    from sonet_torch import config
    from sonet_torch.train.trainer import Trainer
    flags = ["--preset", "modelnet40", "--dataset", "modelnet",
             "--random_pc_dropout_lower_limit", "0.8", "--dataroot", tree,
             "--checkpoints_dir", runs]
    trainers = {p: Trainer(config.parse_args(flags + [
        "--input_pipeline", p, "--name", f"epochs_{p}"]), quiet=True,
        device="cuda", resume=False) for p in pipelines}
    for t in trainers.values():
        t.train_epoch(0)
    epoch = dict.fromkeys(pipelines, 1)
    steps, busy = {}, {}
    with _GraphCounter() as graphs:
        for p in list(pipelines) + list(pipelines)[::-1]:
            sec = trainers[p].train_epoch(epoch[p])["sec_per_step"]
            epoch[p] += 1
            steps.setdefault(p, []).append(round(sec * 1e3, 4))
        for p, t in trainers.items():
            S = t.steps_per_epoch
            wall, dev, _ = _busy_share(lambda: t.train_epoch(epoch[p]))
            busy[p] = (round(wall * 1e3 / S, 4), round(dev * 1e3 / S, 4),
                       round(dev / wall, 4))
    return steps, busy, (graphs.captures, graphs.replays)


def phase_trainer_device(kernel_counters, on_path, runs):
    """``sonet-torch classify --input_pipeline device`` at
    ``config.modelnet40()``'s width on the "reproduce" tree (80 train and
    41 test clouds of 10,000 points: the 5,000-point subsample runs on the
    card), two epochs.  Then a ``Trainer`` on the run, at epoch 3: a
    captured step equal to an eager one (CAPTURED_RTOL), with epoch 3's
    learning rate and momentum; two replays drawing anew, as eager calls
    do; ``evaluate()`` twice to the same bits; the epoch time a step, the
    device time a step and the busy share beside the host pipeline's, in
    alternating order; the run restored into a host-pipeline ``Trainer``
    bit for bit.  Returns (the command's kernel launches, replays)."""
    import torch
    from sonet_torch import config
    from sonet_torch.train.trainer import Trainer

    tree = os.path.join(runs, "reproduce_data", "modelnet40")
    flags = DEVICE_FLAGS + ["--dataroot", tree, "--checkpoints_dir", runs,
                            "--input_pipeline", "device"]
    cfg = config.parse_args(flags + ["--name", "trainer_device"])
    record, shapes = _kernel1_shapes()
    _reset(kernel_counters)
    with _GraphCounter() as graphs, record():
        took = _cli(["classify", "--device", "cuda", "--epochs", "2",
                     "--name", "trainer_device"] + flags)
    launches = _launch_counts(kernel_counters)
    run = os.path.join(runs, "trainer_device")
    logged = _logged(run, "test_loss")
    sec = _logged(run, "train_sec_per_step")["train_sec_per_step"]
    log(f"{_describe(cfg)}, device pipeline: sonet-torch classify took "
        f"{took:.3f} s (80 + 41 clouds stacked and copied, 2 epochs, 2 "
        f"evals); {graphs.captures} captures and {graphs.replays} replays; "
        f"kernel 1 launches {launches} (warm-ups and captures) by (B, N, C, "
        f"M) {shapes}; test loss {logged['test_loss']}, accuracy "
        f"{logged['test_accuracy']}; epoch 2 {sec * 1e3:.4f} ms a step")
    # train: a capture for epoch 1's key and one for epoch 2's; eval: one
    if (graphs.captures, graphs.replays) != (3, 2 * 10 + 2 * 6) or (
            shapes != {(8, 15000, 384, 64): 6}):
        raise AssertionError("device pipeline: want 3 captures, 32 replays "
                             "and kernel 1 at (8, 15000, 384, 64) only")
    # every captured step subsamples 10,000 points to 5,000 on the card
    for n in (*on_path, "subset_select"):
        if launches[n] != 6:
            raise AssertionError(f"{n} launched {launches[n]} times")

    t = Trainer(cfg, quiet=True, device="cuda")
    if t.state.step != 20 or not all(
            g["capturable"] for g in t.state.optimizer.param_groups):
        raise AssertionError("the device Trainer did not resume at step 20 "
                             "with a capturable Adam")
    want_key = (tuple(cfg.lr / 2 for _ in t.state.optimizer.param_groups),
                0.1 * 0.6 ** 2)
    restore, gen = t._snapshot(), t.generator.get_state()
    eager, graph, rel = captured_and_eager_step(t)
    key = t.train_graph.captured_key
    restore()
    t.generator.set_state(gen)
    log(f"epoch 3's first step, eager vs captured from the same state: loss "
        f"{eager} vs {graph}, updates {rel:.3e} apart (tolerance "
        f"{CAPTURED_RTOL}); the graph's lr {key[0]}, momenta "
        f"{sorted(set(key[1]))}")
    if (abs(eager - graph) > CAPTURED_RTOL * abs(eager)
            or not rel <= CAPTURED_RTOL or key[0] != want_key[0]
            or set(key[1]) != {want_key[1]}):
        raise AssertionError("the captured step is not the eager step of "
                             "epoch 3")
    differ, equal = _replays_draw_anew(t)
    log(f"sampling replayed twice on one row: draws differ {differ}, equal "
        f"to two eager calls {equal}")
    if not (differ and equal):
        raise AssertionError("replays do not draw anew as eager calls do")
    ev = [t.evaluate() for _ in range(2)]
    log(f"evaluate() twice: {ev[0]} and {ev[1]}")
    if ev[0] != ev[1]:
        raise AssertionError("device eval is not reproducible")

    steps, busy, (captures, replays) = _epoch_readings(
        runs, tree, ("device", "host"))
    log(f"epochs of 10 steps on the tree, a step with the loader in, "
        f"alternating device host host device: device {steps['device']} ms, "
        f"host {steps['host']} ms; under torch.profiler, (host clock ms, "
        f"device ms, busy share) a step: device {busy['device']}, host "
        f"{busy['host']}; the timed device epochs: {captures} captures, "
        f"{replays} replays")
    # the host pipeline's steps are captured too: 3 epochs of 10 each
    if captures or replays != 2 * 3 * 10:
        raise AssertionError("a timed epoch captured its step again")
    t.train_epoch(2)
    t._save()
    back = Trainer(cfg.replace(input_pipeline="host"), quiet=True,
                   device="cuda")
    bad = _same_tensors(torch, back.model.state_dict(),
                        t.model.state_dict(), None)
    sa, sb = t.state.optimizer.state, back.state.optimizer.state
    for pa, pb in zip(t.model.parameters(), back.model.parameters()):
        for k, v in sa.get(pa, {}).items():
            if not torch.equal(v.cpu(), sb[pb][k].cpu()):
                bad.append(k)
    log(f"the run restored into a host-pipeline Trainer at step "
        f"{back.state.step}: tensors differing {bad}")
    if bad or back.state.step != t.state.step or not all(
            g["capturable"] for g in back.state.optimizer.param_groups):
        raise AssertionError("the device run does not restore into a host "
                             "Trainer bit for bit")
    return launches, graphs.replays


def phase_trainer_chunked(kernel_counters, on_path, runs):
    """The "trainer_device" command for one epoch with a
    ``--device_budget_gb`` that streams the train split in 4 chunks: its
    weights after the epoch equal the resident run's (that run's step-10
    checkpoint) bit for bit.  Returns the kernel launches."""
    import torch
    tree = os.path.join(runs, "reproduce_data", "modelnet40")
    flags = DEVICE_FLAGS + ["--dataroot", tree, "--checkpoints_dir", runs,
                            "--input_pipeline", "device", "--epochs", "1",
                            "--device_budget_gb", CHUNK_BUDGET_GB,
                            "--name", "trainer_chunked"]
    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        rc, out = _cli_output(["classify", "--device", "cuda"] + flags)
    launches = _launch_counts(kernel_counters)
    replays = graphs.replays
    chunked = torch.load(os.path.join(runs, "trainer_chunked", "ckpt",
                                      "step_00000010.pt"),
                         map_location="cpu", weights_only=True)
    resident = torch.load(os.path.join(runs, "trainer_device", "ckpt",
                                       "step_00000010.pt"),
                          map_location="cpu", weights_only=True)
    bad = _same_tensors(torch, chunked["model"], resident["model"], None)
    streamed = [ln for ln in out.splitlines() if "streaming" in ln]
    log(f"chunked: {streamed}; {graphs.captures} captures, {graphs.replays} "
        f"replays, kernel launches {launches}; weights after the epoch "
        f"against the resident run's: differing {bad}")
    if (rc != 0 or not any("4 chunks of 24" in ln for ln in streamed)
            or (graphs.captures, graphs.replays) != (2, 16) or bad):
        raise AssertionError("chunked: want 4 chunks, 2 captures, 16 replays "
                             "and the resident run's weights")
    for n in (*on_path, "subset_select"):
        if launches[n] != 4:
            raise AssertionError(f"{n} launched {launches[n]} times")
    return launches, replays


def phase_trainer_native(kernel_counters, on_path, runs):
    """``sonet-torch classify --input_pipeline native`` on the "reproduce"
    tree for one epoch, then epochs of its ``Trainer`` beside a host
    pipeline's in alternating order (a step with the loader in, the busy
    share), and ``sonet-torch infer --input_pipeline native`` on the run:
    41 rows, its accuracy equal to the run's ``Trainer.evaluate()`` over
    the same items; each step a replay of a captured graph; the run
    restored into a device-pipeline ``Trainer`` bit for bit.  Returns (the
    kernel launches of the two commands, their replays)."""
    import csv
    import torch
    from sonet_torch import config
    from sonet_torch.data.native_loader import NativeModelNetDataset
    from sonet_torch.train.trainer import Trainer

    tree = os.path.join(runs, "reproduce_data", "modelnet40")
    flags = DEVICE_FLAGS + ["--dataroot", tree, "--checkpoints_dir", runs,
                            "--input_pipeline", "native",
                            "--name", "trainer_native"]
    cfg = config.parse_args(flags)
    run = os.path.join(runs, "trainer_native")
    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        took = _cli(["classify", "--device", "cuda", "--epochs", "1"] + flags)
        out_dir = os.path.join(run, "infer")
        rc, out = _cli_output(["infer", "--run", run, "--device", "cuda",
                               "--input_pipeline", "native", "--out",
                               out_dir])
    launches = _launch_counts(kernel_counters)
    summary = json.loads(out.strip().splitlines()[-1])
    with open(os.path.join(out_dir, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    log(f"native pipeline: sonet-torch classify took {took:.3f} s (one "
        f"epoch, its eval); infer {summary}, {len(rows) - 1} rows; "
        f"{graphs.captures} captures, {graphs.replays} replays; kernel "
        f"launches {launches}")
    if rc != 0 or summary["items"] != 41 or len(rows) != 42:
        raise AssertionError("native infer: bad summary or rows")
    if (graphs.captures, graphs.replays) != (3, 10 + 6 + 6):
        raise AssertionError("native: want 3 captures and 22 replays")
    for n in on_path:
        if launches[n] != 6:
            raise AssertionError(f"{n} launched {launches[n]} times")
    t = Trainer(cfg, quiet=True, device="cuda")
    if not isinstance(t.test_set, NativeModelNetDataset):
        raise AssertionError("native: the Trainer reads with another loader")
    t.test_loader.skip_epoch()
    ev = t.evaluate()
    log(f"Trainer.evaluate() on the run: {ev}")
    if ev["accuracy"] != summary["accuracy"] or abs(
            ev["loss"] - summary["loss"]) > 1e-6 * max(1.0, ev["loss"]):
        raise AssertionError("native infer disagrees with the run's Trainer")
    t._save()
    dev = Trainer(cfg.replace(input_pipeline="device"), quiet=True,
                  device="cuda")
    bad = _same_tensors(torch, dev.model.state_dict(),
                        t.model.state_dict(), None)
    sa, sb = t.state.optimizer.state, dev.state.optimizer.state
    for pa, pb in zip(t.model.parameters(), dev.model.parameters()):
        for k, v in sa.get(pa, {}).items():
            if not torch.equal(v.cpu(), sb[pb][k].cpu()):
                bad.append(k)
    log(f"the native run restored into a device-pipeline Trainer at step "
        f"{dev.state.step}: tensors differing {bad}")
    if bad or dev.state.step != t.state.step:
        raise AssertionError("the native run does not restore into a "
                             "device Trainer bit for bit")
    del dev
    steps, busy, (captures, replays) = _epoch_readings(
        runs, tree, ("native", "host"))
    log(f"epochs of 10 steps on the tree, a step with the loader in, "
        f"alternating native host host native: native {steps['native']} ms, "
        f"host {steps['host']} ms; under torch.profiler, (host clock ms, "
        f"device ms, busy share) a step: native {busy['native']}, host "
        f"{busy['host']}; {captures} captures, {replays} replays")
    if captures or replays != 2 * 3 * 10:
        raise AssertionError("a timed epoch captured its step again")
    return launches, graphs.replays


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _served_apart(got, want):
    """Max abs difference of ``got`` from ``want`` over want's largest
    entry (at least 1), and whether the two are equal."""
    import numpy as np
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale, bool(
        np.array_equal(got, want))


def phase_export(kernel_counters, on_path, run, runs):
    """The "reproduce" run (``config.modelnet40()`` width) exported as a
    user exports it, ``sonet-torch export --check`` three times: the
    default (``cuda``: one B=8 program keeping kernel 1 as
    ``sonet_torch::windowed_vals``), ``--poly_batch`` (bucketed: a program
    for each of B = 1, 2, 4, 8, each keeping the kernel) and
    ``--platforms cpu,cuda --poly_batch`` (one symbolic-batch program on
    the portable scatter path); artifact bytes and export times.  Each is
    served by ``ServingEngine.from_artifact`` (a captured graph a
    program's batch) on 41 clouds at B' = 1, 3, 8 and 41 and held within
    the bf16 rule of ``from_run`` (the kernel artifacts) or of the same
    run served with scatter pooling (the portable one, stored on the CPU
    and moved onto the card).  The portable artifact also answers on the
    CPU through ``load_exported``, and a child process that cannot import
    ``sonet_torch`` loads its ``model.pt2`` with ``torch.export.load``
    and answers, on the card and on the CPU with the card hidden.  Then
    ``tasks.serve.make_server`` on the default artifact answers 16
    concurrent B'=1 requests, and ``sonet-torch serve --artifact``, as a
    process, one.  Returns (the kernel launches from the engines' warm-ups
    on, their replays)."""
    import io
    import threading
    import numpy as np
    import torch
    from sonet_torch.config import load_config
    from sonet_torch.serving import ServingEngine, _restore_run
    from sonet_torch.tasks import serve

    cfg = load_config(os.path.join(run, "config.json"))
    forms = {"cuda": [], "bucketed": ["--poly_batch"],
             "portable": ["--platforms", "cpu,cuda", "--poly_batch"]}
    arts, made = {}, {}
    for form, extra in forms.items():
        arts[form] = os.path.join(runs, f"export_{form}")
        t0 = time.perf_counter()
        rc, out = _cli_output(["export", "--run", run, "--out", arts[form],
                               "--device", "cuda", "--check"] + extra)
        took = time.perf_counter() - t0
        m = json.loads(out.strip().splitlines()[-1])
        made[form] = m
        log(f"export [{form}]: {took:.3f} s (the export, a reload and a "
            f"check on zeros), {_dir_bytes(arts[form])} bytes in "
            f"{sorted(os.listdir(arts[form]))}; pooling {m['pooling']}, "
            f"requires {m['requires']}, buckets {m.get('buckets')}, check "
            f"{m['check']}")
        if rc != 0 or not m["check"]["finite"]:
            raise AssertionError(f"sonet-torch export [{form}] failed")
    if ([made[f]["pooling"] for f in forms]
            != ["sorted_window", "sorted_window", "scatter"]
            or made["bucketed"]["buckets"] != [1, 2, 4, 8]):
        raise AssertionError("export: wrong pooling or buckets")
    for form in ("cuda", "bucketed"):
        program = torch.export.load(os.path.join(
            arts[form], "model.pt2" if form == "cuda" else "model_b8.pt2"))
        if not any(str(n.target) == "sonet_torch.windowed_vals.default"
                   for n in program.graph.nodes):
            raise AssertionError(f"export [{form}] lost the operator")
        del program

    clouds = _clouds(np, 41, cfg, seed=31)
    names = ["pc", "sn", "node"]
    ref = ServingEngine.from_run(run, device="cuda")
    scfg, smodel, _, _ = _restore_run(run, device="cuda", pooling="scatter")
    ref_scatter = ServingEngine.from_model(smodel, scfg, device="cuda")
    sizes = (1, 3, 8, 41)
    want = {b: ref.predict({n: clouds[n][:b] for n in names}) for b in sizes}
    want_s = {b: ref_scatter.predict({n: clouds[n][:b] for n in names})
              for b in sizes}

    record, shapes = _kernel1_shapes()
    engines = {}
    _reset(kernel_counters)
    replays = 0
    with record():
        for form in forms:
            eng = engines[form] = ServingEngine.from_artifact(arts[form],
                                                              device="cuda")
            eng.warmup()
            # one program at B, a program a bucket, the symbolic one at
            # each power of 2 up to the micro-batcher's fill of 8
            warm = eng.graph.captures
            if warm != (1 if form == "cuda" else 4):
                raise AssertionError(f"from_artifact [{form}]: the warm-up "
                                     f"captured {warm} graphs")
            r0 = eng.graph.replays
            against = want_s if form == "portable" else want
            got = {b: eng.predict({n: clouds[n][:b] for n in names})
                   for b in sizes}
            torch.cuda.synchronize()
            replays += eng.graph.replays - r0
            apart = {b: _served_apart(got[b], against[b]) for b in sizes}
            log(f"from_artifact [{form}]: batch {eng.batch_size}, "
                f"{warm} captures at the warm-up, {eng.graph.captures} in "
                f"all, "
                f"{eng.graph.replays - r0} replays for B' = {sizes}; "
                f"against from_run{' (scatter)' if form == 'portable' else ''}"
                f" (max abs diff / largest entry, equal): {apart}")
            if any(d > LOGIT_RTOL for d, _ in apart.values()) or any(
                    got[b].shape != _score_shape(cfg, b) for b in sizes):
                raise AssertionError(f"from_artifact [{form}] disagrees "
                                     f"with from_run")
    launches = _launch_counts(kernel_counters)
    log(f"the artifacts' engines: {replays} replays; kernel 1 launches "
        f"{launches} (warm-ups and captures) by (B, N, C, M) {shapes}")
    # the cuda artifact's B=8 program and each bucket's
    want_shapes = {(b, 15000, 384, 64): 4 if b == 8 else 2
                   for b in (1, 2, 4, 8)}
    if shapes != want_shapes:
        raise AssertionError(f"kernel 1 shapes {shapes}, want {want_shapes}")

    # the portable program is stored on the CPU: load_exported runs it
    # there as it is, on 3 clouds, against the scatter engine on the card
    from sonet_torch.serving import load_exported
    fn, _ = load_exported(arts["portable"], device="cpu")
    t0 = time.perf_counter()
    on_cpu = fn(*(clouds[n][:3] for n in names))
    took = time.perf_counter() - t0
    d, same = _served_apart(on_cpu, want_s[3])
    log(f"load_exported [portable] on the CPU: 3 clouds in {took:.3f} s, "
        f"{d:.3g} of the largest entry from the scatter engine on the card "
        f"(equal {same})")
    if d > LOGIT_RTOL:
        raise AssertionError("the portable artifact answers otherwise on "
                             "the CPU")

    # the portable program in a process that cannot import sonet_torch:
    # on the card (moved there by torch's own pass), and on the CPU with
    # the card hidden, as on a host without one
    code = ("import sys, numpy as np, torch\n"
            "z = np.load(sys.argv[1])\n"
            "dev = sys.argv[4]\n"
            "ep = torch.export.load(sys.argv[2] + '/model.pt2')\n"
            "if dev == 'cuda':\n"
            "    from torch.export.passes import move_to_device_pass\n"
            "    ep = move_to_device_pass(ep, dev)\n"
            "elif torch.cuda.is_available():\n"
            "    sys.exit(3)\n"
            "with torch.no_grad():\n"
            "    out = ep.module()(*(torch.from_numpy(z[k]).to(dev) for k in "
            "('pc', 'sn', 'node')))\n"
            "np.save(sys.argv[3], out.float().cpu().numpy())\n"
            "sys.exit(1 if [m for m in sys.modules if m.startswith('sonet')]"
            " else 0)\n")
    for dev, n_clouds in (("cuda", 8), ("cpu", 3)):
        x = {n: clouds[n][:n_clouds] for n in names}
        np.savez(os.path.join(runs, "export_x.npz"), **x)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        if dev == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        child_out = os.path.join(runs, "export_child.npy")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code,
                            os.path.join(runs, "export_x.npz"),
                            arts["portable"], child_out, dev],
                           cwd=arts["portable"], env=env,
                           capture_output=True, text=True, timeout=300)
        took = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"the portable artifact did not load alone "
                                 f"on {dev} (exit code {r.returncode}): "
                                 f"{r.stderr[-2000:]}")
        d, same = _served_apart(np.load(child_out), want_s[n_clouds])
        log(f"a process without sonet_torch loaded the portable model.pt2 "
            f"on {dev}{' (the card hidden)' if dev == 'cpu' else ''} and "
            f"answered {n_clouds} clouds in {took:.3f} s, {d:.3g} of the "
            f"largest entry from the scatter engine on the card (equal "
            f"{same})")
        if d > LOGIT_RTOL:
            raise AssertionError(f"the portable artifact answers otherwise "
                                 f"alone on {dev}")

    # 16 concurrent B'=1 requests through make_server on the artifact
    engine = engines["cuda"]
    direct = engine.predict({n: clouds[n][:16] for n in names})
    engine.start_microbatch(5.0)
    srv = serve.make_server(engine, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def body(i):
        buf = io.BytesIO()
        np.savez(buf, **{n: clouds[n][i:i + 1] for n in names})
        return buf.getvalue()

    got = [None] * 16

    def ask(i):
        _, raw = _post(url + "/v1/predict?format=npz", body(i),
                       "application/x-npz")
        with np.load(io.BytesIO(raw)) as z:
            got[i] = z["output"]

    try:
        r0 = engine.graph.replays
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        far = [i for i in range(16) if got[i] is None
               or _served_apart(got[i][0], direct[i])[0] > LOGIT_RTOL]
        log(f"make_server on the artifact: 16 concurrent B'=1 requests in "
            f"{engine.graph.replays - r0} replays, {engine.stats()}; answers "
            f"off their direct predict {far}")
        if far:
            raise AssertionError("the artifact's daemon answered otherwise")
    finally:
        serve.drain_server(srv, engine)

    # sonet-torch serve --artifact, as a process
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sonet_torch.cli", "serve", "--artifact",
         arts["cuda"], "--device", "cuda", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"sonet-torch serve --artifact did not "
                                 f"start: {proc.communicate()[1][-2000:]}")
        first = json.loads(line)
        _, raw = _post(f"http://127.0.0.1:{first['port']}/v1/predict"
                       "?format=npz", body(0), "application/x-npz")
        with np.load(io.BytesIO(raw)) as z:
            d, same = _served_apart(z["output"][0], direct[0])
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    log(f"sonet-torch serve --artifact: {first}; one B'=1 request "
        f"{d:.3g} of the largest entry from the direct predict (equal "
        f"{same}); drained with exit code {proc.returncode}")
    if proc.returncode != 0 or d > LOGIT_RTOL or first["device"] != "cuda":
        raise AssertionError(f"sonet-torch serve --artifact failed: "
                             f"{err[-2000:]}")
    return launches, replays



# ---------------------------------------------------------------------------
# reference checkpoints, remat, the profiling utilities, the dashboard
# ---------------------------------------------------------------------------

def phase_import_ckpt(kernel_counters, on_path, run, runs):
    """The "reproduce" run written out as the reference's ``.pth`` files by
    ``compat.export_reference_checkpoint``, read back by ``sonet-torch
    import-ckpt`` into a new run, and that run served by
    ``ServingEngine.from_run`` on the card: its answers equal (``==``) the
    original run's (float32 weights make the round trip bit for bit),
    kernel 1 at (8, 15000, 384).  The same files against another
    ``--classes`` fail before anything is written.  Returns (the launches
    from the imported engine's warm-up on, its replays)."""
    import numpy as np
    import torch
    from sonet_torch import compat
    from sonet_torch.config import load_config
    from sonet_torch.serving import ServingEngine

    cfg = load_config(os.path.join(run, "config.json"))
    pth = compat.export_reference_checkpoint(run, os.path.join(runs, "pth"))
    log(f"export_reference_checkpoint: "
        f"{sorted(os.path.basename(p) for p in pth.values())}, "
        f"{sum(os.path.getsize(p) for p in pth.values())} bytes")
    flags = ["--encoder", pth["encoder"], "--classifier", pth["classifier"],
             "--preset", "modelnet40"]
    wrong = os.path.join(runs, "imported_wrong")
    try:
        _cli(["import-ckpt", "--device", "cuda", "--out", wrong, "--classes",
              "10"] + flags)
    except ValueError as e:
        if "does not fit" not in str(e) or os.path.exists(wrong):
            raise
        log(f"import-ckpt with --classes 10: refused before writing "
            f"({str(e).splitlines()[1].strip()} ...)")
    else:
        raise AssertionError("import-ckpt took files of another --classes")
    new = os.path.join(runs, "imported")
    _cli(["import-ckpt", "--device", "cuda", "--out", new, "--step", "10"]
         + flags)
    clouds = _clouds(np, 41, cfg, seed=41)
    req = {n: clouds[n] for n in ("pc", "sn", "node")}
    want = ServingEngine.from_run(run, device="cuda").predict(req)
    record, shapes = _kernel1_shapes()
    _reset(kernel_counters)
    with _GraphCounter() as graphs, record():
        engine = ServingEngine.from_run(new, device="cuda")
        engine.warmup()
        got = engine.predict(req)
        torch.cuda.synchronize()
    launches = _launch_counts(kernel_counters)
    same = got.shape == want.shape and bool((got == want).all())
    log(f"the imported run served, 41 clouds: "
        f"{'equal' if same else 'DIFFERENT'} to the original run's answers "
        f"(max abs diff "
        f"{float(np.abs(got - want).max())}); kernel 1 calls by shape "
        f"{shapes}, launches {launches}, {graphs.captures} captures, "
        f"{graphs.replays} replays")
    if not same:
        raise AssertionError("the imported run answers otherwise than the run "
                             "it was exported from")
    if set(shapes) != {(8, 15000, 384, 64)} or not all(
            launches[n] for n in on_path):
        raise AssertionError("import_ckpt: kernel 1 not launched at "
                             "(8, 15000, 384)")
    return launches, graphs.replays


def _step_state(state):
    return {"model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "grad": {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()
                     if p.grad is not None}}


def _max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def phase_train_remat(kernel_counters, on_path):
    """A ``config.modelnet40()`` train step with ``remat=True`` and the same
    step without it, each captured (``train.graphs.StepGraph``, as the
    ``Trainer`` runs it on a card) from the same weights, batch and
    generator state: the loss, the gradients, the update and the running
    statistics equal (``==``), or, where a kernel is not deterministic,
    within ``CAPTURED_RTOL`` with the largest difference printed; each
    step's peak memory (``max_memory_allocated``, reset before it), eager
    and over its capture, and its time by events.  Returns (the launches of
    both steps' warm-ups and captures, their replays)."""
    import numpy as np
    import torch
    from sonet_torch import config, train
    from sonet_torch.models import build_model
    from sonet_torch.train.graphs import StepGraph
    from sonet_torch.train.state import set_capturable

    dev = torch.device("cuda")
    base = config.modelnet40()
    B, spe = base.batch_size, 100
    clouds = _clouds(np, B, base, seed=5)
    clouds["label"] = np.random.RandomState(6).randint(0, base.classes, B)
    batch = {n: torch.from_numpy(a).to(dev) for n, a in clouds.items()}
    init = build_model(base, device=dev, seed=0).state_dict()
    out, records = {}, {}
    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        for remat in (False, True):
            cfg = base.replace(remat=remat)
            model = build_model(cfg, device=dev)
            model.load_state_dict(init)
            state = train.init_state(cfg, device=dev, model=model,
                                     steps_per_epoch=spe)
            train_step, _ = train.make_steps(cfg, spe)
            gen = torch.Generator(device=dev).manual_seed(9)
            # eager: the peak of one step, and the state put back
            eager_state = train.init_state(
                cfg, device=dev, steps_per_epoch=spe,
                model=build_model(cfg, device=dev))
            eager_state.model.load_state_dict(init)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            train_step(eager_state, batch,
                       torch.Generator(device=dev).manual_seed(9))
            torch.cuda.synchronize()
            eager_peak = torch.cuda.max_memory_allocated() - base_mem
            del eager_state
            set_capturable(state.optimizer, True)
            names = tuple(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            graph = StepGraph(
                lambda *t: train_step(state, dict(zip(names, t)), gen)[1],
                dev, generators=(gen,))
            metrics = graph(*batch.values())
            torch.cuda.synchronize()
            capture_peak = torch.cuda.max_memory_allocated() - base_mem
            loss = metrics["loss"].clone()
            out[remat] = dict(_step_state(state), loss=loss)

            def replay():
                graph(*batch.values())
            step_ms = time_ms(replay, reps=10)
            graph.reset()
            del graph
            records[remat] = (eager_peak, capture_peak, step_ms)
            log(f"modelnet40 train step, remat={remat}: loss "
                f"{float(loss)}, peak memory above the state: eager "
                f"{eager_peak / 2 ** 20:.1f} MiB, over the warm-up and "
                f"capture {capture_peak / 2 ** 20:.1f} MiB; captured step "
                f"{step_ms:.4f} ms by events (10 more replays)")
    launches = _launch_counts(kernel_counters)
    plain, remat = out[False], out[True]
    exact = (bool(torch.equal(plain["loss"], remat["loss"]))
             and all(torch.equal(plain["grad"][k], remat["grad"][k])
                     for k in plain["grad"])
             and all(torch.equal(plain["model"][k], remat["model"][k])
                     for k in plain["model"]))
    grad_diff = _max_diff(plain["grad"], remat["grad"])
    state_diff = _max_diff(plain["model"], remat["model"])
    saved = records[False][0] - records[True][0]
    log(f"remat against the plain step: {'equal' if exact else 'NOT equal'}"
        f" (largest difference: gradients {grad_diff}, weights and running "
        f"statistics {state_diff}); remat saves "
        f"{saved / 2 ** 20:.1f} MiB of the eager step's peak "
        f"({records[True][0] / 2 ** 20:.1f} against "
        f"{records[False][0] / 2 ** 20:.1f} MiB), "
        f"{(records[False][1] - records[True][1]) / 2 ** 20:.1f} MiB over the "
        f"capture; captured step {records[True][2]:.4f} against "
        f"{records[False][2]:.4f} ms; launches {launches}, "
        f"{graphs.captures} captures, {graphs.replays} replays")
    if not exact:
        rel = abs(float(plain["loss"]) - float(remat["loss"])) / max(
            1.0, abs(float(plain["loss"])))
        num = sum(float((plain["grad"][k] - remat["grad"][k]).double()
                        .square().sum()) for k in plain["grad"])
        den = sum(float(plain["grad"][k].double().square().sum())
                  for k in plain["grad"])
        log(f"remat not bit-equal: loss {rel}, gradients "
            f"{(num / den) ** 0.5} by the relative norm (CAPTURED_RTOL "
            f"{CAPTURED_RTOL})")
        if rel > CAPTURED_RTOL or (num / den) ** 0.5 > CAPTURED_RTOL:
            raise AssertionError("the remat step disagrees with the plain one")
    if saved <= 0:
        raise AssertionError("remat did not lower the step's peak memory")
    if not all(launches[n] for n in on_path):
        raise AssertionError("train_remat: kernel 1 was not launched")
    return launches, graphs.replays


def phase_profile(kernel_counters, on_path, kernels, profile_dir=None):
    """The profiling utilities on the card: ``utils.tprof.device_time`` of
    the ``config.modelnet40()`` forward and train step (eager) within 3%
    of the reading by hand in the same run (``_busy_share``), their
    kernels bucketed by ``utils.hlocat.categorize`` with the pooling
    bucket holding exactly kernel 1's launches, and
    ``utils.profiling.scan_bench`` of kernel 1 at (8, 15000, 384) within
    5% of phase 3's graph reading.  Returns (the launches, the graph
    replays: ``scan_bench``'s)."""
    import numpy as np
    import torch
    from sonet_torch import config, train
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals
    from sonet_torch.utils import hlocat, tprof
    from sonet_torch.utils.profiling import scan_bench

    dev = torch.device("cuda")
    cfg = config.modelnet40()
    B, spe = cfg.batch_size, 100
    clouds = _clouds(np, B, cfg, seed=7)
    clouds["label"] = np.random.RandomState(8).randint(0, cfg.classes, B)
    batch = {n: torch.from_numpy(a).to(dev) for n, a in clouds.items()}
    state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=spe)
    train_step, _ = train.make_steps(cfg, spe)
    gen = torch.Generator(device=dev).manual_seed(3)
    model, ins = state.model, [batch[n] for n in ("pc", "sn", "node")]

    def forward():
        with torch.inference_mode():
            return model(*ins)[0]

    def step():
        return train_step(state, batch, gen)[1]

    counter = kernel_counters["segment_max_window"]
    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        for what, fn in (("forward", forward), ("train_step", step)):
            model.train(what == "train_step")
            fn()
            _, by_hand, _ = _busy_share(lambda: [fn() for _ in range(5)])
            before = counter.launches
            p = tprof.profile(fn, (), iters=5)
            # the first call is outside the window
            calls = (counter.launches - before - 1) / 5
            by_hand_ms = by_hand * 1e3 / 5
            cats = hlocat.categorize(p.ms)
            pool = {k: n for k, n in p.launches.items()
                    if hlocat.bucket(k) == "pooling kernel"}
            log(f"profile {what}: tprof.device_time {p.total_ms:.4f} ms, by "
                f"hand {by_hand_ms:.4f} ms ({p.total_ms / by_hand_ms - 1:+.2%}); "
                f"{sum(p.launches.values()):.0f} device rows a call; buckets "
                + ", ".join(f"{k} {v:.4f} ms ({v / p.total_ms:.1%})"
                            for k, v in sorted(cats.items(),
                                               key=lambda x: -x[1]))
                + f"; pooling rows {pool}, kernel 1's wrapper {calls} a call")
            for name, ms in sorted(p.ms.items(), key=lambda x: -x[1])[:12]:
                log(f"  {ms:9.4f} ms {p.launches[name]:6.1f}x "
                    f"[{hlocat.bucket(name)}] {name[:110]}")
            if profile_dir:
                os.makedirs(profile_dir, exist_ok=True)
                with open(os.path.join(profile_dir,
                                       f"profile_tprof_{what}.txt"), "w") as f:
                    for name, ms in sorted(p.ms.items(), key=lambda x: -x[1]):
                        f.write(f"{ms:.6f}\t{p.launches[name]:.1f}\t"
                                f"{hlocat.bucket(name)}\t{name}\n")
            if abs(p.total_ms / by_hand_ms - 1) > 0.03:
                raise AssertionError(f"profile {what}: tprof's device time is "
                                     f"not within 3% of the reading by hand")
            syms = {re.search(r"segment_max_window_\w+|fill_empty", k).group(0)
                    for k in pool}
            if (syms != {"fill_empty", "segment_max_window_bulk"}
                    or len(pool) != 2 or calls != 1
                    or any(n != calls for n in pool.values())):
                raise AssertionError(f"profile {what}: the pooling bucket is "
                                     f"not exactly kernel 1's launches")
        gen1 = torch.Generator(device=dev).manual_seed(0)
        ids = _flagship_ids(torch, 8, 5000, 64, 3, gen1, dev)
        data = torch.randn((8, 15000, 384), generator=gen1,
                           device=dev).to(torch.bfloat16)
        scan_ms = scan_bench(windowed_vals, (data, ids, 64), iters=20)
    graph_ms = kernels[0]["graph_ms"]
    log(f"scan_bench of kernel 1 at (8, 15000, 384) bf16: {scan_ms:.4f} ms "
        f"a call, phase 3's graph reading {graph_ms:.4f} ms "
        f"({scan_ms / graph_ms - 1:+.2%})")
    if abs(scan_ms / graph_ms - 1) > 0.05:
        raise AssertionError("scan_bench is not within 5% of phase 3's "
                             "graph reading")
    return _launch_counts(kernel_counters), graphs.replays


def phase_monitor(runs):
    """``utils.dashboard.make_dashboard_server`` over the run the "trainer"
    phase wrote: one request for its metrics answers the rows of its
    ``train_metrics.jsonl``."""
    from sonet_torch.utils.dashboard import make_dashboard_server
    run = os.path.join(runs, "trainer")
    with open(os.path.join(run, "train_metrics.jsonl")) as f:
        want = [json.loads(line) for line in f if line.strip()]
    srv = make_dashboard_server(run, port=0)
    try:
        status, body = _get(f"http://127.0.0.1:{srv.server_address[1]}"
                            f"/api/metrics?run=.&since=0")
    finally:
        srv.shutdown()
        srv.server_close()
    rows = json.loads(body)["rows"]
    log(f"monitor over the trainer run: status {status}, {len(rows)} rows "
        f"of {len(want)}, keys {sorted(rows[-1]) if rows else []}")
    if status != 200 or rows != want or not rows:
        raise AssertionError("the dashboard does not answer the run's rows")


def _tool_output(name, main, argv):
    """(exit code, standard output) of the quality tool ``name``'s
    ``main(argv)`` run in this process; its output is shown as it
    comes."""
    import contextlib
    import torch
    log(f"tools/{name}.py {' '.join(argv)}")
    tee, rc = _Tee(sys.stdout), 0
    with contextlib.redirect_stdout(tee):
        try:
            main(argv)
        except SystemExit as e:
            rc = e.code
    torch.cuda.synchronize()
    return rc, tee.copy.getvalue()


def phase_quality(kernel_counters, on_path, runs):
    """The quality chain's tools (``tools/torch_*``) on the card at full
    width: a ModelNet40 tree of 40 classes of 2 train and 1 test shapes, a
    ShapeNetPart tree of 16 categories of 2 and 1 and a SHREC16 tree of 55
    classes of 6 shapes, written by the port's generators at the bands'
    hardness, nodes fitted by ``prep som``; one epoch of ``torch_soak.py
    --band`` (device pipeline) on the first two, whose verdicts must be
    OUTSIDE, and of ``torch_soak_retrieval.py``, whose ground truth must
    come from the generator's blocks.  Returns (the launches of every
    kernel in the three soaks, their replays)."""
    import contextlib
    import io
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_make_modelnet_scale
    import torch_make_shapenet_scale
    import torch_make_shrec_scale
    import torch_quality
    import torch_soak
    import torch_soak_retrieval
    from sonet_torch.data import prep

    trees = {"modelnet40": os.path.join(runs, "q_mn40"),
             "shapenetpart": os.path.join(runs, "q_snpart"),
             "shrec16": os.path.join(runs, "q_shrec")}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # a line a class
        torch_make_modelnet_scale.main(
            ["--out", trees["modelnet40"], "--train_per_class", "2",
             "--test_per_class", "1", "--hardness", "0.15"])
        torch_make_shapenet_scale.main(
            ["--out", trees["shapenetpart"], "--train_per_cat", "2",
             "--test_per_cat", "1", "--hardness", "0.7"])
        torch_make_shrec_scale.main(["--out", trees["shrec16"],
                                     "--per_class", "6", "--hardness",
                                     "0.35"])
    t1 = time.perf_counter()
    for root in trees.values():
        prep.main(["som", "--root", root, "--device", "cuda"])
    torch.cuda.synchronize()
    log(f"quality trees: 120 + 48 + 330 shapes generated in "
        f"{t1 - t0:.3f} s, their nodes fitted in "
        f"{time.perf_counter() - t1:.3f} s (host clock)")
    if any(torch_quality.need_som(p, root, 8) for p, root in trees.items()):
        raise AssertionError("prep som left a tree without nodes")

    _reset(kernel_counters)
    with _GraphCounter() as graphs:
        soaks = {p: _tool_output("torch_soak", torch_soak.main, [
            "--preset", p, "--dataroot", trees[p], "--epochs", "1",
            "--band", "--input_pipeline", "device", "--out",
            os.path.join(runs, "q_soak")])
            for p in ("modelnet40", "shapenetpart")}
        got = {}
        r_rc, _ = _tool_output(
            "torch_soak_retrieval",
            lambda a: got.setdefault("r", torch_soak_retrieval.main(a)),
            ["--dataroot", trees["shrec16"], "--epochs", "1",
             "--per_class_block", "6", "--out",
             os.path.join(runs, "q_soak_shrec")])
    launches = _launch_counts(kernel_counters)
    log(f"torch_soak_retrieval: rc {r_rc}; in the three soaks "
        f"{graphs.captures} captures, {graphs.replays} replays, kernel "
        f"launches {launches}")
    for preset, key in (("modelnet40", "accuracy"), ("shapenetpart", "iou")):
        rc, out = soaks[preset]
        value, inside, ev, clouds = torch_quality.parse_soak_output(out, rc)
        log(f"torch_soak {preset}: rc {rc}, parsed value {value}, inside "
            f"{inside}, eval {ev}, {clouds} clouds/s")
        band = [ln for ln in out.splitlines()
                if ln.startswith("band check:")]
        # one epoch on 80 or 32 shapes cannot reach a band
        if rc != 1 or len(band) != 1 or "OUTSIDE" not in band[0] or (
                inside is not False or value is None
                or value != round(ev[key], 4)):
            raise AssertionError(f"torch_soak {preset}: want rc 1 and one "
                                 f"OUTSIDE band line that the parser reads")
        if "lr 0.001, captures 1)" not in out:
            raise AssertionError(f"torch_soak {preset}: the epoch line "
                                 f"lacks its lr or its capture")
    metrics, ids, labels = got["r"]
    ranks = os.listdir(os.path.join(runs, "q_soak_shrec", "rank"))
    log(f"torch_soak_retrieval: {len(ids)} test ids, ground truth "
        f"{sorted(set(labels.tolist()))[:5]}..., metrics {metrics}")
    if r_rc != 0 or len(ranks) != 55 or len(set(labels.tolist())) != 55 or (
            not (labels == ids // 6).all() or not labels.any()):
        raise AssertionError("torch_soak_retrieval: want 55 rank files and "
                             "the ground truth of every class")
    # train and eval of each soak, and the retrieval's scoring: a capture
    # each, kernel 1 in its warm-up and its capture; one replay a step
    want_replays = 80 // 8 + 5 + 32 // 8 + 2 + 220 // 8 + 7 + 7
    if (graphs.captures, graphs.replays) != (7, want_replays):
        raise AssertionError(f"want 7 captures and {want_replays} replays")
    for n in on_path:
        if launches[n] != 14:
            raise AssertionError(f"{n} launched {launches[n]} times, want "
                                 f"a warm-up and a capture of 7 graphs")
    return launches, graphs.replays


def _get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


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
    """torch.profiler over 5 calls of ``fn`` (``utils.tprof.profile``): the
    profiler's table to ``out_dir/profile_<what>.txt``; the device time,
    its share of the window and its buckets (``utils.hlocat.categorize``)
    to stdout."""
    from sonet_torch.utils import hlocat, tprof
    os.makedirs(out_dir, exist_ok=True)
    p = tprof.profile(fn, (), iters=5)
    path = os.path.join(out_dir, f"profile_{what}.txt")
    with open(path, "w") as f:
        f.write(p.table)
    log(f"profile: 5 x {what}, wall {p.wall_ms:.3f} ms a call, device busy "
        f"{p.total_ms:.3f} ms ({p.total_ms / p.wall_ms:.1%} under the "
        f"profiler) in {sum(p.launches.values()):.0f} kernels, copies and "
        f"memsets a call; table in {path}; buckets "
        + ", ".join(f"{k} {v / p.total_ms:.1%}" for k, v in sorted(
            hlocat.categorize(p.ms).items(), key=lambda x: -x[1])))
    for name, ms in sorted(p.ms.items(), key=lambda x: -x[1])[:25]:
        log(f"  {ms:9.4f} ms/{what} {p.launches[name]:6.1f}x  "
            f"[{hlocat.bucket(name)}] {name[:100]}")


# ---------------------------------------------------------------------------
# the mesh phases: ranks launched as a user launches them, with torchrun
# ---------------------------------------------------------------------------

# the one card, named: its ranks share it, so their group runs over gloo
# (parallel/distributed.py's backend rule); a world of one on "cuda" takes
# NCCL
MESH_DEVICE = "cuda:0"
MESH_RANKS = 2
# a (data, points) step against the one-process step from the same
# weights and batch: the loss within 2% (the bf16 rule: the mesh sums the
# BatchNorm statistics and cluster sums in another order, which moves bf16
# roundings by a few ulp)
MESH_LOSS_RTOL = 2e-2
# ... and its gradients and update not in bf16: there the statistics
# summed in another order move nearly tied bf16 pooling winners and
# ReLUs, and the train-mode gradients with them by ~25% (as kernel
# against scatter pooling does, GRAD_POOL_CASES), and Adam's first step,
# about +-lr an entry by the sign of its gradient, follows: over (2, 1)
# the bf16 gradients read 2.65e-1 and the update 9.5e-2 of one process's
# while the loss read 6.2e-3 ("NVIDIA H100 80GB HBM3, 700.00 W").  The
# bf16 step is held by its loss (and ten steps falling); the gradients
# and the update are held in float32, at full width
MESH_UPDATE_DTYPE = "float32"
# the float32 step against one process's, by the relative norm of the
# difference over every tensor, each limit read beside one process's own
# sensitivity: the same step from weights each scaled by 1 + NUDGE N(0, 1),
# about one float32 rounding.  On the H100 (700 W) the mesh read, and the
# nudge beside it: loss 2.2e-7 to 6.8e-7; gradients 2.6e-4 to 6.6e-4
# (classifier, segmenter) and 1.84e-3 (autoencoder; nudge 3.0e-4 to
# 1.43e-3); update 3.0e-3 to 4.5e-3 and 1.82e-2 (nudge 3.2e-3 to 1.45e-2).
# The autoencoder's update is one process's own: 2 of its 28,672 Chamfer
# pairs pick another nearest point over the mesh and 1 under the nudge,
# each a near-tie (gap 1.8e-5 of the distance at most), and Adam's first
# step turns the gradient that moves with them into flipped signs.  A
# planted fault, node-level gradients summed over ``points``, reads 0.57
# to 0.92 on the gradients and the honest 3.4e-3 to 1.83e-2 on the update
# (Adam's first step does not see a gradient's scale): the gradient gate
# lies 11x above the largest honest reading and 28x below the smallest
# planted one
MESH_F32_LOSS_RTOL = 1e-4
MESH_GRAD_RTOL = 2e-2
MESH_UPDATE_RTOL = 5e-2
NUDGE = 1e-7
# kernel 1's per-rank shape at config.modelnet40() width, M=64
MESH_KERNEL1 = {(2, 1): (4, 15000, 384, 64), (1, 2): (8, 7500, 384, 64)}


def _torchrun(nproc, args, out_path):
    """Start ``python -m torch.distributed.run --standalone`` with
    ``nproc`` processes of ``args``, its output to ``out_path``.  Returns
    the Popen."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="4")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc)] + args
    log("launch: " + " ".join(cmd[1:]))
    with open(out_path, "w") as out:
        return subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=repo)


def _wait_ranks(p, what, log_path, timeout=600):
    """Wait for a ``_torchrun`` launch; any rank's failure ends the smoke.
    Returns its output."""
    try:
        rc = p.wait(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        log(text[-6000:])
        raise AssertionError(f"{what}: the ranks exited with {rc}")
    return text


def _run_ranks(nproc, args, timeout, out_path):
    """Run ``_torchrun`` to its end; any rank's failure ends the smoke."""
    return _wait_ranks(_torchrun(nproc, args, out_path),
                       f"{nproc} ranks of {args[:2]}", out_path, timeout)


def _rank_results(out_dir, name, nproc):
    """What each rank of a launch wrote (``<name>.<rank>.json``)."""
    res = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"{name}.{r}.json")) as f:
            res.append(json.load(f))
    return res


def _timed_collectives():
    """Wrap torch.distributed's all_reduce and broadcast: returns a dict
    that adds up their count and host-clock seconds (the card synced
    first, so a collective does not absorb the work queued before it;
    gloo syncs on its own copy to the host anyway)."""
    import torch
    import torch.distributed as dist
    spent = {"calls": 0, "s": 0.0}

    def timed(real):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        return call
    dist.all_reduce = timed(dist.all_reduce)
    dist.broadcast = timed(dist.broadcast)
    return spent


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _grad_rel_diff(want, got) -> float:
    """The relative norm, over every gradient, of ``got - want``."""
    num = sum(float((got[n] - g).double().square().sum())
              for n, g in want.items())
    den = sum(float(g.double().square().sum()) for g in want.values())
    return (num / den) ** 0.5


def _sharded_pooling_check(mesh, dev):
    """Kernel 1 under a (1, 2) mesh at the main path's per-rank shape
    (8, 7500, 384) bf16, M=64: ``windowed_vals_sharded`` (the kernel on
    this rank's block, then the all-reduce MAX over ``points``) against
    its plain version (the plain ``windowed_vals`` and the same
    all-reduce) and against the kernel on the whole clouds, all ``==``.
    Returns (equal to the plain version, equal to the whole clouds' rows,
    max abs difference)."""
    import torch
    import torch.distributed as dist
    from sonet_torch.ops.cuda.segment_max_window import (windowed_vals,
                                                         windowed_vals_plain)
    from sonet_torch.ops.segment_fast import windowed_vals_sharded
    from sonet_torch.parallel import collectives
    from sonet_torch.parallel.mesh import block
    gen = torch.Generator(device=dev).manual_seed(11)
    B, M = 8, 64
    ids = _flagship_ids(torch, B, 5000, M, 3, gen, dev)        # (8, 15000)
    data = torch.randn((B, ids.shape[1], 384), generator=gen,
                       device=dev).to(torch.bfloat16)
    d = block(data, ("data", "points"), mesh).contiguous()
    i = block(ids, ("data", "points"), mesh).contiguous()
    with collectives.use_mesh(mesh):
        got = windowed_vals_sharded(d, i, M)
        plain = collectives.all_reduce(
            _plain_by_clouds(windowed_vals_plain, d, i, M), ("points",),
            op=dist.ReduceOp.MAX)
    whole = block(windowed_vals(data, ids, M), ("data",), mesh)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    return (bool(torch.equal(got, plain)), bool(torch.equal(got, whole)),
            err)


def _mesh_counters():
    """Every kernel's launch counter by its row's name: kernels 1 and 2,
    the fused BatchNorm by mode, node pooling's backward, node
    recentering's segment sums, Adam's update and the three sorts."""
    from sonet_torch.ops.cuda.segment_argmax import segment_argmax
    from sonet_torch.ops.cuda.segment_max_grad import segment_max_grad
    from sonet_torch.ops.cuda.segment_max_window import windowed_vals
    from sonet_torch.ops.cuda.adam_step import adam_step
    from sonet_torch.ops.cuda.segment_sums import segment_sums
    from sonet_torch.ops.cuda.sorts import (node_sort, smallest_k,
                                            subset_select)
    return {"segment_max_window": windowed_vals,
            "segment_argmax": segment_argmax, **batchnorm_counters(),
            "segment_max_grad": segment_max_grad,
            "segment_sums": segment_sums, "adam_step": adam_step,
            "node_sort": node_sort, "smallest_k": smallest_k,
            "subset_select": subset_select}


def _planted_sync_grads(model, mesh):
    """A fault for the float32 gate to catch: every gradient summed over
    the whole mesh, node-level ones too (counted P times along
    ``points``).  Adam's first step follows the gradients' signs, so the
    update alone cannot see it."""
    import torch.distributed as dist
    from sonet_torch.parallel import collectives
    d = collectives.axis_size("data", mesh)
    for p in model.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad)
            p.grad.div_(d)


def _chamfer_calls(record):
    """A context that records the (reconstruction, input cloud) of every
    Chamfer call of a train step's loss into ``record``."""
    import contextlib

    from sonet_torch.train import loops

    @contextlib.contextmanager
    def ctx():
        real = loops.chamfer

        def recording(predict_pc, gt_pc):
            record.append((predict_pc.detach().clone(),
                           gt_pc.detach().clone()))
            return real(predict_pc, gt_pc)
        loops.chamfer = recording
        try:
            yield
        finally:
            loops.chamfer = real
    return ctx()


def _chamfer_flips(one, other):
    """Of the Chamfer pairs that ``one`` run's calls pick (each
    reconstructed point's nearest input point and each input point's
    nearest reconstructed point, in float64 from the recorded clouds), how
    many ``other`` run picks differently, and the largest gap, relative
    to the distance, between the two picks under ``one``'s distances:
    a pair that flips on a rounding-level change of the reconstruction is
    a near-tie.  Also the largest difference between the reconstructions,
    relative to their largest coordinate."""
    import torch
    pairs = flips = 0
    gap = pred = 0.0
    for (pa, ga), (pb, gb) in zip(one, other):
        if not torch.equal(ga, gb):
            raise AssertionError("the two runs' Chamfer inputs differ")
        da = torch.cdist(pa.double(), ga.double()).square()   # (B, P, N)
        db = torch.cdist(pb.double(), ga.double()).square()
        pred = max(pred, float((pa - pb).abs().max() / pa.abs().max()))
        for dim in (-1, -2):
            ia, ib = da.argmin(dim, keepdim=True), db.argmin(dim, keepdim=True)
            moved = ia != ib
            pairs += ia.numel()
            flips += int(moved.sum())
            if moved.any():
                near = da.gather(dim, ia)
                rel = (da.gather(dim, ib) - near) / near.clamp_min(1e-30)
                gap = max(gap, float(rel[moved].max()))
    return {"pairs": pairs, "flips": flips, "max_gap": gap,
            "pred_rel": pred}


def mesh_steps_worker(out_dir):
    """One rank of phases "mesh", "mesh_segment" and "mesh_autoencode"
    (launched by ``phase_mesh_steps``).  For each task and mesh, in the
    configuration's bf16: the first train step against the one-process
    step from the same weights and batch (rank 0 runs that one alone; the
    loss, and the gradients and the update by relative norm), then
    TRAIN_STEPS steps on one batch over the mesh with both kernels'
    launches and the graph replays counted from 0, each timed with its
    gloo collectives apart; then the first step again in float32
    (``MESH_UPDATE_DTYPE``), where the gradients and the update are held,
    beside one process's own sensitivity (the same step from weights one
    rounding away), the autoencoder's Chamfer pairs that flip, and, where
    the points axis is split, a planted fault (``_planted_sync_grads``)
    that the gate must refuse.  Writes ``steps.<rank>.json``."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from sonet_torch import config, train
    from sonet_torch.parallel import (collectives, make_mesh,
                                      maybe_init_distributed, shard_batch)
    from sonet_torch.parallel.distributed import all_gather
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_init_distributed("auto", MESH_DEVICE)
    rank = dist.get_rank()
    dev = torch.device(MESH_DEVICE)
    spent = _timed_collectives()
    record, shapes = _kernel1_shapes()
    counters = _mesh_counters()

    def first_step(cfg, batch, mesh, nudge=False):
        """(loss, gradients, state before, state after) of one train step
        from seed 0's weights (``nudge``: each weight moved by about one
        float32 rounding, seeded), over ``mesh`` (this rank's block) or in
        one process."""
        st = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=100,
                              mesh=mesh)
        if nudge:
            g = torch.Generator(device=dev).manual_seed(5)
            with torch.no_grad():
                for p in st.model.parameters():
                    p.mul_(1 + NUDGE * torch.randn(p.shape, generator=g,
                                                   device=dev))
        step, _ = train.make_steps(cfg, 100, mesh=mesh)
        before = _state_tensors(st)
        gen = torch.Generator(device=dev).manual_seed(7)
        loss = float(step(st, batch, gen)[1]["loss"])
        return loss, _grads(st.model), before, _state_tensors(st), st, step

    def shifted(before, after, to):
        """``after``'s update applied to ``to``, for update_rel_diff."""
        return {k: after[k] - before[k] + to[k] for k in to}

    res = {"pooling": _sharded_pooling_check(make_mesh((1, 2)), dev)}
    for phase, cfg, meshes in (
            ("mesh", config.modelnet40(), ((2, 1), (1, 2))),
            ("mesh_segment", config.shapenetpart(), ((1, 2),)),
            ("mesh_autoencode", config.autoencoder(), ((1, 2),))):
        t_phase = time.perf_counter()
        cfg = cfg.replace(dropout=0.0)
        B = cfg.batch_size
        clouds = _clouds(np, B, cfg, seed=3)
        if cfg.task == "classify":
            clouds["label"] = np.random.RandomState(4).randint(
                0, cfg.classes, B)
        batch = {n: torch.from_numpy(a).to(dev) for n, a in clouds.items()}
        for dtype in (cfg.compute_dtype, MESH_UPDATE_DTYPE):
            dcfg = cfg.replace(compute_dtype=dtype)
            main = dtype == cfg.compute_dtype
            pairs = cfg.task == "autoencode" and not main
            one = None

            def chamfer_calls(calls):
                return (_chamfer_calls(calls) if pairs
                        else contextlib.nullcontext())
            if rank == 0:     # one process; in bf16 timed over 3 more steps
                calls_one, calls_nudged = [], []
                with chamfer_calls(calls_one):
                    loss, grads, before, after, st, step = first_step(
                        dcfg, batch, None)
                one = {"loss": loss, "grads": grads, "after": after,
                       "calls": calls_one}
                if not main:  # the same step again: one process's own spread
                    *_, again, st2, _ = first_step(dcfg, batch, None)
                    one["again"] = update_rel_diff(before, after, again)
                    with chamfer_calls(calls_nudged):
                        _, g2, b2, a2, st2, _ = first_step(dcfg, batch, None,
                                                           nudge=True)
                    one["nudged"] = {
                        "grad_rel_diff": _grad_rel_diff(grads, g2),
                        "update_rel_diff": update_rel_diff(
                            before, after, shifted(b2, a2, before))}
                    if pairs:
                        one["nudged"]["chamfer"] = _chamfer_flips(
                            calls_one, calls_nudged)
                    del st2
                if main:
                    gen = torch.Generator(device=dev).manual_seed(8)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        step(st, batch, gen)
                    torch.cuda.synchronize()
                    one["ms"] = (time.perf_counter() - t0) / 3 * 1e3
                del st
            for shape in meshes:
                mesh = make_mesh(shape)
                local = {k: v.contiguous() for k, v in
                         shard_batch(batch, mesh).items()}
                key = f"{phase} {shape} {dtype}"
                _reset(counters)
                shapes.clear()
                spent["calls"] = 0
                calls = []
                # the main path: its launches and replays from 0
                with record(), _GraphCounter() as graphs, \
                        chamfer_calls(calls):
                    c0, t0 = spent["s"], time.perf_counter()
                    loss, grads, before, first, st, step = first_step(
                        dcfg, local, mesh)
                    losses, times, coll = [loss], [], []
                    spent["calls"] = 0       # the steps', not the set-up's
                    gen = torch.Generator(device=dev).manual_seed(8)
                    for _ in range(TRAIN_STEPS - 1 if main else 0):
                        c0, t0 = spent["s"], time.perf_counter()
                        losses.append(float(step(st, local, gen)[1]["loss"]))
                        times.append((time.perf_counter() - t0) * 1e3)
                        coll.append((spent["s"] - c0) * 1e3)
                res[key] = {
                    "launches": _launch_counts(counters),
                    "replays": graphs.replays, "ran": graphs.ran,
                    "shapes": {str(list(k)): n for k, n in shapes.items()},
                    "losses": losses}
                del st
                if main:
                    res[key].update(
                        step_ms=statistics.median(times),
                        collective_ms=statistics.median(coll),
                        collectives_a_step=round(
                            spent["calls"] / (TRAIN_STEPS - 1)))
                # the reconstructions over the mesh against the whole
                # input cloud, gathered from the points ranks
                calls = [(p, all_gather(g, ("points",), mesh, lead=1))
                         for p, g in calls]
                planted = None
                if not main and shape[1] > 1:   # a fault the gate must see
                    real = collectives.sync_grads
                    collectives.sync_grads = _planted_sync_grads
                    try:
                        _, pg, pb, pa, st, _ = first_step(dcfg, local, mesh)
                    finally:
                        collectives.sync_grads = real
                    del st
                    if rank == 0:
                        planted = {
                            "grad_rel_diff": _grad_rel_diff(one["grads"], pg),
                            "update_rel_diff": update_rel_diff(
                                before, one["after"], shifted(pb, pa,
                                                              before))}
                if rank == 0:
                    res[key].update(
                        one_loss=one["loss"], one_ms=one.get("ms"),
                        one_again=one.get("again"),
                        nudged=one.get("nudged"), planted=planted,
                        grad_rel_diff=_grad_rel_diff(one["grads"], grads),
                        update_rel_diff=update_rel_diff(
                            before, one["after"], first))
                    if pairs:
                        res[key]["chamfer"] = _chamfer_flips(one["calls"],
                                                             calls)
        res[phase + " s"] = time.perf_counter() - t_phase
    with open(os.path.join(out_dir, f"steps.{rank}.json"), "w") as f:
        json.dump(res, f)


def mesh_nccl_worker(out_dir):
    """The world of one over NCCL (launched by ``phase_mesh_steps``): the same
    train step captured twice, over no mesh and over the (1, 1) mesh of
    the NCCL group (its gradients and metrics all-reduced inside the
    graph), one replay each from the same weights, batch and generator
    state: the two states must be equal.  Writes ``nccl.0.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from sonet_torch import config, train
    from sonet_torch.parallel import make_mesh, maybe_init_distributed
    from sonet_torch.train.graphs import StepGraph
    from sonet_torch.train.state import set_capturable, snapshot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_init_distributed("auto", "cuda")
    backend = dist.get_backend()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = config.modelnet40().replace(dropout=0.0)
    clouds = _clouds(np, cfg.batch_size, cfg, seed=3)
    clouds["label"] = np.random.RandomState(4).randint(0, cfg.classes,
                                                       cfg.batch_size)
    batch = {n: torch.from_numpy(a).pin_memory() for n, a in clouds.items()}
    states, graphs = [], []
    counters = _mesh_counters()
    _reset(counters)
    with _GraphCounter() as counted:
        for mesh in (None, make_mesh((1, 1))):
            st = train.init_state(cfg, device=dev, seed=0,
                                  steps_per_epoch=100, mesh=mesh)
            set_capturable(st.optimizer, True)
            step, _ = train.make_steps(cfg, 100, mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(7)
            g = StepGraph(lambda s=st, f=step, r=gen, **b: f(s, b, r)[1],
                          dev, generators=(gen,),
                          snapshot=lambda s=st: snapshot(s), mesh=mesh)
            g(**batch)
            torch.cuda.synchronize()
            states.append(_state_tensors(st))
            graphs.append(g)
    same = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    res = {"backend": backend, "equal": same,
           "eager": [g.eager for g in graphs],
           "captures": counted.captures, "replays": counted.replays,
           "ran": counted.ran,
           "launches": _launch_counts(counters)}
    with open(os.path.join(out_dir, "nccl.0.json"), "w") as f:
        json.dump(res, f)


def _rank_cli_args(out_base, argv):
    """This script's ``--rank_cli`` arguments for ``sonet-torch <argv>``:
    the command's own arguments go through a file, since torchrun's parser
    would take an abbreviation of its options among them (``--run`` for
    ``--run-path``)."""
    with open(out_base + ".argv.json", "w") as f:
        json.dump(argv, f)
    return [os.path.abspath(__file__), "--rank_cli", out_base]


def rank_cli(out_base):
    """One rank of ``sonet-torch <argv>`` under torchrun (``phase_mesh_trainer``'s
    trainer runs; ``argv`` from ``<out_base>.argv.json``): the command as a
    user runs it, both kernels' launches and the graph replays counted
    from 0 around it; writes ``<out_base>.<rank>.json``."""
    from sonet_torch import cli
    with open(out_base + ".argv.json") as f:
        argv = json.load(f)
    record, shapes = _kernel1_shapes()
    counters = _mesh_counters()
    _reset(counters)
    with record(), _GraphCounter() as graphs:
        rc = cli.main(argv)
    rank = int(os.environ["RANK"])
    with open(f"{out_base}.{rank}.json", "w") as f:
        json.dump({"rc": rc, "launches": _launch_counts(counters),
                   "replays": graphs.replays, "ran": graphs.ran,
                   "shapes": {str(list(k)): n for k, n in shapes.items()}},
                  f)
    return rc


def _rank_pid(parent, rank):
    """The pid of the process of ``rank`` among torchrun ``parent``'s
    children, from their environments under /proc."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != parent:
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if f"RANK={rank}".encode() in env:
            return int(pid)
    return None


def _check_kernel1(what, results, want):
    """Every rank launched kernel 1, at ``want`` only."""
    for r, got in enumerate(results):
        n = got["launches"]["segment_max_window"]
        if n < 1 or set(got["shapes"]) != {str(list(want))}:
            raise AssertionError(f"{what}, rank {r}: kernel 1 launched "
                                 f"{n} times at "
                                 f"{got['shapes']}, want {want} only")


def phase_mesh_steps(runs, card):
    """Phases "mesh", "mesh_segment" and "mesh_autoencode": two ranks on
    the one card, ``MESH_DEVICE``, over gloo, launched with torchrun.
    Returns ({path: {kernel: launches over its ranks}}, {path: {kernel:
    graph replays that ran it over its ranks}})."""
    me = os.path.abspath(__file__)
    out = os.path.join(runs, "mesh")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    _run_ranks(MESH_RANKS, [me, "--mesh_steps", out], 600,
               os.path.join(out, "steps.log"))
    took = time.perf_counter() - t0
    return check_mesh_steps(_rank_results(out, "steps", MESH_RANKS), card,
                            took)


def check_mesh_steps(res, card, took):
    """Hold what the ranks of ``mesh_steps_worker`` wrote (``res``, by
    rank); returns what ``phase_mesh_steps`` returns."""
    from sonet_torch import config
    launches, ran = {}, {}
    pooling = [r["pooling"] for r in res]
    log(f"kernel 1 under the (1, 2) mesh at (8, 7500, 384) a rank on {card}: "
        f"the kernel and the all-reduce MAX equal to the plain version and "
        f"to the whole clouds' kernel, by rank: {pooling}")
    if not all(p[0] and p[1] for p in pooling):
        raise AssertionError("kernel 1 under the mesh differs from its plain "
                             "version")
    for phase, task_cfg in (("mesh", config.modelnet40()),
                            ("mesh_segment", config.shapenetpart()),
                            ("mesh_autoencode", config.autoencoder())):
        launches[phase] = dict.fromkeys(_mesh_counters(), 0)
        ran[phase] = dict.fromkeys(_mesh_counters(), 0)
        bf16 = task_cfg.compute_dtype
        for key in [k for k in res[0] if k.startswith(phase + " (")]:
            shape = tuple(int(x) for x in key.split("(")[1].split(")")[0]
                          .split(","))
            main = key.endswith(bf16)
            r0 = res[0][key]
            want_n = TRAIN_STEPS if main else 1
            want = MESH_KERNEL1[shape] if phase == "mesh" and main else None
            for r, rr in enumerate(res):
                got = rr[key]
                for name, n in got["launches"].items():
                    launches[phase][name] += n
                for name, n in got["ran"].items():
                    ran[phase][name] += n
                n1 = got["launches"]["segment_max_window"]
                bn = [got["launches"][f"batchnorm_act.{m}"]
                      for m in BATCHNORM_MODES]
                if not bn[0] >= bn[2] > 0:
                    raise AssertionError(f"{key}, rank {r}: the fused "
                                         f"BatchNorm's launches (train, "
                                         f"eval, backward) {bn}")
                if n1 != want_n or len(got["shapes"]) != 1:
                    raise AssertionError(f"{key}, rank {r}: kernel 1 {n1} "
                                         f"launches at {got['shapes']}")
                if want and set(got["shapes"]) != {str(list(want))}:
                    raise AssertionError(f"{key}, rank {r}: kernel 1 at "
                                         f"{got['shapes']}, want {want}")
                if got["losses"] != r0["losses"]:
                    raise AssertionError(f"{key}: ranks report other losses")
            losses = r0["losses"]
            rel = abs(losses[0] - r0["one_loss"]) / abs(r0["one_loss"])
            log(f"{phase} {_describe(task_cfg.replace(dropout=0.0))} over "
                f"mesh {shape} in {key.split()[-1]} on {card}: kernel 1 per "
                f"rank at {sorted(r0['shapes'])} x "
                f"{r0['launches']['segment_max_window']}, graph replays "
                f"{r0['replays']}; first loss {losses[0]:.6f} against one "
                f"process's {r0['one_loss']:.6f} ({rel:.2e}); gradients "
                f"{r0['grad_rel_diff']:.3e} and update "
                f"{r0['update_rel_diff']:.3e} of one process's by norm"
                + (f"; one process against itself: update "
                   f"{r0['one_again']:.3e}; from weights one rounding away "
                   f"(x(1 + {NUDGE} N(0, 1))): {r0['nudged']}; a planted "
                   f"fault (node-level gradients summed over points): "
                   f"{r0['planted']}; Chamfer pairs over the mesh: "
                   f"{r0.get('chamfer')}" if not main else "")
                + (f"; losses {losses}; a step {r0['step_ms']:.1f} ms over "
                   f"the mesh (gloo collectives {r0['collective_ms']:.1f} "
                   f"ms, {r0['collective_ms'] / r0['step_ms']:.1%}, "
                   f"{r0['collectives_a_step']} a step) against "
                   f"{r0['one_ms']:.1f} ms in one process" if main else ""))
            if rel > (MESH_LOSS_RTOL if main else MESH_F32_LOSS_RTOL):
                raise AssertionError(f"{key}: first loss off by {rel:.2e}")
            if not main and (r0["grad_rel_diff"] > MESH_GRAD_RTOL
                             or r0["update_rel_diff"] > MESH_UPDATE_RTOL):
                raise AssertionError(
                    f"{key}: gradients off by {r0['grad_rel_diff']:.2e} "
                    f"(limit {MESH_GRAD_RTOL}), update by "
                    f"{r0['update_rel_diff']:.2e} (limit {MESH_UPDATE_RTOL})")
            if r0.get("planted") and not (
                    r0["planted"]["grad_rel_diff"] > MESH_GRAD_RTOL):
                raise AssertionError(f"{key}: the gate passed a planted "
                                     f"fault: {r0['planted']}")
            if main and not (all(abs(x) < float("inf") for x in losses)
                             and losses[-1] < losses[0]):
                raise AssertionError(f"{key}: losses not finite and "
                                     f"falling: {losses}")
        log(f"phase {phase} on {card}: {res[0][phase + ' s']:.1f} s in "
            f"the ranks ({took:.1f} s for the launch of all three)")
    return launches, ran


def start_mesh_nccl(runs):
    """Launch the NCCL world of one (``mesh_nccl_worker``); it runs beside
    the "mesh_trainer" launches, whose times are not read.  Returns the
    Popen for ``finish_mesh_nccl``."""
    out = os.path.join(runs, "mesh")
    os.makedirs(out, exist_ok=True)
    return _torchrun(1, [os.path.abspath(__file__), "--mesh_nccl", out],
                     os.path.join(out, "nccl.log"))


def finish_mesh_nccl(p, runs, card):
    """Check the NCCL world of one: its captured step over the (1, 1)
    mesh, gradients and metrics all-reduced inside the graph, `==` the
    captured step over no mesh.  Returns (launches, {kernel: graph
    replays that ran it})."""
    out = os.path.join(runs, "mesh")
    rc = p.wait(timeout=300)
    nccl = _rank_results(out, "nccl", 1)[0] if rc == 0 else None
    log(f"mesh, the NCCL world of one on {card}: {nccl}")
    if nccl is None or not (
            nccl["backend"] == "nccl" and nccl["equal"]
            and nccl["eager"] == [False, False] and nccl["captures"] == 2
            and nccl["replays"] == 2
            and nccl["launches"]["segment_max_window"] == 4):
        with open(os.path.join(out, "nccl.log")) as f:
            log(f.read()[-6000:])
        raise AssertionError("the NCCL world of one: want its captured step "
                             "== the captured step over no mesh")
    return nccl["launches"], nccl["ran"]


def _infer_rows(out, name):
    """(predictions.csv's rows, the (items, classes) scores) that
    ``sonet-torch infer --dump_arrays`` wrote under ``out/name``."""
    import csv

    import numpy as np
    d = os.path.join(out, name)
    with open(os.path.join(d, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    return rows, np.stack([np.load(os.path.join(d, f"score_{i:06d}.npy"))
                           for i in range(len(rows) - 1)])


def _same_predictions(one, two, items):
    """``infer`` over two ranks (``two``) against one process (``one``),
    each ``_infer_rows``: the same rows in the same order, each item's
    class scores within the bf16 rule (``LOGIT_RTOL`` of the largest
    entry), and the same predicted class wherever one process's two best
    scores lie further apart than that."""
    import numpy as np
    (rows1, s1), (rows2, s2) = one, two
    scale = float(np.abs(s1).max())
    diff = float(np.abs(s2 - s1).max()) if s1.shape == s2.shape else None
    top2 = np.sort(s1, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LOGIT_RTOL * scale
    moved = [i for i in range(len(rows1) - 1)
             if rows1[i + 1][2] != rows2[i + 1][2] and clear[i]]
    log(f"infer's rows over 2 ranks against one process: {len(rows2) - 1} "
        f"and {len(rows1) - 1} items, class scores {s2.shape} and "
        f"{s1.shape}, max difference {diff} (tolerance {LOGIT_RTOL} x "
        f"{scale}); predicted class moved on {moved} of the {int(clear.sum())} "
        f"items whose two best scores are further apart")
    if ([r[:2] for r in rows1] != [r[:2] for r in rows2]
            or len(rows1) - 1 != items or diff is None
            or diff > LOGIT_RTOL * scale or moved):
        raise AssertionError("infer's rows over two ranks disagree with one "
                             "process's")


def phase_mesh_trainer(runs, card):
    """Phase "mesh_trainer": ``sonet-torch classify`` on two ranks of the
    one card over the "reproduce" tree, the host pipeline stopped by a
    SIGTERM to rank 1 and the run restored in one process, beside it the
    device pipeline with the train split sharded; then ``sonet-torch infer
    --mesh_shape 2`` against one process, the two side by side (no time
    of these launches is read).  Returns (every kernel's launches over
    the ranks, {kernel: graph replays that ran it over the ranks})."""
    import torch
    from sonet_torch.config import load_config
    from sonet_torch.train.trainer import Trainer
    out = os.path.join(runs, "mesh")
    os.makedirs(out, exist_ok=True)
    t_phase = time.perf_counter()
    tree = os.path.join(runs, "reproduce_data", "modelnet40")
    flags = ["--device", MESH_DEVICE, "--distributed", "auto", "--preset",
             "modelnet40", "--dataset", "modelnet", "--dataroot", tree,
             "--checkpoints_dir", out]
    # the host pipeline, two epochs of 10 steps; a SIGTERM to rank 1 alone
    # once epoch 0's eval is logged stops both in epoch 1, with a checkpoint
    run = os.path.join(out, "mesh_host")
    metrics = os.path.join(run, "train_metrics.jsonl")
    logs = {k: os.path.join(out, f"{k}.log") for k in ("host", "device",
                                                       "infer")}
    p = _torchrun(MESH_RANKS, _rank_cli_args(
        os.path.join(out, "host"), ["classify", "--name", "mesh_host",
                                    "--epochs", "2"] + flags),
        logs["host"])
    # the device pipeline, the train split sharded over the two ranks
    p_dev = _torchrun(MESH_RANKS, _rank_cli_args(
        os.path.join(out, "device"),
        ["classify", "--name", "mesh_device", "--epochs", "1",
         "--input_pipeline", "device", "--dataset_placement", "sharded",
         "--checkpoint_every", "10"] + flags), logs["device"])
    signalled = None
    deadline = time.time() + 600
    while p.poll() is None and time.time() < deadline:
        if signalled is None and os.path.exists(metrics):
            with open(metrics) as f:
                if '"test_loss"' in f.read():
                    signalled = _rank_pid(p.pid, 1)
                    os.kill(signalled, signal.SIGTERM)
        time.sleep(0.1)
    text = _wait_ranks(p, "two-rank classify, host pipeline", logs["host"])
    if signalled is None:
        raise AssertionError("two-rank classify ended before the SIGTERM")
    host = _rank_results(out, "host", MESH_RANKS)
    _check_kernel1("mesh_trainer host", host, MESH_KERNEL1[(2, 1)])
    with open(metrics) as f:
        recs = [json.loads(ln) for ln in f]
    tests = [r for r in recs if "test_loss" in r]
    stops = [r for r in recs if "train_stopped_early" in r]
    ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
    stop_step = int(ckpts[-1][5:13])
    log(f"two-rank classify, host pipeline: SIGTERM to rank 1 (pid "
        f"{signalled}) after epoch 0's eval; {len(tests)} evals and "
        f"{len(stops)} stop logged once each by rank 0, checkpoints "
        f"{ckpts}; launches {[h['launches'] for h in host]} and graph "
        f"replays {[h['replays'] for h in host]} by rank, kernel 1 at "
        f"{host[0]['shapes']}")
    if (len(tests) != 2 or len(stops) != 1 or not 10 < stop_step <= 20
            or "stop requested" not in text):
        raise AssertionError("the stop on rank 1 did not stop both ranks "
                             "with one checkpoint in epoch 1")
    if sorted(os.listdir(run)) != sorted(
            ["config.json", "ckpt", "train_metrics.jsonl",
             "train_train_metrics.csv", "train_test_metrics.csv"]):
        raise AssertionError(f"the run holds {sorted(os.listdir(run))}")
    # the run restores in one process, bit for bit
    cfg = load_config(os.path.join(run, "config.json"))
    if cfg.mesh_shape != (2, 1) or cfg.distributed != "auto":
        raise AssertionError(f"the run's config: {cfg.mesh_shape}, "
                             f"{cfg.distributed!r}")
    t = Trainer(cfg.replace(mesh_shape=(1, 1), distributed=""), quiet=True,
                device="cuda")
    saved = torch.load(os.path.join(run, "ckpt", ckpts[-1]),
                       map_location="cuda", weights_only=True)["model"]
    if t.state.step != stop_step or t.mesh is not None or not all(
            torch.equal(v, saved[k]) for k, v in t.model.state_dict().items()):
        raise AssertionError("the two-rank run did not restore in one "
                             "process")
    del t

    text = _wait_ranks(p_dev, "two-rank classify, device pipeline",
                       logs["device"])
    dev_res = _rank_results(out, "device", MESH_RANKS)
    _check_kernel1("mesh_trainer device", dev_res, MESH_KERNEL1[(2, 1)])
    ck = os.listdir(os.path.join(out, "mesh_device", "ckpt"))
    log(f"two-rank classify, device pipeline, sharded placement: "
        f"checkpoints {ck}; launches {[d['launches'] for d in dev_res]} "
        f"and graph replays {[d['replays'] for d in dev_res]} by rank, "
        f"kernel 1 at {dev_res[0]['shapes']}")
    if "sharded over 2 data shards" not in text or ck != [
            "step_00000010.pt"]:
        raise AssertionError("the sharded device-pipeline run")

    # sonet-torch infer over the two ranks against one process
    p = _torchrun(MESH_RANKS, _rank_cli_args(
        os.path.join(out, "infer"),
        ["infer", "--run", run, "--device", MESH_DEVICE, "--mesh_shape",
         "2", "--distributed", "auto", "--dump_arrays", "--out",
         os.path.join(out, "infer2")]), logs["infer"])
    _, text = _cli_output(["infer", "--run", run, "--device", "cuda",
                           "--dump_arrays", "--out",
                           os.path.join(out, "infer1")])
    one = json.loads(text.strip().splitlines()[-1])
    _wait_ranks(p, "sonet-torch infer over two ranks", logs["infer"])
    inf = _rank_results(out, "infer", MESH_RANKS)
    _check_kernel1("mesh_trainer infer", inf, MESH_KERNEL1[(2, 1)])
    with open(os.path.join(out, "infer2", "summary.json")) as f:
        two = json.load(f)
    rows, scores = _infer_rows(out, "infer1"), _infer_rows(out, "infer2")
    log(f"sonet-torch infer over 2 ranks: {two}; in one process: {one}")
    if (two["items"] != one["items"] or two["accuracy"] != one["accuracy"]
            or abs(two["loss"] - one["loss"]) > LOGIT_RTOL * abs(one["loss"])):
        raise AssertionError("infer over two ranks disagrees with one "
                             "process")
    _same_predictions(rows, scores, one["items"])
    log(f"phase mesh_trainer on {card}: "
        f"{time.perf_counter() - t_phase:.1f} s")
    ranks = host + dev_res + inf
    return ({n: sum(x["launches"][n] for x in ranks)
             for n in ranks[0]["launches"]},
            {n: sum(x["ran"][n] for x in ranks) for n in ranks[0]["ran"]})


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the ranks that the mesh phases launch with torchrun run this script
    workers = {"--mesh_steps": mesh_steps_worker,
               "--mesh_nccl": mesh_nccl_worker}
    if argv[:1] and argv[0] in workers:
        workers[argv[0]](argv[1])
        return 0
    if argv[:1] == ["--rank_cli"]:
        return rank_cli(argv[1])
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    counters = _mesh_counters()
    # kernel 2 is on no path; the segment sums and the node sort run beside
    # kernel 1 in every encoder forward on the card, so every path holds
    # the three to one count
    on_path = ("segment_max_window", "segment_sums", "node_sort")
    from sonet_torch import config
    classify, segment = config.modelnet40(), config.shapenetpart()
    autoenc = config.autoencoder()
    small = config.tiny_test()
    small_seg = small.replace(task="segment", classes=segment.classes)
    small_ae = small.replace(task="autoencode")
    # every path's kernel launches (eager launches, and in a captured path
    # the warm-up step's and the capture's) and, by kernel, the graph
    # replays that ran it (counted around the path, or in its ranks)
    by_path, ran = {}, {}
    record, shapes = _kernel1_shapes()

    def timed(name, phase):
        t1 = time.perf_counter()
        out = phase()
        log(f"phase {name}: {time.perf_counter() - t1:.1f} s")
        return out

    def path(name, phase):
        """Runs ``phase``, the path ``name``, which returns its launches
        first; keeps them and the path's replays by kernel, and holds
        that no BatchNorm ran its plain chain on the card."""
        plain = []
        with _GraphCounter() as graphs, _plain_batchnorm_calls(plain):
            out = timed(name, phase)
        if plain:
            raise AssertionError(f"path {name}: BatchNorm ran its plain "
                                 f"chain on the card at {plain}")
        _check_selections(name, out[0])
        by_path[name], ran[name] = out[0], graphs.ran
        return out

    with tempfile.TemporaryDirectory() as runs, record():
        path("serve", lambda: phase_serve(classify, small, counters,
                                          on_path, args.profile))
        _, _, classifier_ckpt = path("train", lambda: phase_train(
            classify, small.replace(dropout=0.0), counters, on_path,
            os.path.join(runs, "classify", "ckpt"), args.profile))
        path("serve_segment", lambda: phase_serve(
            segment, small_seg, counters, on_path, args.profile))
        seg_run = os.path.join(runs, "segment")
        _, seg_state, seg_ckpt = path("train_segment", lambda: phase_train(
            segment, small_seg.replace(dropout=0.0), counters, on_path,
            os.path.join(seg_run, "ckpt"), args.profile))
        phase_round_trip(segment, seg_state, seg_run, seg_ckpt,
                         classifier_ckpt)
        phase_som(args.profile)
        path("serve_autoencode", lambda: phase_serve(
            autoenc, small_ae, counters, on_path, args.profile))
        ae_run = os.path.join(runs, "autoencode")
        _, ae_state, ae_ckpt = path("train_autoencode", lambda: phase_train(
            autoenc, small_ae.replace(dropout=0.0), counters, on_path,
            os.path.join(ae_run, "ckpt"), args.profile))
        phase_round_trip(autoenc, ae_state, ae_run, ae_ckpt, classifier_ckpt)
        for name, phase in (("trainer", phase_trainer),
                            ("retrieve", phase_retrieve)):
            path(name, lambda: phase(counters, on_path, runs))
        _, _, run = path("reproduce",
                         lambda: phase_reproduce(counters, on_path, runs))
        for name, phase in (("trainer_device", phase_trainer_device),
                            ("trainer_chunked", phase_trainer_chunked),
                            ("trainer_native", phase_trainer_native)):
            path(name, lambda: phase(counters, on_path, runs))
        for name, phase in (
                ("infer", lambda: phase_infer(counters, on_path, run, card,
                                              runs)),
                ("mnist", lambda: phase_mnist(counters, on_path, runs, card)),
                ("serve_http", lambda: phase_serve_http(counters, on_path,
                                                        run)),
                ("export", lambda: phase_export(counters, on_path, run,
                                                runs)),
                ("import_ckpt", lambda: phase_import_ckpt(counters, on_path,
                                                          run, runs)),
                ("train_remat", lambda: phase_train_remat(counters,
                                                          on_path)),
                ("profile", lambda: phase_profile(counters, on_path, kernels,
                                                  args.profile))):
            path(name, phase)
        timed("monitor", lambda: phase_monitor(runs))
        path("quality", lambda: phase_quality(counters, on_path, runs))
        # ranks launched with torchrun: their launches and replays counted
        # in the ranks
        mesh_launches, mesh_ran = timed(
            "mesh, mesh_segment, mesh_autoencode",
            lambda: phase_mesh_steps(runs, card))
        nccl = start_mesh_nccl(runs)
        mesh_launches["mesh_trainer"], mesh_ran["mesh_trainer"] = timed(
            "mesh_trainer", lambda: phase_mesh_trainer(runs, card))
        mesh_launches["mesh_nccl"], mesh_ran["mesh_nccl"] = (
            finish_mesh_nccl(nccl, runs, card))
        by_path.update(mesh_launches)
        ran.update(mesh_ran)
    for name, launches in mesh_launches.items():
        _check_selections(name, launches)
    log("the selections' launches by path (top-k, subsample): "
        + str({p: (n["smallest_k"], n["subset_select"])
               for p, n in by_path.items()}))
    # Adam's update ran on exactly the paths that ran a backward: every
    # train path, and no serve, infer or export path
    updated = {p for p, n in by_path.items() if n["adam_step"]}
    backward = {p for p, n in by_path.items() if n["segment_max_grad"]}
    calls = {p: by_path[p]["adam_step"] for p in sorted(updated)}
    log(f"Adam's update calls by path: {calls}")
    if updated != backward:
        raise AssertionError(f"Adam's update ran on {sorted(updated)}, a "
                             f"backward on {sorted(backward)}")
    # every shape kernel 1 was called at after phase 3, checks at small
    # widths included, for the rule-2 watch of phase 3's readings
    log(f"kernel 1 calls by (B, N, C, M) over the paths: {shapes}")
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["graph_replays_by_path"] = {p: ran[p][k["name"]] for p in by_path}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
