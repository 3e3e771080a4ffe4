"""Driver ``train_planar``: the 2-D classifier (MNIST's: 2-D points, no
normals) on the program's device pipeline, as its ``Trainer`` runs an
epoch with ``input_pipeline="device"``; ``train_device``'s window over
2-D clouds.

Set-up is ``train_device``'s (``init_state``; an ``EpochGraph`` over
``make_steps``' train step with ``sample_batch`` drawing the 2-D jitter,
scale and dropout on the card; the checked steps driven through it, one
replay a step; one part to capture the window's shape; the settling
parts below) over the 2-D inputs: the split of ``data_planar`` (stroke
clouds and their nodes, resident as ``DeviceData`` with no normals) and
``data.weights``' draws over ``reference.planar.param_specs``.

The checked steps are ``train_device``'s, and read besides each first
step's logits from its replay: a hook on the model's classifier head
copies them into a buffer that the first steps' graph holds.  The hook
goes, and that graph with it, before the window's shape is captured.
Beside ``train_device``'s numbers the comparison gives ``logit_gap``: the
mean over the first steps of ``compare.logit_gap`` against the
reference's logits (the forward's precision alone: every first step
starts from the same weights, and its dropout masks are the reference's).

The window is ``train_device``'s: parts of ``part_rows`` rows, one
``EpochGraph.run`` each, the part's metrics fetched at its end, until the
first part boundary past ``--seconds``; a traced run records its second
part under the profiler.  After the window, a traced run also profiles
two eager train steps of the same ``train_step`` on the same state and
reads, in the second (``bench:span_step``), the device time of the
program's range ``sonet:grouping`` with its backward (``span_time.py``):
inside a captured step the range is recorded at the capture only.  A
program without the range reports none.

Before the window, set-up replays parts until the card has left the
slower of its two modes of a captured step (``Program.settle``).  A
process starts in the slower, where each of the ~480 kernel boundaries of
this step costs ~0.35 us more (~12% of a step here; ROADMAP §4 P9), and
leaves it once: 0.5-26 s into continuous replay in 36 of the 41
processes read on an H100, 32-45 s or later in four, whether or not the
step was captured anew (the autoencoder's fixed ``SETTLE`` parts and
recapture do not reach that far); one began fast.  Settling ends at the
first part boundary past the traffic's ``settle_seconds[0]`` at which the
last three parts ran ``JUMP`` times as fast as the first five, or at
``settle_seconds[1]`` (where a process that began fast ends it).

After that the program's state is freed and the reference
(``reference/planar.py``) trains from the same weights, rows and seed of
draws.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmark import (compare, counts, counts_planar, data, data_planar,
                       span_time)
from benchmark import trace as btrace
from benchmark.drivers import train_device
from benchmark.harness import Result, judge
from benchmark.reference import planar as ref_planar
from benchmark.traffic import EpochRows

SPANS = ("sonet:grouping",)
JUMP = 1.06     # the faster mode's rate over the slower's, at the least


class Program(train_device.Program):
    """``train_device.Program`` over the 2-D split and weights, and one
    profiled eager step for the program's range."""

    def __init__(self, ctx):
        from sonet_torch.data.device_pipeline import DeviceData, sample_batch
        from sonet_torch.train import init_state, make_steps
        from sonet_torch.train.graphs import EpochGraph
        from sonet_torch.train.state import set_capturable, snapshot

        cfg, d = ctx.cfg(), ctx.cfg_dict
        self.cfg, self.dev = cfg, torch.device(ctx.device)
        dev, spec = self.dev, ctx.config_file["split"]
        with ctx.phase("split and nodes"):
            self.sp = data_planar.split(spec, ctx.seed, dev)
            self.rows = EpochRows(spec["items"], cfg.batch_size, ctx.seed)
            spe = self.spe = self.rows.steps_per_epoch
        with ctx.phase("weights"):
            self.w0 = data.weights(ref_planar.param_specs(d), ctx.seed, dev)
        with ctx.phase("train state"):
            state = self.state = init_state(cfg, device=dev,
                                            steps_per_epoch=spe)
            state.model.load_state_dict(self.w0, strict=True)
            train_step, _ = make_steps(cfg, spe)
            set_capturable(state.optimizer, dev.type == "cuda")
            self.draw_seed = data.sub_seed(ctx.seed, "draws")
            gen = torch.Generator(device=dev).manual_seed(self.draw_seed)
            sp = self.sp
            self.split = DeviceData(pc=sp["pc"], sn=None, node=sp["node"],
                                    label=sp["label"])
            keys = {}

            def step(data_, idx):
                batch = sample_batch(data_, idx, gen, cfg, train=True)
                _, metrics = train_step(state, batch, gen)
                return metrics

            def key():
                # what a captured step reads from Python: each group's
                # learning rate and every BatchNorm's momentum, per epoch
                epoch = state.step // spe
                if epoch not in keys:
                    lrs = tuple(state.schedules[g["name"]](state.step)
                                for g in state.optimizer.param_groups)
                    momenta = tuple(m.momentum_at(epoch)
                                    for m in state.model.modules()
                                    if hasattr(m, "momentum_at"))
                    keys[epoch] = (lrs, momenta)
                return keys[epoch]

            def advance():
                state.step += 1

            self.graph = EpochGraph(step, dev, generators=(gen,), key=key,
                                    snapshot=lambda: snapshot(state),
                                    on_replay=advance)
        self._logits, self._kept = {}, None

    def run(self, table: np.ndarray) -> dict:
        out = super().run(table)
        if self._kept is not None:
            self._kept.append(self._logits["out"].clone())
        return out

    def checked_steps(self, singles: int, chain: int):
        """``train_device``'s checked steps; the readback also holds
        ``first_logits``, each first step's logits (B, classes)."""
        buf = self._logits

        def keep(module, args, out):
            if "out" not in buf:
                buf["out"] = torch.empty_like(out)
            buf["out"].copy_(out.detach())

        hook = self.state.model.classifier.register_forward_hook(keep)
        self._kept = []
        try:
            first, rest, readback = super().checked_steps(singles, chain)
            readback["first_logits"] = self._kept[:singles]
        finally:
            self._kept = None
            hook.remove()
            self.graph.reset()      # the window's graph holds no copies
        return first, rest, readback

    def settle(self, rows: EpochRows, part: int, least: float,
               most: float) -> str:
        """Replay parts of ``part`` rows until the card left its slower
        mode, for ``least`` to ``most`` seconds (the module docstring);
        what happened, for the log."""
        rates, t0 = [], time.perf_counter()
        while True:
            table = rows.take(part)
            t = time.perf_counter()
            self.run(table)
            now = time.perf_counter()
            rates.append(len(table) / (now - t))
            first = float(np.median(rates[:5]))
            left = len(rates) > 8 and min(rates[-3:]) > JUMP * first
            if (left and now - t0 >= least) or now - t0 >= most:
                break
        return (f"{len(rates)} parts in {now - t0:.3f} s, steps/s of a part "
                f"{first:.1f} at first, {rates[-1]:.1f} last"
                + ("" if left else "; no faster mode seen"))

    def span_times(self, ctx, table: np.ndarray) -> dict:
        """Two eager train steps on ``table``'s two rows under the profiler,
        the second inside ``bench:span_step``: {range: device seconds} of
        the program's ranges found there (``span_time.read``)."""
        from torch.profiler import ProfilerActivity, profile
        card = self.dev.type == "cuda"
        sync = torch.cuda.synchronize if card else (lambda: None)
        rows = [torch.from_numpy(r).to(self.dev) for r in table[:2]]
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card else [])
        sync()
        step = self.graph.step
        with profile(activities=activities) as prof:
            step(self.split, rows[0])
            sync()
            with ctx.spans("span_step"):
                step(self.split, rows[1])
                sync()
        return span_time.read(prof, "span_step", SPANS)


def reference(prog: "Program", cfg: dict, singles, chain, **kw) -> dict:
    """The reference's checked steps from the program's start: the same
    weights, raw rows and seed of draws, TF32 off."""
    return ref_planar.checked_steps(prog.w0, cfg, singles, chain,
                                    prog.draw_seed, prog.spe, **kw)


def comparison(got: dict, ref: dict) -> dict:
    """The comparison's numbers: ``compare.train_numbers`` and
    ``logit_gap``, the mean over the first steps of ``compare.logit_gap``
    of ``got``'s logits against ``ref``'s."""
    gaps = [compare.logit_gap(g, r) for g, r in zip(got["first_logits"],
                                                     ref["first_logits"])]
    return {**compare.train_numbers(got, ref),
            "logit_gap": sum(gaps) / len(gaps)}


def run(ctx) -> Result:
    d, traffic = ctx.cfg_dict, ctx.traffic
    prog = Program(ctx)
    with ctx.phase("checked steps"):
        singles, chain, readback = prog.checked_steps(
            traffic["checked_first_steps"], traffic["checked_run_steps"])
    rows, part = prog.rows, traffic["part_rows"]
    with ctx.phase("window's shape captured"):
        prog.run(rows.take(part))
    with ctx.phase("settling parts"):
        print("settled: " + prog.settle(rows, part,
                                        *traffic["settle_seconds"]),
              flush=True)

    setup_s = ctx.setup_s()
    captures = prog.graph.captures
    steps = parts = nonfinite = 0
    tr, rates = None, []
    t0 = time.perf_counter()
    while True:
        t_part = time.perf_counter()
        if ctx.trace and parts == 1:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with ctx.spans("slice"):
                    with ctx.spans("table"):
                        table = rows.take(part)
                    with ctx.spans("EpochGraph.run"):
                        out = prog.run(table)
            tr = (prof, len(table))
        else:
            with ctx.spans("table"):
                table = rows.take(part)
            with ctx.spans("EpochGraph.run"):
                out = prog.run(table)
        steps += len(table)
        parts += 1
        nonfinite += int((~np.isfinite(out["loss"])).sum())
        now = time.perf_counter()
        rates.append(len(table) * prog.cfg.batch_size / (now - t_part))
        if now - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    print(f"window: {steps} steps in {parts} parts, {wall:.3f} s, "
          f"{prog.graph.captures - captures} captures; clouds/s of a part "
          f"{min(rates):.1f}-{max(rates):.1f}", flush=True)
    peak = (torch.cuda.max_memory_allocated(prog.dev)
            if prog.dev.type == "cuda" else 0)

    readings = {"step_flops": counts_planar.train_step_flops(d),
                "pooling_bound_s": counts.pooling_bound_s(d),
                "peak_flops_per_s": counts.PEAKS["bf16_flops_per_s"]}
    busy = window = breakdown = None
    if tr is not None:
        t = btrace.collect(tr[0])
        readings.update(trace=t, slice_steps=tr[1])
        busy, window, breakdown = (btrace.busy_s(t), t.window_s,
                                   btrace.breakdown(t))
        del tr
    if ctx.trace:
        with ctx.phase("profiled eager step"):
            readings["span_device_s"] = prog.span_times(ctx, rows.take(2))
        print("span device seconds: "
              + json.dumps(readings["span_device_s"]), flush=True)

    # the program's state goes before the reference runs
    raws = prog.raw_rows(singles), prog.raw_rows(chain)
    prog.free()
    ref = reference(prog, d, *raws)
    numbers = comparison(readback, ref)
    print("comparison: " + json.dumps(numbers), flush=True)
    ok, checks = judge(numbers, ctx.limits)
    batch = prog.cfg.batch_size
    return Result(attempted=steps, failed=nonfinite,
                  end_to_end={"train_clouds_per_s": steps * batch / wall,
                              "setup_s": setup_s},
                  readings=readings, checks=checks,
                  correct=ok and nonfinite == 0,
                  memory_peak_bytes=peak, busy_s=busy, window_s=window,
                  breakdown=breakdown)
