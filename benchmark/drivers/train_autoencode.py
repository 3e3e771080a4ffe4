"""Driver ``train_autoencode``: the auto-encoder's training on the
program's device pipeline, as its ``Trainer`` runs an epoch with
``input_pipeline="device"``; ``train_device``'s window over another
model.

Set-up is ``train_device``'s (the split, its nodes and the weights made
on the card from the seed; ``init_state``; an ``EpochGraph`` over
``make_steps``' train step with ``sample_batch``; the checked steps
driven through it, one replay a step; one part to capture the window's
shape), with the auto-encoder's weights: ``benchmark.data.weights``'
draws over ``reference.autoencoder.param_specs``, but for two kinds it
does not know, each a deviation listed under ``assumed`` in the
configuration's file:

* a 3x3 convolution's kernel (out, in, 3, 3) is He-normal by its fan-in
  9 in: ``data.weights``' draw, which scales by ``in``, over 3;
* the bias of a float32 layer that emits points (``linear_out``, the taps'
  ``Dense_0``) is U(-1, 1), as the model's own initialiser draws it, so
  that the first clouds spread over the unit cube and not onto a point.

The checked steps are ``train_device``'s, and read besides, from each
first step's replay, the decoder's output cloud and ``pc4`` tap and the
input cloud the loss took: hooks on the model copy them into buffers
that the first steps' graph holds.  The hooks go, and that graph with
them, before the window's shape is captured.  Beside ``train_device``'s
numbers the comparison gives ``recon_gap`` (the clouds against the
reference's) and ``recon_loss_gap`` (the program's loss against the
reference's Chamfer loss of the program's own clouds): ``cloud_numbers``.

Before the window, set-up runs ``SETTLE[0]`` parts, captures the step
anew, and runs ``SETTLE[1]`` parts more (``Program.settle``).  A process
replays a captured step in one of two modes of the card, ~0.35 us a
kernel boundary apart: it starts in the slower and leaves it once, at a
moment no setting here decides; in most processes that moment came a few
seconds after a recapture.

The window is ``train_device``'s: parts of ``part_rows`` rows, one
``EpochGraph.run`` each, the part's metrics fetched at its end, until the
first part boundary past ``--seconds``; a traced run records its second
part under the profiler.  After the window, a traced run also profiles
two eager train steps of the same ``train_step`` on the same state and
reads, in the second (``bench:span_step``), the device time of the
program's ranges ``sonet:decoder`` and ``sonet:chamfer`` with their
backward (``span_time.py``): inside a captured step those ranges are
recorded at the capture only.

After that the program's state is freed and the reference
(``reference/autoencoder.py``) trains from the same weights, rows and
seed of draws.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from benchmark import compare, counts, counts_autoencoder, data, span_time
from benchmark import trace as btrace
from benchmark.drivers import train_device
from benchmark.harness import Result, judge
from benchmark.reference import autoencoder as ref_ae
from benchmark.traffic import EpochRows

SPANS = ("sonet:decoder", "sonet:chamfer")
SETTLE = (6, 20)    # set-up's parts before and after the step's recapture
# the kinds data.weights draws in place of the reference's own kinds
DRAWN_AS = {"conv_weight": "weight", "point_bias": "bias"}


def weights(cfg: dict, seed: int, device) -> dict:
    """The auto-encoder's weights from ``seed`` (the module docstring)."""
    specs = ref_ae.param_specs(cfg)
    w = data.weights({n: (shape, DRAWN_AS.get(kind, kind))
                      for n, (shape, kind) in specs.items()}, seed, device)
    gen = data.generator(seed, "point biases", device)
    for n, (shape, kind) in specs.items():
        if kind == "conv_weight":
            w[n] = w[n] / 3.0
        elif kind == "point_bias":
            w[n] = torch.rand(shape, generator=gen, device=device) * 2 - 1
    return w


class Program(train_device.Program):
    """``train_device.Program`` with the auto-encoder's weights, and one
    profiled eager step for the program's ranges."""

    def __init__(self, ctx):
        from sonet_torch.data.device_pipeline import DeviceData, sample_batch
        from sonet_torch.train import init_state, make_steps
        from sonet_torch.train.graphs import EpochGraph
        from sonet_torch.train.state import set_capturable, snapshot

        cfg, d = ctx.cfg(), ctx.cfg_dict
        self.cfg, self.dev = cfg, torch.device(ctx.device)
        dev, spec = self.dev, ctx.config_file["split"]
        with ctx.phase("split and nodes"):
            self.sp = data.split(spec, ctx.seed, dev)
            self.rows = EpochRows(spec["items"], cfg.batch_size, ctx.seed)
            spe = self.spe = self.rows.steps_per_epoch
        with ctx.phase("weights"):
            self.w0 = weights(d, ctx.seed, dev)
        with ctx.phase("train state"):
            state = self.state = init_state(cfg, device=dev,
                                            steps_per_epoch=spe)
            state.model.load_state_dict(self.w0, strict=True)
            train_step, _ = make_steps(cfg, spe)
            set_capturable(state.optimizer, dev.type == "cuda")
            self.draw_seed = data.sub_seed(ctx.seed, "draws")
            gen = torch.Generator(device=dev).manual_seed(self.draw_seed)
            sp = self.sp
            self.split = DeviceData(pc=sp["pc"], sn=sp["sn"], node=sp["node"],
                                    label=sp["label"], seg=sp.get("seg"))
            keys = {}

            def step(data_, idx):
                batch = sample_batch(data_, idx, gen, cfg, train=True)
                _, metrics = train_step(state, batch, gen)
                return metrics

            def key():
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
        self._clouds, self._kept = {}, None

    def run(self, table: np.ndarray) -> dict:
        out = super().run(table)
        if self._kept is not None:
            self._kept.append({k: v.clone() for k, v in self._clouds.items()})
        return out

    def checked_steps(self, singles: int, chain: int):
        """``train_device``'s checked steps; the readback also holds
        ``first_clouds``, each first step's {"pc", "pc4", "target"}: the
        output cloud, the 16x16 tap and the input cloud the loss took."""
        bufs = self._clouds

        def keep(**clouds):
            for name, t in clouds.items():
                if name not in bufs:
                    bufs[name] = torch.empty_like(t)
                bufs[name].copy_(t.detach())

        def keep_target(module, args):
            keep(target=args[0])

        def keep_output(module, args, out):
            keep(pc=out.pc, pc4=out.conv_pc4)

        model = self.state.model
        hooks = [model.register_forward_pre_hook(keep_target),
                 model.decoder.register_forward_hook(keep_output)]
        self._kept = []
        try:
            first, rest, readback = super().checked_steps(singles, chain)
            readback["first_clouds"] = self._kept[:singles]
        finally:
            self._kept = None
            for h in hooks:
                h.remove()
            self.graph.reset()      # the window's graph holds no copies
        return first, rest, readback

    def settle(self, rows: EpochRows, part: int) -> None:
        """``SETTLE[0]`` parts of ``part`` rows, the step captured anew,
        ``SETTLE[1]`` parts more."""
        before, after = SETTLE
        for _ in range(before):
            self.run(rows.take(part))
        self.graph.reset()
        for _ in range(after):
            self.run(rows.take(part))

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
    return ref_ae.checked_steps(prog.w0, cfg, singles, chain,
                                prog.draw_seed, prog.spe, **kw)


def cloud_numbers(cfg: dict, got: dict, ref: dict) -> dict:
    """Over the first steps, each the mean of a relative gap:
    ``recon_gap``, | clouds - reference's | / | reference's | of the output
    cloud and the ``pc4`` tap together (the forward's precision alone:
    every first step starts from the same weights); ``recon_loss_gap``,
    the gap of ``got``'s loss from the reference's Chamfer loss
    (``reference.autoencoder.loss``, float32) of ``got``'s own clouds
    against its own input cloud (the loss's computation alone).  ``got``
    and ``ref``: readbacks with ``first_losses`` and ``first_clouds``."""
    recon, own = [], []
    for g, r, value in zip(got["first_clouds"], ref["first_clouds"],
                           got["first_losses"]):
        mine = torch.cat([g["pc"], g["pc4"]], 1).double()
        theirs = torch.cat([r["pc"], r["pc4"]], 1).double()
        recon.append(float((mine - theirs).norm() / theirs.norm()))
        with torch.no_grad():
            again = float(ref_ae.loss(
                cfg, {"pc": g["pc"].float(), "pc4": g["pc4"].float()},
                {"pc": g["target"].float()}))
        own.append(abs(value - again) / abs(again)
                   if math.isfinite(value) else math.inf)
    return {"recon_gap": sum(recon) / len(recon),
            "recon_loss_gap": sum(own) / len(own)}


def comparison(cfg: dict, got: dict, ref: dict) -> dict:
    """The comparison's numbers: ``compare.train_numbers`` and
    ``cloud_numbers``."""
    return {**compare.train_numbers(got, ref),
            **cloud_numbers(cfg, got, ref)}


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
        prog.settle(rows, part)

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

    readings = {"step_flops": counts_autoencoder.train_step_flops(d),
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
    numbers = comparison(d, readback, ref)
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
