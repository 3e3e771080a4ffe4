"""Driver ``train_device``: the program's device pipeline, as its
``Trainer`` runs an epoch with ``input_pipeline="device"``.

Set-up makes the split, its nodes and the weights on the card from the
seed, builds the train state (``sonet_torch.train.init_state``, the
weights loaded through ``load_state_dict``) and the captured epoch
(``EpochGraph`` over ``make_steps``' train step with ``sample_batch``
drawing the subsample, jitter, scale and dropout on the card), then
drives the checked steps through it, one replay a step: a first step on
each of ``checked_first_steps`` rows, the state put back after each, then
``checked_run_steps`` steps, reading what the comparison needs (each
first step's loss, the first gradient from the optimizer's state, each
parameter's change after the run); then it runs one part of
``part_rows`` rows to capture the window's shape.

The window runs the epoch's rows in parts of ``part_rows``, each part one
``EpochGraph.run`` (a replay a row, the part's metrics fetched at its
end), epoch after epoch, and stops at the first part boundary past
``--seconds``.  ``train_clouds_per_s`` is the clouds of every step run
over the window's wall time, the last fetch included.  A traced run
records its second part under the profiler.

After the window the program's state is freed and the reference trains
from the same weights, rows and seed of draws.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmark import compare, counts, data, trace as btrace
from benchmark.harness import Result, judge
from benchmark.reference import model as ref_model, train as ref_train
from benchmark.traffic import EpochRows


class Program:
    """The program's train state and captured epoch over the split."""

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
            self.w0 = data.weights(ref_model.param_specs(d), ctx.seed, dev)
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

    def run(self, table: np.ndarray) -> dict:
        return self.graph.run(self.split, table)

    def checked_steps(self, singles: int, chain: int):
        """Drive the next rows through the captured epoch, one replay a
        step: a first step on each of ``singles`` rows, the state put back
        after each (``train.state.snapshot``), then ``chain`` steps.
        Returns (the singles' rows, the chain's rows, what the comparison
        reads: each first step's loss, the first one's gradient from the
        optimizer's state, each parameter's change after the chain)."""
        from sonet_torch.train.state import snapshot
        state = self.state
        parts, want = [], singles + chain
        while want:
            parts.append(self.rows.take(want))
            want -= len(parts[-1])
        rows = np.concatenate(parts)
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        params = dict(state.model.named_parameters())
        restore = snapshot(state)
        first_losses, grad = [], None
        for j in range(singles):
            first_losses.append(float(self.run(rows[j:j + 1])["loss"][0]))
            if grad is None:
                grad = {k: (state.optimizer.state[p]["exp_avg"]
                            / (1 - beta1)).clone()
                        if p in state.optimizer.state else None
                        for k, p in params.items()}
            restore()
        self.run(rows[singles:])
        change = {k: p.detach() - self.w0[k] for k, p in params.items()}
        return rows[:singles], rows[singles:], {
            "first_losses": first_losses, "grad": grad, "change": change}

    def raw_rows(self, tables) -> list:
        """The raw split's rows of each table row, as the reference reads
        them (copies)."""
        return [{k: v[torch.from_numpy(r).to(self.dev)].clone()
                 for k, v in self.sp.items()} for r in tables]

    def free(self) -> None:
        """Drop the program's state and the split."""
        del self.graph, self.state, self.split, self.sp
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference(prog: "Program", cfg: dict, singles, chain, **kw) -> dict:
    """The reference's checked steps from the program's start: the same
    weights, raw rows and seed of draws, TF32 off."""
    if prog.dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return ref_train.checked_steps(prog.w0, cfg, singles, chain,
                                   prog.draw_seed, prog.spe, **kw)


def run(ctx) -> Result:
    d, traffic = ctx.cfg_dict, ctx.traffic
    prog = Program(ctx)
    with ctx.phase("checked steps"):
        singles, chain, readback = prog.checked_steps(
            traffic["checked_first_steps"], traffic["checked_run_steps"])
    rows, part = prog.rows, traffic["part_rows"]
    with ctx.phase("window's shape captured"):
        prog.run(rows.take(part))

    setup_s = ctx.setup_s()
    captures = prog.graph.captures
    steps = parts = nonfinite = 0
    tr = None
    t0 = time.perf_counter()
    while True:
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
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    print(f"window: {steps} steps in {parts} parts, {wall:.3f} s, "
          f"{prog.graph.captures - captures} captures", flush=True)
    peak = (torch.cuda.max_memory_allocated(prog.dev)
            if prog.dev.type == "cuda" else 0)

    readings = {"step_flops": counts.train_step_flops(d),
                "pooling_bound_s": counts.pooling_bound_s(d),
                "peak_flops_per_s": counts.PEAKS["bf16_flops_per_s"]}
    busy = window = breakdown = None
    if tr is not None:
        t = btrace.collect(tr[0])
        readings.update(trace=t, slice_steps=tr[1])
        busy, window, breakdown = (btrace.busy_s(t), t.window_s,
                                   btrace.breakdown(t))
        del tr

    # the program's state goes before the reference runs
    raws = prog.raw_rows(singles), prog.raw_rows(chain)
    prog.free()
    ref = reference(prog, d, *raws)
    numbers = compare.train_numbers(readback, ref)
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
