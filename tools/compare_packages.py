#!/usr/bin/env python3
"""The PyTorch port (``sonet_torch``) against the JAX package
(``sonet_tpu``) on one dataset tree, on the CPU: do they train alike, and
do they score one set of weights alike?

    # both packages' Trainers, one process each, side by side
    JAX_PLATFORMS=cpu python3 tools/compare_packages.py train \\
        --dataroot data/mn_small --out runs/cmp [--seeds 0 1] \\
        [--epochs 12] [--<Config field> value ...]

    # a run of the port (e.g. ``tools/torch_soak.py --save``) scored by
    # each package's ``infer`` over the test split, from the same weights
    JAX_PLATFORMS=cpu python3 tools/compare_packages.py eval \\
        --run runs/soak/soak_modelnet40_device_s0 --dataroot data/mn40_scale \\
        --out runs/cross [--input_pc_num 1024]

    # the two train steps side by side at full width, step after step,
    # from the same weights, batches and dropout masks
    JAX_PLATFORMS=cpu python3 tools/compare_packages.py trajectory \
        --dataroot data/mn40_scale --out runs/traj [--dtype float32 \
        bfloat16] [--steps 200] [--jax_compile jit|unfused]

``train`` builds ``config.<preset>()`` (default modelnet40) with the
``--<Config field> value`` pairs in each package, prints the steps an
epoch of each ``Trainer`` and, after each epoch, the last step's loss,
the epoch's mean train accuracy where the ``Trainer`` gives one (the
port's device pipeline) and the test split's accuracy and loss; each
package's rows go to ``<out>/<pkg>_s<seed>.json``.  ``--epochs 0`` only
counts the steps.

``eval`` writes the run's newest checkpoint as reference ``.pth`` files
(``sonet_torch.compat``), imports them into a run of each package with
the run's config (``--input_pc_num`` / ``--batch_size`` may narrow it),
streams the test split through each package's ``infer`` and prints both
summaries and how many of the predictions agree.  The tree needs its SOM
nodes.  JAX runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.

``trajectory`` runs ``config.modelnet40()`` (the ``--<Config field>
value`` pairs may narrow it) in each ``--dtype`` on the tree's train
split: the JAX package's ``train_step`` and the port's, both from the
JAX package's initial variables (``sonet_torch.convert``), on the
epochs' item ids of both ``Trainer``s, clouds subsampled and augmented
once from shared draws and dropout masks drawn here and handed to both
heads (``shared_dropout``), beside a chaos control: the port from the
same weights moved by one ulp (``one_ulp``).  Each step prints both
losses and the relative norms of the parameters' and the running
statistics' differences, the port against the JAX package and against
the control; the verdict names the first step at which the parameters'
difference exceeds ``FACTOR`` (10) times the control's, with the
gradients that differ most there.  Rows and verdict go to
``<out>/trajectory_<dtype>.json``.  ``run_steps`` is the same pair step
by step from the JAX side's state (``tests/test_torch_trajectory.py``).
"""

import argparse
import contextlib
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("jax", "torch")
# A trajectory departs where its parameters' difference from the JAX
# package's exceeds this many times the chaos control's.
FACTOR = 10.0


def _modules(pkg):
    """(config module, Trainer class, infer module, compat module)."""
    if pkg == "jax":
        from sonet_tpu import compat, config
        from sonet_tpu.tasks import infer
        from sonet_tpu.train.trainer import Trainer
    else:
        from sonet_torch import compat, config
        from sonet_torch.tasks import infer
        from sonet_torch.train.trainer import Trainer
    return config, Trainer, infer, compat


def train(pkg, seed, epochs, root, out, preset="modelnet40", rest=(),
          input_pipeline="device"):
    """One package's run: returns (steps an epoch, rows of (epoch, last
    train loss, mean train accuracy or None, test accuracy, test loss))
    and writes the rows to ``<out>/<pkg>_s<seed>.json``."""
    config, Trainer, _, _ = _modules(pkg)
    cfg = config.parse_args(list(rest), preset=preset).replace(
        dataroot=root, input_pipeline=input_pipeline, seed=seed,
        name=f"{pkg}_s{seed}", checkpoints_dir=out)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    trainer = Trainer(cfg, quiet=True, resume=False, **kw)
    steps = trainer.steps_per_epoch
    print(f"{pkg} s{seed}: {steps} steps an epoch "
          f"(len(train_loader) {len(trainer.train_loader)})", flush=True)
    rows = []
    for epoch in range(epochs):
        t0 = time.time()
        tr = trainer.train_epoch(epoch)
        ev = trainer.evaluate()
        mean = tr.get("mean_accuracy")
        rows.append((epoch, round(float(tr.get("loss", 0)), 4),
                     None if mean is None else round(mean, 4),
                     round(ev["accuracy"], 4), round(ev["loss"], 4)))
        print(pkg, seed, rows[-1], f"{time.time() - t0:.1f}s", flush=True)
    with open(os.path.join(out, f"{pkg}_s{seed}.json"), "w") as f:
        json.dump({"steps_per_epoch": steps, "rows": rows}, f)
    return steps, rows


def cross_eval(run, root, out, input_pc_num=None, batch_size=None):
    """``{pkg: infer summary}`` of the run's weights in each package, and
    the agreement: ``{"items", "same_pred"}``, the items streamed and
    how many of them both packages predict alike."""
    from sonet_torch import compat as tcompat
    files = tcompat.export_reference_checkpoint(
        run, os.path.join(out, "reference"))
    over = {"dataroot": root}
    if input_pc_num:
        over["input_pc_num"] = input_pc_num
    if batch_size:
        over["batch_size"] = batch_size
    summaries, preds = {}, {}
    for pkg in PACKAGES:
        config, _, infer, compat = _modules(pkg)
        cfg = config.load_config(os.path.join(run, "config.json")).replace(
            **over)
        pkg_run = os.path.join(out, pkg)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        compat.import_run(cfg, files, pkg_run, **kw)
        argv = ["--run", pkg_run, "--mode", "test"]
        summaries[pkg] = infer.main(argv + ([] if pkg == "jax"
                                            else ["--device", "cpu"]))
        with open(os.path.join(pkg_run, "infer", "predictions.csv")) as f:
            preds[pkg] = list(csv.DictReader(f))
    a, b = preds["jax"], preds["torch"]
    if [r["index"] for r in a] != [r["index"] for r in b]:
        raise SystemExit("the two packages streamed different items")
    agree = {"items": len(a),
             "same_pred": sum(x["pred"] == y["pred"] for x, y in zip(a, b))}
    return summaries, agree


# ---------------------------------------------------------------------------
# trajectory: the two train steps side by side from shared inputs
# ---------------------------------------------------------------------------

# the dropout masks of the step being traced or run, in the order the
# heads draw them (``fc1``'s, then ``fc2``'s)
_JAX_MASKS: list = []
_TORCH_MASKS: list = []


def _jax_dropout_module():
    """A flax ``Dropout`` that takes its mask from ``_JAX_MASKS`` instead
    of drawing it, with flax's own arithmetic (``select(mask, x / keep,
    0)``)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    class SharedMaskDropout(nn.Dropout):
        @nn.compact
        def __call__(self, inputs, deterministic=None, rng=None):
            deterministic = nn.merge_param("deterministic",
                                           self.deterministic, deterministic)
            if self.rate == 0.0 or deterministic:
                return inputs
            keep_prob = 1.0 - self.rate
            mask = jnp.broadcast_to(_JAX_MASKS.pop(0), inputs.shape)
            return jax.lax.select(mask, inputs / keep_prob,
                                  jnp.zeros_like(inputs))

    return SharedMaskDropout


def _torch_dropout(x, rate, generator=None):
    """``sonet_torch.nn.heads.dropout`` with its mask from
    ``_TORCH_MASKS``: the port's ``apply_dropout``, the harness's draws."""
    from sonet_torch.nn.heads import apply_dropout
    return apply_dropout(x, _TORCH_MASKS.pop(0), rate)


@contextlib.contextmanager
def shared_dropout():
    """Both packages' classifier heads take their dropout masks from the
    harness while the block runs: ``sonet_tpu.nn.heads`` sees a
    ``flax.linen`` whose ``Dropout`` reads ``_JAX_MASKS``, and
    ``sonet_torch.nn.heads.dropout`` reads ``_TORCH_MASKS``.  Nothing in
    either package changes."""
    from flax import linen
    from sonet_tpu.nn import heads as jheads
    from sonet_torch.nn import heads as theads

    class Flax:
        Dropout = _jax_dropout_module()

        def __getattr__(self, name):
            return getattr(linen, name)

    saved = jheads.nn, theads.dropout
    jheads.nn, theads.dropout = Flax(), _torch_dropout
    try:
        yield
    finally:
        jheads.nn, theads.dropout = saved


def mask_widths(cfg):
    """The widths of the classifier's dropout masks, in draw order."""
    return (512, 256) if cfg.dropout > 0.1 else ()


def epoch_rows(T, B, seed, epoch):
    """(S, B) item ids of an epoch of both ``Trainer``s' resident
    pipelines: a shuffle by ``default_rng(seed + 1000 + epoch)`` cut to
    whole batches."""
    order = np.random.default_rng(seed + 1000 + epoch).permutation(T)
    return order[: (T // B) * B].reshape(-1, B)


class SharedInputs:
    """Step ``s``'s batch and dropout masks, the same for every package:
    the items of row ``s % spe`` of epoch ``s // spe`` (``epoch_rows``),
    gathered raw, subsampled and augmented once by the port's
    ``apply_sample`` from draws of a generator seeded by ``(seed, s)``,
    which also draws the masks (keep probability ``1 - cfg.dropout``).
    ``raw_item(i)`` gives item ``i`` at full resolution (a dataset's
    ``raw_item``); ``T`` is the split's size.  ``augment=False`` only
    subsamples (the eval path of ``apply_sample``)."""

    def __init__(self, raw_item, T, cfg, spe, seed=0, augment=True):
        self.raw_item, self.T, self.cfg = raw_item, T, cfg
        self.spe, self.seed, self.augment = spe, seed, augment
        self._epoch = (None, None)

    def ids(self, step):
        epoch, row = divmod(step, self.spe)
        if self._epoch[0] != epoch:
            self._epoch = (epoch, epoch_rows(self.T, self.cfg.batch_size,
                                             self.seed, epoch))
        return self._epoch[1][row]

    def __call__(self, step):
        """(item ids, numpy batch, numpy boolean masks)."""
        import torch
        from sonet_torch.data import device_pipeline as tdp
        cfg, ids = self.cfg, self.ids(step)
        items = [self.raw_item(int(i)) for i in ids]
        raw = {k: torch.from_numpy(np.stack([it[k] for it in items]))
               for k in items[0]}
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        draws = tdp.draw_sample(gen, len(ids), raw["pc"].shape[1], cfg,
                                train=self.augment, dim=raw["pc"].shape[-1],
                                has_sn="sn" in raw,
                                device=torch.device("cpu"))
        batch = tdp.apply_sample(raw, draws, cfg, train=self.augment)
        keep = 1.0 - cfg.dropout
        masks = [(torch.rand((len(ids), w), generator=gen) < keep).numpy()
                 for w in mask_widths(cfg)]
        return ids, {k: v.numpy() for k, v in batch.items()}, masks


def one_ulp(variables, dtype="float32", seed=0):
    """``variables`` (flat numpy) with every parameter moved by one ulp of
    ``dtype`` up or down at random: the chaos control's start.  In
    bfloat16 the ulp is bfloat16's (2^-7 of the entry's binade): a
    float32 ulp vanishes when a weight is rounded to bfloat16 for its
    product.  Running statistics are left as they are."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, a in variables.items():
        if k.startswith("params/"):
            up = rs.rand(*a.shape) < 0.5
            if dtype == "bfloat16":
                _, e = np.frexp(a)
                step = np.ldexp(np.float32(1.0), e - 8).astype(a.dtype)
                a = np.where(a == 0, a, np.where(up, a + step, a - step))
            else:
                a = np.nextafter(a, np.where(up, np.inf, -np.inf).astype(
                    a.dtype))
            a = a.astype(variables[k].dtype)
        out[k] = a
    return out


def rel_norm(a, b, prefix):
    """||a - b|| / ||b|| over the entries under ``prefix``."""
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in b if k.startswith(prefix))
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2))
              for k in b if k.startswith(prefix))
    return (num / den) ** 0.5 if den else 0.0


# How the JAX side compiles its step: "jit" as the package's train loop
# does, or "unfused", the same program compiled without XLA's fusion
# pass.  Fusion copies an elementwise producer into each of its
# consumers, and the copies may round alike or not: the gradient of
# ``jnp.max`` after a BatchNorm (``KNNModule``'s max over the K
# neighbours) compares its recomputed operand with the forward's maximum,
# and in float32 on the CPU about 8% of the maxima then match no operand
# and pass no gradient.  Unfused, the step gives the gradient of the
# package's own equations, as ``jax.grad`` of the unjitted step does; in
# bfloat16 the two agree to rounding.
JAX_COMPILES = ("jit", "unfused")


def _compiled(fn, how):
    """``fn`` compiled as ``how`` (``JAX_COMPILES``)."""
    import jax
    jitted = jax.jit(fn)
    if how == "jit":
        return jitted
    cache = {}

    def run(*args):
        key = str(jax.tree_util.tree_map(
            lambda a: (getattr(a, "shape", None), str(getattr(a, "dtype",
                                                               ""))),
            args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                compiler_options={"xla_disable_hlo_passes": "fusion"})
        return cache[key](*args)
    return run


class JaxSide:
    """The JAX package's classify train step on the harness's batches and
    masks (``train/loops.py``'s ``train_step``, unchanged, compiled as
    ``compile`` says (``JAX_COMPILES``), without donation), its state,
    and its gradients at a state on demand."""

    def __init__(self, jc, spe, seed=0, compile="jit"):
        import jax
        import jax.numpy as jnp
        from sonet_tpu import models as jmodels
        from sonet_tpu.train import loops as jloops
        from sonet_tpu.train import losses as jlosses
        from sonet_tpu.train import state as jstate
        self.model = jmodels.build_model(jc)
        self.cfg, self.spe, self.seed = jc, spe, seed
        self.state = None
        self._jstate = jstate
        raw_train = jloops.make_classify_steps(self.model, jc, spe)[0]
        raw_train = raw_train.__wrapped__

        def step(state, batch, masks):
            _JAX_MASKS[:] = list(masks)
            out = raw_train(state, batch, jax.random.PRNGKey(seed + 1))
            if _JAX_MASKS:
                raise RuntimeError("the JAX head drew fewer masks than given")
            return out

        def grads(params, batch_stats, batch, masks, epoch):
            def loss_fn(p):
                _JAX_MASKS[:] = list(masks)
                (score, _), _ = self.model.apply(
                    {"params": p, "batch_stats": batch_stats}, batch["pc"],
                    batch.get("sn"), batch["node"], None, train=True,
                    epoch=epoch, mutable=["batch_stats"])
                return jlosses.cross_entropy(score, batch["label"])
            return jax.grad(loss_fn)(params)

        self._step = _compiled(step, compile)
        self._grads = _compiled(grads, compile)
        self._jnp = jnp

    def init(self, example, adjust=None):
        """Initial variables from ``PRNGKey(seed)`` (flat numpy), passed
        through ``adjust(variables) -> variables`` when given (a test's
        chosen weights), which the state then starts from."""
        import jax
        import jax.numpy as jnp
        from flax import traverse_util
        self.state = self._jstate.init_state(
            self.model, self.cfg, jax.random.PRNGKey(self.seed),
            (example["pc"], example.get("sn"), example["node"]),
            steps_per_epoch=self.spe)
        flat = self.variables()
        if adjust is not None:
            flat = adjust(flat)
            trees = {c: traverse_util.unflatten_dict(
                {tuple(k.split("/")[1:]): jnp.asarray(v)
                 for k, v in flat.items() if k.startswith(c + "/")})
                for c in ("params", "batch_stats")}
            self.state = self.state.replace(
                params=trees["params"], batch_stats=trees["batch_stats"])
        return flat

    def step(self, batch, masks):
        jnp = self._jnp
        self.prev = self.state
        self.state, met = self._step(
            self.state, {k: jnp.asarray(v) for k, v in batch.items()},
            [jnp.asarray(m) for m in masks])
        return float(met["loss"])

    def variables(self):
        """The weights and running statistics as flat numpy."""
        from sonet_torch.convert import flatten
        s = self.state
        return {k: np.array(v) for k, v in flatten(
            {"params": s.params, "batch_stats": s.batch_stats}).items()}

    def full_state(self):
        """(variables, Adam's first and second moments keyed as the
        parameters, its update count), flat numpy: what
        ``TorchSide.load_state`` takes."""
        from sonet_torch.convert import flatten
        s = self.state
        mu, nu, count = {}, {}, None
        for label, inner in s.opt_state.inner_states.items():
            adam = inner.inner_state[0]
            count = int(adam.count)
            for store, tree in ((mu, adam.mu), (nu, adam.nu)):
                for k, v in flatten({"params": tree}).items():
                    if (k.startswith("params/encoder/")) == (
                            label == "encoder"):
                        store[k] = np.array(v)
        return self.variables(), mu, nu, count

    def grads_before_last_step(self, batch, masks):
        """The gradients the last step took (at its starting state)."""
        from sonet_torch.convert import flatten
        jnp, s = self._jnp, self.prev
        epoch = jnp.float32(int(s.step) // max(self.spe, 1))
        g = self._grads(s.params, s.batch_stats,
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        [jnp.asarray(m) for m in masks], epoch)
        return {k: np.array(v) for k, v in flatten({"params": g}).items()}


class TorchSide:
    """The port's classify train step (``train/loops.py``) on the
    harness's batches and masks, on the CPU; counts, per step, the global
    max's tied winners and the node pooling's tied maxima."""

    def __init__(self, tc, spe, variables):
        from sonet_torch import train as ttrain
        from sonet_torch.convert import load_jax_variables
        from sonet_torch.models import build_model
        model = build_model(tc, device="cpu")
        load_jax_variables(model, variables)
        self.state = ttrain.init_state(tc, device="cpu", model=model,
                                       steps_per_epoch=spe)
        self._train = ttrain.make_classify_steps(tc, spe)[0]
        self.ties = {}
        model.encoder.register_forward_hook(self._count_ties)

    def _count_ties(self, module, args, out):
        import torch
        with torch.no_grad():
            f = out.final_pn_out
            top = f.max(1, keepdim=True).values
            glob = int(((f == top).sum(1) > 1).sum())
            data, ids, pooled = (out.first_pn_out, out.min_idx.long(),
                                 out.first_pn_out_masked_max)
            at = torch.gather(pooled, 1, ids[..., None].expand_as(data))
            eq = (data == at).float()
            per = torch.zeros_like(pooled, dtype=torch.float32)
            per.scatter_add_(1, ids[..., None].expand_as(data), eq)
            occupied = (out.counts > 0)[..., None]
            pool = int(((per > 1) & occupied).sum())
        self.ties = {"global": glob, "pooling": pool}

    def step(self, batch, masks):
        import torch
        _TORCH_MASKS[:] = [torch.from_numpy(m) for m in masks]
        self.state, met = self._train(
            self.state, {k: torch.from_numpy(v) for k, v in batch.items()},
            None)
        if _TORCH_MASKS:
            raise RuntimeError("the port's head drew fewer masks than given")
        return float(met["loss"])

    def variables(self):
        """The weights and running statistics as flat numpy copies."""
        from sonet_torch.convert import to_jax_variables
        return {k: v.copy() for k, v in
                to_jax_variables(self.state.model).items()}

    def load_state(self, variables, mu, nu, count):
        """Put the JAX package's state (``JaxSide.full_state``) in place:
        weights and running statistics, Adam's moments, its step count
        and the update count the schedules read."""
        import torch
        from sonet_torch.convert import (_kernel_to_torch, _torch_key,
                                         load_jax_variables)
        model, opt = self.state.model, self.state.optimizer
        load_jax_variables(model, variables)
        params = dict(model.named_parameters())
        for key, m in mu.items():
            tkey, is_kernel = _torch_key(key)
            m, v = ((_kernel_to_torch(a) if is_kernel else a)
                    for a in (m, nu[key]))
            opt.state[params[tkey]] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.from_numpy(np.ascontiguousarray(m)),
                "exp_avg_sq": torch.from_numpy(np.ascontiguousarray(v))}
        self.state.step = count

    def grads(self):
        from sonet_torch.convert import gradients_to_jax
        return gradients_to_jax(self.state.model)


def gradient_differences(tg, jg, cg):
    """{parameter: (||t - j|| / ||j||, ||c - t|| / ||j||)} over the
    parameters with a nonzero JAX gradient: the port's gradients ``tg``
    against the JAX package's ``jg``, and the control's ``cg`` against
    the port's on the same scale."""
    out = {}
    for k, j in jg.items():
        den = float(np.linalg.norm(j))
        if den:
            out[k] = (float(np.linalg.norm(tg[k] - j)) / den,
                      float(np.linalg.norm(cg[k] - tg[k])) / den)
    return out


def run_trajectory(jc, tc, inputs, steps, log=print, compile="jit"):
    """Both packages' train steps side by side for ``steps`` steps from the
    JAX package's initial variables, on ``inputs`` (``SharedInputs``),
    with the chaos control: the port from the same weights moved by one
    ulp (``one_ulp``); ``compile``: the JAX side's (``JAX_COMPILES``).

    Returns ``(rows, verdict)``: a row a step (both losses, the relative
    norms of the parameters' and the running statistics' differences
    against the JAX package and the control's, the port's tie counts),
    and the first step at which the parameters' difference exceeds
    ``FACTOR`` times the control's, with the gradients' differences there
    (``gradient_differences``) and the parameters whose gradient differs
    most and most over the control's (None when no step does)."""
    import time
    _, example, _ = inputs(0)
    jside = JaxSide(jc, inputs.spe, seed=inputs.seed, compile=compile)
    init = jside.init(example)
    port = TorchSide(tc, inputs.spe, init)
    ctl = TorchSide(tc, inputs.spe,
                    one_ulp(init, tc.compute_dtype, inputs.seed))
    rows, verdict = [], None
    for s in range(steps):
        t0 = time.time()
        ids, batch, masks = inputs(s)
        lj = jside.step(batch, masks)
        lt = port.step(batch, masks)
        lc = ctl.step(batch, masks)
        jv, tv, cv = jside.variables(), port.variables(), ctl.variables()
        row = {"step": s, "epoch": s // inputs.spe, "items": ids.tolist(),
               "loss_jax": lj, "loss_torch": lt, "loss_control": lc,
               "params": rel_norm(tv, jv, "params/"),
               "params_control": rel_norm(cv, tv, "params/"),
               "stats": rel_norm(tv, jv, "batch_stats/"),
               "stats_control": rel_norm(cv, tv, "batch_stats/"),
               "ties": dict(port.ties)}
        row["over"] = row["params"] > FACTOR * row["params_control"]
        if row["over"] and verdict is None:
            diffs = gradient_differences(
                port.grads(), jside.grads_before_last_step(batch, masks),
                ctl.grads())
            key = max(diffs, key=lambda k: diffs[k][0])
            over = max(diffs, key=lambda k: diffs[k][0]
                       / max(diffs[k][1], 1e-30))
            verdict = {"step": s, "param": key, "grad_rel": diffs[key][0],
                       "control_grad_rel": diffs[key][1],
                       "param_over_control": over, "grads": diffs}
        row["seconds"] = time.time() - t0
        rows.append(row)
        log(f"step {s}: loss jax {lj:.6f} torch {lt:.6f} "
            f"control {lc:.6f} | params {row['params']:.3e} "
            f"(control {row['params_control']:.3e}) | stats "
            f"{row['stats']:.3e} (control {row['stats_control']:.3e}) | "
            f"ties global {port.ties['global']} pooling "
            f"{port.ties['pooling']} | {row['seconds']:.1f}s")
    return rows, verdict


def run_steps(jc, tc, inputs, steps, record=None, adjust=None,
              compile="jit"):
    """Step by step: before each of ``steps`` steps the port takes the JAX
    package's state (weights, running statistics, Adam's moments and
    count) and both make one step on the same batch and masks, so each
    row holds one step's differences, none carried over from the steps
    before.  Returns ``(rows, jax_record)``; a row has both losses, both
    updates' parameters and running statistics as flat numpy
    (``"jax"`` / ``"torch"``: (loss, variables after), with the state
    before under ``"before"``).  Given a record of an earlier call, the
    JAX side is not run again (a planted fault's run).  ``adjust``: as
    ``JaxSide.init``'s; ``compile``: the JAX side's (``JAX_COMPILES``)."""
    replay = isinstance(record, dict)
    if replay:
        jside = None
        init = record["init"]
    else:
        _, example, _ = inputs(0)
        jside = JaxSide(jc, inputs.spe, seed=inputs.seed, compile=compile)
        init = jside.init(example, adjust)
        record = {"init": init, "steps": []}
    port = TorchSide(tc, inputs.spe, init)
    rows = []
    for s in range(steps):
        _, batch, masks = inputs(s)
        if replay:
            before, lj, jv = record["steps"][s]
        else:
            before = jside.full_state()
            lj = jside.step(batch, masks)
            jv = jside.variables()
            record["steps"].append((before, lj, jv))
        port.load_state(*before)
        lt = port.step(batch, masks)
        rows.append({"step": s, "before": before[0], "jax": (lj, jv),
                     "torch": (lt, port.variables())})
    return rows, record


def trajectory(dataroot, out, dtype, steps, seed=0, rest=(),
               compile="jit"):
    """``config.modelnet40()`` (with ``--<Config field> value`` pairs from
    ``rest``) at ``dtype`` on the train split of ``dataroot``: both
    packages side by side (``run_trajectory``, the JAX side compiled as
    ``compile``); rows and verdict to ``<out>/trajectory_<dtype>.json``
    (``trajectory_<dtype>_<compile>.json`` unless ``compile`` is "jit")."""
    from sonet_tpu import config as jconfig
    from sonet_torch import config as tconfig
    from sonet_torch.data.modelnet import ModelNetDataset
    over = dict(dataroot=dataroot, seed=seed,
                compute_dtype="bfloat16" if dtype == "bfloat16" else
                "float32")
    jc = jconfig.parse_args(list(rest), preset="modelnet40").replace(**over)
    tc = tconfig.parse_args(list(rest), preset="modelnet40").replace(**over)
    train = ModelNetDataset(dataroot, "train", tc)
    spe = len(train) // tc.batch_size
    print(f"trajectory {dtype}: {len(train)} train items, {spe} steps an "
          f"epoch, {steps} steps; B={tc.batch_size} N={tc.input_pc_num} "
          f"M={tc.node_num} k={tc.k} som_k={tc.som_k} F={tc.feature_num} "
          f"lr={tc.lr} dropout={tc.dropout} pooling {tc.pooling}; the JAX "
          f"step compiled {compile}",
          flush=True)
    inputs = SharedInputs(train.raw_item, len(train), tc, spe, seed)
    with shared_dropout():
        rows, verdict = run_trajectory(
            jc, tc, inputs, steps,
            log=lambda line: print(line, flush=True), compile=compile)
    tied = [r["step"] for r in rows if r["ties"]["global"]]
    line = (f"verdict {dtype} ({compile}): first step over {FACTOR:g}x the "
            f"control: "
            + ("none" if verdict is None else
               f"{verdict['step']} (largest gradient difference: "
               f"{verdict['param']}, {verdict['grad_rel']:.3e} against "
               f"the control's {verdict['control_grad_rel']:.3e}; most "
               f"over the control's: {verdict['param_over_control']}, "
               f"{verdict['grads'][verdict['param_over_control']][0]:.3e} "
               f"against "
               f"{verdict['grads'][verdict['param_over_control']][1]:.3e})")
            + f" in {len(rows)} steps; at the last step the parameters' "
            f"difference is {rows[-1]['params']:.3e} against the control's "
            f"{rows[-1]['params_control']:.3e}; global-max ties on "
            f"{len(tied)} steps")
    print(line, flush=True)
    name = dtype if compile == "jit" else f"{dtype}_{compile}"
    with open(os.path.join(out, f"trajectory_{name}.json"), "w") as f:
        json.dump({"dtype": dtype, "compile": compile, "steps_per_epoch": spe,
                   "factor": FACTOR, "verdict": verdict, "line": line,
                   "rows": rows}, f)
    return rows, verdict



def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--dataroot", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--preset", default="modelnet40")
    t.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    t.add_argument("--epochs", type=int, default=12)
    t.add_argument("--input_pipeline", default="device",
                   choices=("host", "device"))
    t.add_argument("--run", nargs=2, metavar=("PKG", "SEED"),
                   help=argparse.SUPPRESS)   # one package's run
    e = sub.add_parser("eval")
    e.add_argument("--run", required=True, help="a run directory of the "
                   "port (config.json + ckpt/)")
    e.add_argument("--dataroot", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--input_pc_num", type=int, default=None)
    e.add_argument("--batch_size", type=int, default=None)
    j = sub.add_parser("trajectory")
    j.add_argument("--dataroot", required=True, help="a ModelNet tree with "
                   "its SOM nodes")
    j.add_argument("--out", required=True)
    j.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"],
                   choices=("float32", "bfloat16"))
    j.add_argument("--steps", type=int, default=200)
    j.add_argument("--seed", type=int, default=0)
    j.add_argument("--jax_compile", default="jit", choices=JAX_COMPILES)
    args, rest = p.parse_known_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    os.makedirs(args.out, exist_ok=True)

    if args.cmd == "trajectory":
        return {dtype: trajectory(args.dataroot, args.out, dtype,
                                  args.steps, args.seed, rest,
                                  args.jax_compile)
                for dtype in args.dtype}

    if args.cmd == "eval":
        if rest:
            p.error(f"unrecognized arguments: {' '.join(rest)}")
        summaries, agree = cross_eval(args.run, args.dataroot, args.out,
                                      args.input_pc_num, args.batch_size)
        for pkg in PACKAGES:
            print(f"{pkg} infer: {json.dumps(summaries[pkg])}")
        print(f"agreement: {json.dumps(agree)}", flush=True)
        return summaries, agree

    if args.run:
        return train(args.run[0], int(args.run[1]), args.epochs,
                     args.dataroot, args.out, args.preset, rest,
                     args.input_pipeline)
    env = dict(os.environ, PYTHONPATH=REPO)
    for seed in args.seeds:
        runs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "train",
             "--dataroot", args.dataroot, "--out", args.out,
             "--preset", args.preset, "--epochs", str(args.epochs),
             "--input_pipeline", args.input_pipeline,
             "--run", pkg, str(seed)] + rest, env=env) for pkg in PACKAGES]
        for r in runs:
            if r.wait():
                sys.exit(f"a run failed ({r.returncode})")


if __name__ == "__main__":
    main()
