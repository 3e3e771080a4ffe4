"""The port's training against the JAX package's, on the CPU, at
``tiny_test`` size in float32, with weights carried across by
``sonet_torch.convert``.

JAX's random streams cannot be reproduced in torch, so the parity runs
have dropout off (``dropout=0``) and point dropout off (the default lower
limit 1.0); dropout and point dropout are tested by their own statistics.
The JAX side runs its Pallas kernel in interpret mode for
``pooling="sorted_window"``, at highest matmul precision
(tests/conftest.py).

Tolerances, and why:
* BatchNorm output and running statistics: 1e-5 relative -- the same
  float32 arithmetic, summed in another order.
* losses per step: 1e-4 relative; first-step gradients: 1e-3 of the
  tensor's largest entry plus 1e-6 absolute (the noise-level gradients of
  biases whose true gradient is 0, about 1e-7).
* parameters after three steps, stated against lr: Adam divides a
  gradient by its own magnitude, so a noise-level gradient whose sign
  differs between the two sides becomes a step of +lr on one and -lr on
  the other.  An Adam step moves an entry by about lr at most, so any two
  runs from the same weights stay within about 2 lr a step and no bound on
  the largest difference can tell them apart; what is held is that all
  but 0.2% of the entries are within 0.1 lr.  The parity runs use lr = 1e-5
  so that those flips stay small and do not steer the next steps (at
  lr = 1e-3 the loss is non-smooth enough at this size that a few flipped
  entries move it by 0.1% per step).
* batch statistics after three steps and the eval forward: 1e-4 of
  max(1, the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu.nn import layers as jl
from sonet_tpu.train import losses as jlosses
from sonet_tpu.train import loops as jloops
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.convert import (flatten, gradients_to_jax,
                                 load_jax_variables, to_jax_variables)
from sonet_torch.models import build_model
from sonet_torch.nn import layers as tl
from sonet_torch.nn.heads import dropout

torch.set_num_threads(2)

LR = 1e-5
STEPS = 3
SPE = 2          # steps per epoch: the third step runs in epoch 1


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows", [600, 8400])          # below / above 8192
@pytest.mark.parametrize("momentum,epoch", [(0.1, 0), (0.1, 1), (0.1, 5),
                                            (0.1, 9), (0.005, 0),
                                            (0.005, 1)])
def test_batchnorm_train_matches_jax(n_rows, momentum, epoch):
    """decay step 2, decay 0.5: momentum 0.1 at epochs 0 and 1, 0.025 at
    5, clamped to 0.01 at 9; 0.005 stays unclamped at epoch 0 and is
    clamped to 0.01 from epoch 1."""
    rs = np.random.RandomState(n_rows + epoch)
    C = 6
    x = (rs.randn(2, n_rows // 2, C) * rs.uniform(0.5, 3.0, C)
         + 2.0 * rs.randn(C)).astype(np.float32)
    stats = {"mean": rs.randn(C).astype(np.float32),
             "var": rs.uniform(0.5, 2.0, C).astype(np.float32)}
    params = {"scale": rs.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rs.randn(C).astype(np.float32)}
    kw = dict(momentum=momentum, momentum_decay_step=2, momentum_decay=0.5)
    want, mut = jl.BatchNorm(**kw).apply(
        {"params": params, "batch_stats": stats}, x,
        use_running_average=False, epoch=jnp.float32(epoch),
        mutable=["batch_stats"])
    bn = tl.BatchNorm(C, **kw).train()
    with torch.no_grad():
        for name, a in (("weight", params["scale"]), ("bias", params["bias"]),
                        ("running_mean", stats["mean"]),
                        ("running_var", stats["var"])):
            getattr(bn, name).copy_(torch.from_numpy(a))
    got = bn(torch.from_numpy(x), epoch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    assert set(dict(bn.named_buffers())) == {"running_mean", "running_var"}


# ---------------------------------------------------------------------------
# learning rates
# ---------------------------------------------------------------------------

def test_halving_schedule_matches_jax():
    args = (1e-3, 2, 0.5, 3e-5, 5)       # lr0, decay step, ratio, clip, spe
    want = jstate.halving_schedule(*args)
    got = ttrain.halving_schedule(*args)
    # every step across the epoch boundaries 0..12, down to the clip
    for step in range(0, 65):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    # the e-1 quirk: epochs 0, 1 and 2 train at lr0, epoch 3 at lr0 / 2
    assert got(14) == 1e-3 and got(15) == 5e-4
    assert got(10 ** 6) == 3e-5


def test_optimizer_groups_and_pretrain_ratio():
    cfg = tcfg.tiny_test().replace(pretrain="encoder.pth",
                                   pretrain_lr_ratio=0.25)
    model = build_model(cfg, device="cpu")
    opt, schedules = ttrain.make_optimizer(model, cfg, steps_per_epoch=4)
    names = [g["name"] for g in opt.param_groups]
    assert names == ["encoder", "head"]
    n_enc = sum(p.numel() for p in opt.param_groups[0]["params"])
    assert n_enc == sum(p.numel() for p in model.encoder.parameters())
    assert schedules["encoder"](0) == pytest.approx(0.25 * cfg.lr)
    assert schedules["head"](0) == pytest.approx(cfg.lr)
    g = opt.param_groups[0]
    assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    assert g["weight_decay"] == 0


# ---------------------------------------------------------------------------
# three train steps against the JAX package
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    rs = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    sn = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    # one far node: guaranteed empty, exercising the empty-node gradient
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    label = rs.randint(0, cfg.classes, B).astype(np.int32)
    return {"pc": pc, "sn": sn, "node": node, "label": label}


def _np_flat(tree):
    return {k: np.array(v) for k, v in flatten(tree).items()}


@pytest.fixture(scope="module", params=["scatter", "sorted_window"])
def trajectories(request):
    """Both sides from the same weights through the same three batches:
    per-step losses, first-step gradients, the state after three steps,
    and the eval metrics on the first batch."""
    over = dict(pooling=request.param, dropout=0.0, batch_size=4, lr=LR,
                bn_momentum_decay_step=1)
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    batches = [_batch(jc, seed) for seed in range(STEPS)]
    b0 = batches[0]
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0),
                           (b0["pc"], b0["sn"], b0["node"]),
                           steps_per_epoch=SPE)
    init = _np_flat({"params": js.params, "batch_stats": js.batch_stats})

    @jax.jit
    def jax_grads(params, batch_stats, b):
        def loss_fn(p):
            (score, _), _ = jm.apply(
                {"params": p, "batch_stats": batch_stats}, b["pc"], b["sn"],
                b["node"], None, train=True, epoch=jnp.float32(0),
                mutable=["batch_stats"])
            return jlosses.cross_entropy(score, b["label"])
        return jax.grad(loss_fn)(params)

    j_grads = _np_flat({"params": jax_grads(js.params, js.batch_stats, b0)})

    model = build_model(tc, device="cpu")
    load_jax_variables(model, init)
    ts = ttrain.init_state(tc, device="cpu", model=model,
                           steps_per_epoch=SPE)
    j_train, j_eval = jloops.make_classify_steps(jm, jc, SPE)
    t_train, t_eval = ttrain.make_classify_steps(tc, SPE)
    j_losses, t_losses = [], []
    t_grads = None
    for i, b in enumerate(batches):
        js, jmet = j_train(js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(1))
        ts, tmet = t_train(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                           torch.Generator().manual_seed(1))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
        if i == 0:
            t_grads = gradients_to_jax(ts.model)
    j_ev = jax.tree.map(np.asarray, j_eval(
        js, {k: jnp.asarray(v) for k, v in b0.items()}))
    t_ev = t_eval(ts, {k: torch.from_numpy(v) for k, v in b0.items()})
    return dict(
        init=init, j_losses=j_losses, t_losses=t_losses, j_grads=j_grads,
        t_grads=t_grads,
        j_final=_np_flat({"params": js.params,
                          "batch_stats": js.batch_stats}),
        t_final=to_jax_variables(ts.model), t_step=ts.step,
        j_eval=j_ev, t_eval={k: v.numpy() for k, v in t_ev.items()})


def test_train_losses_match_jax(trajectories):
    r = trajectories
    assert r["t_step"] == STEPS
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], rtol=1e-4)


def test_first_step_gradients_match_jax(trajectories):
    jg, tg = trajectories["j_grads"], trajectories["t_grads"]
    assert set(tg) == set(jg)
    for k, want in jg.items():
        err = float(np.abs(tg[k] - want).max())
        tol = 1e-3 * float(np.abs(want).max()) + 1e-6
        assert err <= tol, (k, err, tol)
    # pooling carries a real gradient into the first PointNet
    k = "params/encoder/first_pointnet/PointLayer_0/Dense_0/kernel"
    assert np.abs(tg[k]).max() > 1e-3


def test_params_and_batch_stats_after_three_steps(trajectories):
    jf, tf = trajectories["j_final"], trajectories["t_final"]
    assert set(tf) == set(jf)
    diffs = np.concatenate([np.abs(tf[k] - jf[k]).ravel()
                            for k in jf if k.startswith("params/")])
    assert (diffs > 0.1 * LR).mean() <= 2e-3, (diffs > 0.1 * LR).mean()
    for k in jf:
        if k.startswith("batch_stats/"):
            scale = max(1.0, float(np.abs(jf[k]).max()))
            assert np.abs(tf[k] - jf[k]).max() <= 1e-4 * scale, k


def test_stopped_biases_never_move(trajectories):
    """The bias of every dense layer that a BatchNorm follows stays at its
    initial value on both sides; every other tensor moved."""
    init, jf, tf = (trajectories["init"], trajectories["j_final"],
                    trajectories["t_final"])
    stopped = {k.replace("/BatchNorm_0/scale", "/Dense_0/bias")
               for k in init if k.endswith("/BatchNorm_0/scale")}
    assert len(stopped) == 8
    for k in init:
        if not k.startswith("params/"):
            continue
        if k in stopped:
            np.testing.assert_array_equal(tf[k], init[k])
            np.testing.assert_array_equal(jf[k], init[k])
        else:
            assert not np.array_equal(tf[k], init[k]), k


def test_eval_step_matches_jax(trajectories):
    je, te = trajectories["j_eval"], trajectories["t_eval"]
    scale = max(1.0, float(np.abs(je["score"]).max()))
    assert np.abs(te["score"] - je["score"]).max() <= 1e-4 * scale
    # a cross-entropy moves at most twice as far as the logits it reads
    for k in ("loss_i", "loss"):
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=2e-4 * scale)
    np.testing.assert_array_equal(te["correct_i"], je["correct_i"])
    assert float(te["accuracy"]) == float(je["accuracy"])


# ---------------------------------------------------------------------------
# random draws: point dropout and dropout
# ---------------------------------------------------------------------------

def test_random_point_dropout_identity_at_one():
    pc, sn = torch.randn(2, 50, 3), torch.randn(2, 50, 3)
    out_pc, out_sn = ttrain.random_point_dropout(pc, sn, None, 1.0)
    assert out_pc is pc and out_sn is sn


@pytest.mark.parametrize("seed", range(4))
def test_random_point_dropout_draws_rows(seed):
    N, lower = 200, 0.3
    pc = torch.arange(2 * N * 3, dtype=torch.float32).reshape(2, N, 3)
    sn = -pc
    gen = torch.Generator().manual_seed(seed)
    out_pc, out_sn = ttrain.random_point_dropout(pc, sn, gen, lower)
    assert out_pc.shape == pc.shape
    torch.testing.assert_close(out_sn, -out_pc, rtol=0, atol=0)
    idx = (out_pc[0, :, 0] / 3).long()           # the source row of each slot
    torch.testing.assert_close(out_pc, pc[:, idx], rtol=0, atol=0)
    keep = len(set(idx.tolist()))
    assert round(lower * N) - 1 <= keep <= N
    assert len(set(idx[:keep].tolist())) == keep  # the first keep_num distinct
    assert set(idx[keep:].tolist()) <= set(idx[:keep].tolist())
    # the same subset for every cloud of the batch
    torch.testing.assert_close(out_pc[1] - out_pc[0],
                               torch.full((N, 3), 3.0 * N), rtol=0, atol=0)


def test_dropout_statistics_and_scaling():
    rate = 0.7
    x = torch.ones(400, 512)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        1.0 / (1.0 - rate)))
    # keep share 0.3 over 204,800 draws: 4 standard deviations is 0.004
    assert abs(float(kept.float().mean()) - (1.0 - rate)) < 0.004
    assert abs(float(y.mean()) - 1.0) < 0.004 / (1.0 - rate)
    a = dropout(x, rate, torch.Generator().manual_seed(1))
    b = dropout(x, rate, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_classifier_dropout_only_in_training():
    cfg = tcfg.tiny_test()                       # dropout 0.5
    model = build_model(cfg, device="cpu")
    feature = torch.randn(4, cfg.feature_num)
    head = model.classifier
    with torch.no_grad():
        e1, e2 = head(feature), head(feature)
        torch.testing.assert_close(e1, e2, rtol=0, atol=0)
        head.train()
        t1 = head(feature, 0, torch.Generator().manual_seed(0))
        t2 = head(feature, 0, torch.Generator().manual_seed(0))
        t3 = head(feature, 0, torch.Generator().manual_seed(1))
    torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    assert not torch.equal(t1, t3)
