"""The port's oracles and dead code against the JAX package's, on the CPU,
and the rematerialised first PointNet (``cfg.remat``).

* ``ops.segment_max_sorted`` (forward, gradient) and ``sort_by_segment``
  against ``sonet_tpu.ops.segment_sorted`` on ``tests/test_kernels.py``'s
  cases: forward and sort ``==`` (a max picks one of its inputs, a stable
  sort is one order), gradient within 1e-6 (the same exact tie counts).
* the one-hot oracles (``segment_max_onehot``, ``segment_sum_onehot``,
  ``segment_mean_onehot``) and ``segment_max_scatter`` within 1e-6.
* ``nn.Transformer`` with weights carried by ``convert.py`` within 1e-5
  (float32 summed in another order), ``rotation_matrix_y`` within 1e-6.
* remat: a ``tiny_test`` float32 train step with ``remat=True`` ``==``
  the same step without it (loss, gradients, update, running statistics:
  the recomputation replays the same kernels on the same inputs), and
  held to ``sonet_tpu``'s remat step at ``tests/test_torch_train.py``'s
  tolerances (losses 1e-4 relative, gradients 1e-3 of the tensor's
  largest entry plus 1e-6, statistics 1e-4 of max(1, largest)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu import ops as jops
from sonet_tpu.nn import encoder as jenc
from sonet_tpu.train import loops as jloops
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import ops as tops
from sonet_torch import train as ttrain
from sonet_torch.convert import (flatten, gradients_to_jax,
                                 load_jax_variables, to_jax_variables)
from sonet_torch.models import build_model
from sonet_torch.nn import Transformer, rotation_matrix_y
from sonet_torch.nn import layers as tl

torch.set_num_threads(2)

LR = 1e-5
SPE = 2


def _case(B=2, N=70, C=9, M=8, seed=0, sorted_ids=True, with_ties=False):
    """``tests/test_kernels.py``'s inputs, as numpy."""
    rs = np.random.RandomState(seed)
    data = rs.randn(B, N, C).astype(np.float32)
    ids = rs.randint(0, M, (B, N)).astype(np.int32)
    ids[ids == 3] = 2                                    # an empty node
    if with_ties:
        data[:, 1] = data[:, 0]
        ids[:, 1] = ids[:, 0]
    if sorted_ids:
        order = np.argsort(ids, axis=1)
        ids = np.take_along_axis(ids, order, 1)
        data = np.take_along_axis(data, order[..., None], 1)
    return data, ids


CASES = [dict(), dict(with_ties=True), dict(seed=1, N=33, C=5, M=6),
         dict(seed=2, B=3, N=200, C=16, M=12, with_ties=True)]


def _grad_sq(fn, data):
    """d/d data of sum(fn(data) ** 2), torch."""
    x = torch.from_numpy(data).requires_grad_(True)
    (fn(x) ** 2).sum().backward()
    return x.grad.numpy()


# ---------------------------------------------------------------------------
# segment_max_sorted, sort_by_segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_segment_max_sorted_matches_jax(case):
    data, ids = _case(**case)
    M = case.get("M", 8)
    want = np.asarray(jops.segment_max_sorted(jnp.asarray(data),
                                              jnp.asarray(ids), M))
    got = tops.segment_max_sorted(torch.from_numpy(data),
                                  torch.from_numpy(ids), M)
    np.testing.assert_array_equal(got.numpy(), want)
    g_want = np.asarray(jax.grad(lambda d: jnp.sum(jops.segment_max_sorted(
        d, jnp.asarray(ids), M) ** 2))(jnp.asarray(data)))
    g_got = _grad_sq(lambda x: tops.segment_max_sorted(
        x, torch.from_numpy(ids), M), data)
    np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-6)


def test_segment_max_sorted_splits_ties():
    data = torch.tensor([[[2.0], [2.0], [1.0]]], requires_grad=True)
    ids = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    tops.segment_max_sorted(data, ids, 2).sum().backward()
    np.testing.assert_array_equal(data.grad[0, :, 0].numpy(),
                                  [0.5, 0.5, 1.0])


def test_segment_max_sorted_bf16_keeps_its_dtype():
    data, ids = _case(with_ties=True)
    x = torch.from_numpy(data).bfloat16().requires_grad_(True)
    i = torch.from_numpy(ids)
    out = tops.segment_max_sorted(x, i, 8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.detach().float().numpy(),
        tops.segment_max_scatter(x.detach(), i, 8).float().numpy())
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [3, 4])
def test_sort_by_segment_matches_jax(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 5, (2, 20)).astype(np.int32)
    x = rs.randn(2, 20, 4).astype(np.float32)
    y = rs.randn(2, 20).astype(np.float32)
    want = [np.asarray(a) for a in jops.sort_by_segment(
        jnp.asarray(ids), jnp.asarray(x))]
    got = [a.numpy() for a in tops.sort_by_segment(
        torch.from_numpy(ids), torch.from_numpy(x), torch.from_numpy(y))]
    for g, w in zip(got[:4], want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    perm, inv = got[1], got[2]
    np.testing.assert_array_equal(got[4], np.take_along_axis(y, perm, 1))
    np.testing.assert_array_equal(np.take_along_axis(got[3], inv[..., None],
                                                     1), x)


# ---------------------------------------------------------------------------
# the one-hot oracles and the scatter name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("block_m", [16, 3])
def test_segment_max_onehot_matches_jax(sorted_ids, block_m):
    data, ids = _case(sorted_ids=sorted_ids, with_ties=True)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    want = np.asarray(jops.segment_max_onehot(jd, ji, 8, block_m=block_m))
    got = tops.segment_max_onehot(torch.from_numpy(data),
                                  torch.from_numpy(ids), 8, block_m=block_m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    g_want = np.asarray(jax.grad(lambda d: jnp.sum(jops.segment_max_onehot(
        d, ji, 8, block_m=block_m) ** 2))(jd))
    g_got = _grad_sq(lambda x: tops.segment_max_onehot(
        x, torch.from_numpy(ids), 8, block_m=block_m), data)
    np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_max_scatter_matches_jax(sorted_ids):
    data, ids = _case(sorted_ids=sorted_ids)
    want = np.asarray(jops.segment_max_scatter(jnp.asarray(data),
                                               jnp.asarray(ids), 8))
    got = tops.segment_max_scatter(torch.from_numpy(data),
                                   torch.from_numpy(ids), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tops.segment_max_scatter is tops.segment_max


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_segment_sum_and_mean_onehot_match_jax(dtype):
    data, ids = _case(sorted_ids=False)
    onehot = np.eye(8, dtype=np.float32)[ids]            # (B, N, M)
    jd = jnp.asarray(data).astype(dtype)
    joh = jnp.asarray(onehot).astype(dtype)
    td = torch.from_numpy(np.array(jd.astype(jnp.float32)))
    toh = torch.from_numpy(onehot)
    if dtype is not np.float32:
        td, toh = td.bfloat16(), toh.bfloat16()
    for jfn, tfn in ((jops.segment_sum_onehot, tops.segment_sum_onehot),
                     (jops.segment_mean_onehot, tops.segment_mean_onehot)):
        want = np.asarray(jfn(jd, joh))
        got = tfn(td, toh)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Transformer, rotation_matrix_y
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_transformer_matches_jax(train):
    cfg_over = dict(dropout=0.0)
    jc, tc = (jcfg.tiny_test().replace(**cfg_over),
              tcfg.tiny_test().replace(**cfg_over))
    x = np.random.RandomState(6).randn(4, 50, 3).astype(np.float32)
    jt = jenc.Transformer(jc)
    variables = jt.init(jax.random.PRNGKey(2), jnp.asarray(x))
    flat = {k: np.array(v) for k, v in flatten(variables).items()}
    rs = np.random.RandomState(8)
    for k, v in flat.items():             # statistics off 0 and 1
        if k.endswith("/mean"):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(
                     jnp.asarray, _nested(flat, "batch_stats"))}
    model = Transformer(tc, torch.Generator().manual_seed(0))
    load_jax_variables(model, flat)
    model.train(train)
    if train:
        want, mut = jt.apply(variables, jnp.asarray(x), train=True,
                             epoch=jnp.float32(0), mutable=["batch_stats"])
    else:
        want = jt.apply(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x), epoch=0)
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if train:
        tstats = to_jax_variables(model)
        for k, v in flatten({"batch_stats": mut["batch_stats"]}).items():
            np.testing.assert_allclose(tstats[k], np.asarray(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # every tree entry of the JAX module has its place in the port's
    assert set(to_jax_variables(model)) == set(flat)


def _nested(flat, collection):
    out = {}
    for k, v in flat.items():
        coll, *path, leaf = k.split("/")
        if coll != collection:
            continue
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_rotation_matrix_y_matches_jax():
    s = np.asarray([[0.0], [0.5], [-0.9], [1.0]], np.float32)
    want = np.asarray(jenc.rotation_matrix_y(jnp.asarray(s)))
    got = rotation_matrix_y(torch.from_numpy(s)).numpy()
    assert got.shape == (4, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    r = got[1]                       # a rotation: R R^T = I (up to 1e-5)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    """``tests/test_torch_train.py``'s batches.  The global max over nodes
    routes its gradient to the first winner, and a batch whose node rows
    tie to the last bit sends it to another node in each package: with
    the normals drawn after the nodes, 15 of the 256 winners of the seed-0
    batch differ, moving the scatter path's first-step gradients by up to
    3.7% of a tensor's largest entry, remat or not."""
    rs = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    sn = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    return {"pc": pc, "sn": sn, "node": node,
            "label": rs.randint(0, cfg.classes, B).astype(np.int32)}


def _steps(cfg, init, batches):
    """(losses, first-step gradients, final state) of the port's steps
    from ``init`` through ``batches``."""
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, init)
    st = ttrain.init_state(cfg, device="cpu", model=model,
                           steps_per_epoch=SPE)
    train_step, _ = ttrain.make_steps(cfg, SPE)
    losses, grads = [], None
    for i, b in enumerate(batches):
        st, m = train_step(st, {k: torch.from_numpy(v) for k, v in b.items()},
                           torch.Generator().manual_seed(1))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = gradients_to_jax(st.model)
    return losses, grads, {k: v.clone() for k, v in
                           st.model.state_dict().items()}


@pytest.fixture(scope="module", params=["scatter", "sorted_window"])
def remat_runs(request):
    over = dict(pooling=request.param, dropout=0.0, batch_size=4, lr=LR,
                bn_momentum_decay_step=1)
    jc = jcfg.tiny_test().replace(remat=True, **over)
    tc = tcfg.tiny_test().replace(**over)
    batches = [_batch(tc, seed) for seed in range(3)]
    b0 = batches[0]
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0),
                           (b0["pc"], b0["sn"], b0["node"]),
                           steps_per_epoch=SPE)
    init = {k: np.array(v) for k, v in flatten(
        {"params": js.params, "batch_stats": js.batch_stats}).items()}
    j_train, _ = jloops.make_classify_steps(jm, jc, SPE)
    j_losses, j_grads = [], None
    for i, b in enumerate(batches):
        if i == 0:
            j_grads = _jax_grads(jm, js, b)
        js, m = j_train(js, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(1))
        j_losses.append(float(m["loss"]))
    j_final = {k: np.array(v) for k, v in flatten(
        {"params": js.params, "batch_stats": js.batch_stats}).items()}
    return dict(plain=_steps(tc, init, batches),
                remat=_steps(tc.replace(remat=True), init, batches),
                jax=(j_losses, j_grads, j_final))


def _jax_grads(jm, js, b):
    from sonet_tpu.train import losses as jlosses

    def loss_fn(p):
        (score, _), _ = jm.apply(
            {"params": p, "batch_stats": js.batch_stats}, b["pc"], b["sn"],
            b["node"], None, train=True, epoch=jnp.float32(0),
            mutable=["batch_stats"])
        return jlosses.cross_entropy(score, b["label"])
    g = jax.jit(jax.grad(loss_fn))(js.params)
    return {k: np.array(v) for k, v in flatten({"params": g}).items()}


def test_remat_step_equals_the_plain_step(remat_runs):
    (pl, pg, ps), (rl, rg, rs_) = remat_runs["plain"], remat_runs["remat"]
    assert rl == pl
    assert set(rg) == set(pg)
    for k in pg:
        np.testing.assert_array_equal(rg[k], pg[k], err_msg=k)
    assert set(rs_) == set(ps)
    for k in ps:                 # weights and running statistics
        assert torch.equal(rs_[k], ps[k]), k


def test_remat_step_matches_jax(remat_runs):
    (rl, rg, rs_), (jl_, jg, jf) = remat_runs["remat"], remat_runs["jax"]
    np.testing.assert_allclose(rl, jl_, rtol=1e-4)
    for k, want in jg.items():
        err = float(np.abs(rg[k] - want).max())
        tol = 1e-3 * float(np.abs(want).max()) + 1e-6
        assert err <= tol, (k, err, tol)
    model = build_model(tcfg.tiny_test(), device="cpu")
    model.load_state_dict(rs_)
    tf = to_jax_variables(model)
    for k in jf:
        if k.startswith("batch_stats/"):
            scale = max(1.0, float(np.abs(jf[k]).max()))
            assert np.abs(tf[k] - jf[k]).max() <= 1e-4 * scale, k


def test_remat_runs_the_stack_again_in_the_backward(monkeypatch):
    """The remat forward keeps the first PointNet out of the graph: its
    forward runs twice in a train step (once more in the backward), and
    once in eval, where nothing is kept anyway."""
    cfg = tcfg.tiny_test().replace(remat=True, dropout=0.0)
    model = build_model(cfg, device="cpu")
    calls = []
    fp = model.encoder.first_pointnet
    # a pre-hook: the recomputation stops once it has what the backward
    # needs (checkpoint's early stop), before the forward returns
    fp.register_forward_pre_hook(lambda *a: calls.append(tl.recomputing()))
    b = _batch(cfg, 0)
    x = [torch.from_numpy(b[k]) for k in ("pc", "sn", "node")]
    model.train()
    score, _ = model(*x, epoch=0)
    assert calls == [False]
    score.sum().backward()
    assert calls == [False, True]
    model.eval()
    with torch.no_grad():
        model(*x)
    assert calls == [False, True, False]


def test_batchnorm_leaves_its_statistics_in_a_recomputation():
    bn = tl.BatchNorm(5).train()
    x = torch.randn(40, 5) * 3 + 1
    with tl.recomputation():
        assert tl.recomputing()
        y_re = bn(x)
    assert not tl.recomputing()
    assert torch.equal(bn.running_mean, torch.zeros(5))
    assert torch.equal(bn.running_var, torch.ones(5))
    y = bn(x)
    assert torch.equal(y, y_re)                  # the same batch statistics
    assert not torch.equal(bn.running_mean, torch.zeros(5))
