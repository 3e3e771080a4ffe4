"""The port's part-segmentation family against the JAX package's, on the
CPU: ``permute_points``, ``gather_by_segment``, the IoU metric,
``ConcatDense`` with broadcast inputs, ``SegmenterHead`` /
``SegmenterModel``, the segment train and eval steps.

Inputs are made with numpy from a seed and fed to both sides; weights
cross by ``sonet_torch.convert``.  The JAX side runs at highest matmul
precision and its Pallas kernel in interpret mode (tests/conftest.py).

Tolerances, and why:
* float32 outputs: 1e-4 of the largest entry (the same arithmetic, summed
  in another order); bfloat16 outputs: 2e-2 of it (both sides round to
  bf16 after every layer, at slightly different points);
* gradients of the two gathers: float32 1e-6 relative (one gather, or one
  sum over a node's points in another order); bfloat16 one ulp, 2^-7
  relative (both sides sum in float32 and round once, and a sum taken in
  another order can land on the other side of a rounding boundary);
* train steps: as tests/test_torch_train.py states them for the
  classifier (losses 1e-4, first-step gradients 1e-3 of the tensor's
  largest entry plus 1e-6, parameters against lr, statistics 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu.nn import layers as jl
from sonet_tpu.ops import gather as jgather
from sonet_tpu.ops import iou as jiou
from sonet_tpu.train import losses as jlosses
from sonet_tpu.train import loops as jloops
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.convert import (flatten, gradients_to_jax,
                                 load_jax_variables, to_jax_variables)
from sonet_torch.models import SegmenterModel, build_model
from sonet_torch.nn import layers as tl
from sonet_torch.ops import gather as tgather
from sonet_torch.ops import iou as tiou
from sonet_torch.ops import one_hot

torch.set_num_threads(2)

RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
GATHER_GRAD_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
                   "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}
LR = 1e-5
STEPS = 3
SPE = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _tdt(name):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype):
    got = _np(got) if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * scale, (err, scale)


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, leaf = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


def _np_flat(tree):
    return {k: np.array(v) for k, v in flatten(tree).items()}


# ---------------------------------------------------------------------------
# permute_points
# ---------------------------------------------------------------------------

def _perm_case(seed, B=3, N=37, C=5):
    rs = np.random.RandomState(seed)
    perm = np.stack([rs.permutation(N) for _ in range(B)]).astype(np.int32)
    inv = np.argsort(perm, axis=1).astype(np.int32)
    x = rs.randn(B, N, C).astype(np.float32)
    g = rs.randn(B, N, C).astype(np.float32)
    return x, perm, inv, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_permute_points_forward_and_gradient_match_jax(dtype):
    x, perm, inv, g = _perm_case(0)
    jx = jnp.asarray(x, dtype)
    want = jgather.permute_points(jx, perm, inv)
    want_grad = jax.grad(lambda a: jnp.sum(jgather.permute_points(
        a, perm, inv).astype(jnp.float32) * g))(jx)
    tx = _t(x).to(_tdt(dtype)).requires_grad_()
    got = tgather.permute_points(tx, _t(perm), _t(inv))
    assert got.dtype == _tdt(dtype)
    (got.float() * _t(g)).sum().backward()
    # a permutation moves values and rounds nothing: exact on both sides
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(tx.grad),
                                  np.asarray(want_grad, np.float32))


def test_permute_points_backward_is_the_inverse_gather():
    """The gradient is the gather by ``inv`` -- what autograd's
    scatter-add gives for a bijection -- and round trips undo each other;
    the index arguments get no gradient."""
    x, perm, inv, g = _perm_case(1)
    tx = _t(x).requires_grad_()
    y = tgather.permute_points(tx, _t(perm), _t(inv))
    np.testing.assert_array_equal(
        _np(y), np.take_along_axis(x, perm[..., None], 1))
    y.backward(_t(g))
    np.testing.assert_array_equal(
        _np(tx.grad), np.take_along_axis(g, inv[..., None], 1))
    plain = _t(x).requires_grad_()
    torch.gather(plain, 1, _t(perm).long()[..., None].expand(-1, -1, 5)
                 ).backward(_t(g))
    np.testing.assert_array_equal(_np(tx.grad), _np(plain.grad))
    back = tgather.permute_points(y, _t(inv), _t(perm))
    np.testing.assert_array_equal(_np(back), x)
    assert y.grad_fn.next_functions[1][0] is None
    assert y.grad_fn.next_functions[2][0] is None


# ---------------------------------------------------------------------------
# gather_by_segment
# ---------------------------------------------------------------------------

def _gather_case(seed, B=2, N=400, M=8, C=12):
    """About 50 points a node, as at ShapeNetPart (3072 / 64)."""
    rs = np.random.RandomState(seed)
    ids = np.sort(rs.randint(0, M, (B, N)), axis=1).astype(np.int32)
    table = rs.randn(B, M, C).astype(np.float32)
    g = rs.randn(B, N, C).astype(np.float32)
    return table, ids, g


@pytest.mark.parametrize("with_onehot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_by_segment_matches_jax(dtype, with_onehot):
    table, ids, g = _gather_case(2)
    M = table.shape[1]
    joh = jax.nn.one_hot(ids, M, dtype=jnp.dtype(dtype)) if with_onehot else None
    toh = one_hot(_t(ids), M, _tdt(dtype)) if with_onehot else None
    # the table is float32 with a bf16 one-hot (final_pn_out), and in the
    # compute dtype without one
    jt = jnp.asarray(table, jnp.float32 if with_onehot else dtype)

    def jf(t):
        return jgather.gather_by_segment(t, ids, joh)

    want = jf(jt)
    want_grad = jax.grad(lambda t: jnp.sum(jf(t).astype(jnp.float32) * g))(jt)
    tt = _t(table).to(torch.float32 if with_onehot else _tdt(dtype))
    tt.requires_grad_()
    got = tgather.gather_by_segment(tt, _t(ids), toh)
    assert got.dtype == _tdt(dtype) and got.shape == (2, 400, 12)
    (got.float() * _t(g)).sum().backward()
    # one 1.0 a row: the one-hot product and the index gather are exact
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert tt.grad.dtype == tt.dtype
    want_grad = np.asarray(want_grad, np.float32)
    tol = GATHER_GRAD_TOL[dtype]
    if dtype == "bfloat16" and not with_onehot:
        # here the JAX side is the loose one: its take_along_axis
        # transposes into a bf16 scatter-add that rounds at each of a
        # node's ~50 adds (half an ulp, 2^-9, of the running sum each)
        tol = dict(rtol=0, atol=5e-2 * float(np.abs(want_grad).max()))
    np.testing.assert_allclose(_np(tt.grad), want_grad, **tol)


@pytest.mark.parametrize("with_onehot", [False, True])
def test_gather_by_segment_bf16_gradient_rounds_once(with_onehot):
    """A node's cotangent is the float32 sum over its ~50 points rounded
    to bf16 once (a scatter-add in bf16 would round at every add)."""
    table, ids, g = _gather_case(3)
    M = table.shape[1]
    g16 = _t(g).to(torch.bfloat16)
    toh = one_hot(_t(ids), M, torch.bfloat16) if with_onehot else None
    tt = _t(table).to(torch.bfloat16).requires_grad_()
    tgather.gather_by_segment(tt, _t(ids), toh).backward(g16)
    exact = np.zeros(table.shape, np.float64)
    for b in range(2):
        np.add.at(exact[b], ids[b], g16[b].double().numpy())
    once = _np(_t(exact).to(torch.bfloat16))
    got = _np(tt.grad)
    # float32 accumulation may cross a rounding boundary: at most one ulp
    np.testing.assert_allclose(got, once, rtol=2 ** -7, atol=1e-6)
    assert (got == once).mean() > 0.98


def test_gather_by_segment_float32_onehot_promotes_a_bf16_table():
    table, ids, _ = _gather_case(4)
    t16 = _t(table).to(torch.bfloat16)
    got = tgather.gather_by_segment(t16, _t(ids),
                                    one_hot(_t(ids), 8, torch.float32))
    want = jgather.gather_by_segment(
        jnp.asarray(table, jnp.bfloat16), ids,
        jax.nn.one_hot(ids, 8, dtype=jnp.float32))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def test_iou_tables_match_jax():
    assert tiou.PART_LABEL == jiou.PART_LABEL
    assert (tiou.MAX_PARTS, tiou.NUM_CATEGORIES, tiou.NUM_PARTS) == (
        jiou.MAX_PARTS, jiou.NUM_CATEGORIES, jiou.NUM_PARTS)
    np.testing.assert_array_equal(tiou.PART_TABLE, jiou.PART_TABLE)
    np.testing.assert_array_equal(tiou.PART_VALID, jiou.PART_VALID)
    # numpy at import: no tensor is made before a call
    assert isinstance(tiou.PART_TABLE, np.ndarray)


@pytest.mark.parametrize("category", range(16))
def test_iou_per_shape_matches_jax_for_every_category(category):
    rs = np.random.RandomState(category)
    parts = np.asarray(tiou.PART_LABEL[category])
    N = 200
    # shape 0: random parts of the category; shape 1: the last part absent
    # from both prediction and truth (an empty union, IoU 1.0); shape 2:
    # predictions from other categories too
    gt = parts[rs.randint(0, len(parts), (3, N))]
    pred = parts[rs.randint(0, len(parts), (3, N))]
    gt[1] = parts[rs.randint(0, len(parts) - 1, N)]
    pred[1] = parts[rs.randint(0, len(parts) - 1, N)]
    pred[2] = rs.randint(0, 50, N)
    label = np.full(3, category, np.int32)
    want = np.asarray(jiou.iou_per_shape(jnp.asarray(pred), jnp.asarray(gt),
                                         jnp.asarray(label)))
    got = tiou.iou_per_shape(_t(pred), _t(gt), _t(label))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # by hand: intersection over union + 1e-4, an empty union counts 1.0
    for b in range(3):
        ious = []
        for p in parts:
            union = ((gt[b] == p) | (pred[b] == p)).sum()
            inter = ((gt[b] == p) & (pred[b] == p)).sum()
            ious.append(1.0 if union == 0 else inter / (union + 1e-4))
        assert abs(float(got[b]) - np.mean(ious)) < 1e-6
    absent = parts[-1]
    assert not ((gt[1] == absent) | (pred[1] == absent)).any()


def test_compute_iou_matches_jax():
    rs = np.random.RandomState(20)
    score = rs.randn(6, 50, 50).astype(np.float32)
    label = rs.randint(0, 16, 6).astype(np.int32)
    gt = rs.randint(0, 50, (6, 50)).astype(np.int32)
    want = float(jiou.compute_iou(jnp.asarray(score), jnp.asarray(gt),
                                  jnp.asarray(label)))
    got = float(tiou.compute_iou(_t(score), _t(gt), _t(label)))
    assert abs(got - want) < 1e-6


# ---------------------------------------------------------------------------
# ConcatDense with inputs broadcast along the points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_concat_dense_with_rank2_parts_matches_jax(dtype):
    rs = np.random.RandomState(5)
    B, N = 3, 11
    xs = [rs.randn(B, N, 4), rs.randn(B, 6), rs.randn(B, N, 5),
          rs.randn(B, 7)]
    xs = [x.astype(np.float32) for x in xs]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jmod = jl.ConcatDense(9, compute_dtype=jdt)
    variables = jmod.init(jax.random.PRNGKey(0), *xs)
    flat = _np_flat(variables)
    flat["params/bias"] = rs.randn(9).astype(np.float32)
    want = jmod.apply(_unflatten(flat), *xs)
    tmod = tl.ConcatDense([4, 6, 5, 7], 9, torch.Generator().manual_seed(0),
                          compute_dtype=tdt)
    with torch.no_grad():
        tmod.weight.copy_(_t(flat["params/kernel"].T))
        tmod.bias.copy_(_t(flat["params/bias"]))
    got = tmod(*(_t(x) for x in xs))
    assert got.shape == (B, N, 9) and got.dtype == _tdt(dtype)
    _close(got, want, dtype)
    # the same as a dense layer over the materialised concatenation
    full = np.concatenate(
        [x if x.ndim == 3 else np.repeat(x[:, None], N, 1) for x in xs], -1)
    ref = full @ flat["params/kernel"] + flat["params/bias"]
    _close(got, ref, dtype)


def test_concat_dense_rank2_gradient_sums_over_points():
    rs = np.random.RandomState(6)
    x3 = _t(rs.randn(2, 9, 4).astype(np.float32))
    x2 = _t(rs.randn(2, 3).astype(np.float32)).requires_grad_()
    mod = tl.ConcatDense([4, 3], 5, torch.Generator().manual_seed(0))
    g = _t(rs.randn(2, 9, 5).astype(np.float32))
    mod(x3, x2).backward(g)
    want = g.sum(1) @ mod.weight.detach()[:, 4:]
    torch.testing.assert_close(x2.grad, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# SegmenterHead / SegmenterModel
# ---------------------------------------------------------------------------

_SEG = dict(task="segment", classes=50)
_CASES = {
    # 64 points, 16 nodes, k=2, som_k=4, F=64
    "tiny": ("tiny_test", dict(_SEG)),
    # no kNN layer and no normals: 3 D + 16 + 384 + 384 + F + F rows
    "tiny_som_k0_no_sn": ("tiny_test", dict(_SEG, som_k=0,
                                            surface_normal=False)),
    # config.shapenetpart() at every width (M=64, k=3, som_k=9 "center",
    # F=1024, layer1 over 3356 channels), 256 of its 1024 points
    "shapenetpart": ("shapenetpart", dict(input_pc_num=256)),
}


def _inputs(cfg, seed, B=2):
    rs = np.random.RandomState(seed)
    N, M = cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    sn = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    # one far node: guaranteed empty
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    label = rs.randint(0, 16, B).astype(np.int32)
    return pc, sn, node, label


def _perturb_stats(variables, rs):
    flat = _np_flat(variables)
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            if k.endswith("/mean"):
                flat[k] = (0.2 * rs.randn(*v.shape)).astype(np.float32)
            else:
                flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return flat


_pair_cache = {}


def _run_pair(case, dtype, pooling):
    key = (case, dtype, pooling)
    if key in _pair_cache:
        return _pair_cache[key]
    preset, over = _CASES[case]
    over = dict(over, compute_dtype=dtype, pooling=pooling, batch_size=2)
    jc = getattr(jcfg, preset)().replace(**over)
    tc = getattr(tcfg, preset)().replace(**over)
    pc, sn, node, label = _inputs(jc, seed=7)
    jsn = sn if jc.surface_normal else None
    jm = jmodels.build_model(jc)
    variables = jm.init(jax.random.PRNGKey(0), pc, jsn, node, label)
    flat = _perturb_stats(variables, np.random.RandomState(8))
    jscore, jenc = jm.apply(_unflatten(flat), pc, jsn, node, label,
                            train=False)
    model = build_model(tc, device="cpu")
    assert isinstance(model, SegmenterModel)
    load_jax_variables(model, flat)
    with torch.no_grad():
        score, enc = model(_t(pc), _t(sn) if tc.surface_normal else None,
                           _t(node), _t(label))
    out = (tc, flat, score, enc, np.asarray(jscore), jenc)
    _pair_cache[key] = out
    return out


@pytest.mark.parametrize("pooling", ["scatter", "sorted_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_segmenter_scores_match_jax(case, dtype, pooling):
    tc, _, score, _, jscore, _ = _run_pair(case, dtype, pooling)
    assert score.shape == (2, tc.input_pc_num, 50) == jscore.shape
    assert score.dtype == torch.float32 and jscore.dtype == np.float32
    _close(score, jscore, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["tiny", "shapenetpart"])
def test_segmenter_head_alone_matches_jax(case, dtype):
    """The head on the JAX encoder's own output, so that nothing of the
    port's encoder stands between the two heads."""
    from sonet_tpu.nn.heads import SegmenterHead as JHead
    from sonet_torch.nn.encoder import EncoderOutput
    tc, flat, _, _, jscore, jenc = _run_pair(case, dtype, "sorted_window")
    label = _inputs(tc, seed=7)[3]

    def to_torch(a):
        if a is None:
            return None
        t = _t(np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                          else a))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    enc = EncoderOutput(**{k: to_torch(v) for k, v in jenc._asdict().items()})
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    with torch.no_grad():
        score = model.segmenter(enc, _t(label))
    jc = getattr(jcfg, _CASES[case][0])().replace(
        **dict(_CASES[case][1], compute_dtype=dtype, pooling="sorted_window",
               batch_size=2))
    sub = {"params": _unflatten(flat)["params"]["segmenter"],
           "batch_stats": _unflatten(flat)["batch_stats"]["segmenter"]}
    want = JHead(jc).apply(sub, jenc, label, train=False)
    np.testing.assert_array_equal(np.asarray(want), jscore)
    _close(score, want, dtype)


def test_segmenter_layer1_kernel_rows_follow_the_part_list():
    tc, flat, *_ = _run_pair("shapenetpart", "float32", "sorted_window")
    k = "params/segmenter/layer1/Dense_0/kernel"
    assert flat[k].shape == (3 + 3 + 3 + 3 + 16 + 384 + 384 + 512
                             + 1024 + 1024, 1024)
    assert flat[k].shape[0] == 3356
    model = build_model(tc, device="cpu")
    assert model.segmenter.layer1.Dense_0.splits == (
        3, 3, 3, 3, 16, 384, 384, 512, 1024, 1024)
    small = build_model(getattr(tcfg, "tiny_test")().replace(
        **_CASES["tiny_som_k0_no_sn"][1]), device="cpu")
    assert small.segmenter.layer1.Dense_0.splits == (3, 3, 3, 16, 384, 384,
                                                     64, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_encoder_outputs_are_node_sorted_and_inv_perm_maps_back(dtype):
    """Every per-point field of the sorted pipeline is the scatter
    pipeline's field in node-sorted order: ``sorted = original[perm]`` and
    ``original[j] = sorted[inv_perm[j]]``."""
    _, _, _, plain, _, _ = _run_pair("tiny", dtype, "scatter")
    _, _, _, enc, _, jenc = _run_pair("tiny", dtype, "sorted_window")
    assert plain.perm is None and plain.inv_perm is None
    perm, inv = enc.perm.long(), enc.inv_perm.long()
    B, kN = perm.shape
    ar = torch.arange(kN).expand(B, kN)
    assert torch.equal(torch.gather(perm, 1, inv), ar)
    assert torch.equal(torch.gather(inv, 1, perm), ar)
    assert bool((enc.min_idx[:, 1:] >= enc.min_idx[:, :-1]).all())
    np.testing.assert_array_equal(enc.perm.numpy(), np.asarray(jenc.perm))
    np.testing.assert_array_equal(enc.inv_perm.numpy(),
                                  np.asarray(jenc.inv_perm))

    def take(x, idx):
        idx = idx if x.dim() == 2 else idx[..., None].expand(-1, -1,
                                                             x.shape[2])
        return torch.gather(x, 1, idx)

    # moved, not recomputed: exact
    for name in ("min_idx", "x_stack", "sn_stack", "onehot"):
        a, b = getattr(plain, name), getattr(enc, name)
        assert torch.equal(take(a, perm), b), name
        assert torch.equal(take(b, inv), a), name
    # computed after the sort, from sums taken in another point order
    for name in ("centers", "x_decentered", "first_pn_out"):
        a, b = getattr(plain, name), getattr(enc, name)
        _close(take(b, inv), _np(a), dtype)
        _close(b, _np(take(a, perm)), dtype)
    assert enc.onehot.shape == (B, kN, 16) and enc.onehot.dtype == _tdt(dtype)
    assert torch.equal(enc.onehot.argmax(-1).int(), enc.min_idx)
    np.testing.assert_array_equal(_np(enc.onehot),
                                  np.asarray(jenc.onehot, np.float32))


def test_segmenter_scores_follow_the_points_not_the_sort():
    """Permuting the input points permutes the scores the same way, on the
    sorted pipeline: a wrong un-permute would give each point another
    point's scores."""
    tc = tcfg.tiny_test().replace(**_SEG, pooling="sorted_window",
                                  batch_size=2)
    pc, sn, _, label = _inputs(tc, seed=11)
    # a node beside each of 16 points: no node is empty (an empty node
    # takes the first point's feature, which does depend on the order)
    node = pc[:, :tc.node_num] + 0.01
    model = build_model(tc, device="cpu", seed=3)
    shuffle = np.random.RandomState(12).permutation(tc.input_pc_num)
    with torch.no_grad():
        a, enc = model(_t(pc), _t(sn), _t(node), _t(label))
        b, _ = model(_t(pc[:, shuffle]), _t(sn[:, shuffle]), _t(node),
                     _t(label))
    assert bool(enc.mask_row_max.all())
    torch.testing.assert_close(b, a[:, shuffle], rtol=1e-4, atol=1e-4)
    assert float((b - a).abs().max()) > 1e-2


def test_segmenter_dropout_only_in_training():
    tc = tcfg.tiny_test().replace(**_SEG, dropout=0.6, batch_size=2)
    pc, sn, node, label = (_t(a) for a in _inputs(tc, seed=13))
    model = build_model(tc, device="cpu", seed=0)
    with torch.no_grad():
        e1, _ = model(pc, sn, node, label)
        e2, _ = model(pc, sn, node, label)
        model.train()
        t1, _ = model(pc, sn, node, label, epoch=0,
                      generator=torch.Generator().manual_seed(0))
        t2, _ = model(pc, sn, node, label, epoch=0,
                      generator=torch.Generator().manual_seed(0))
        t3, _ = model(pc, sn, node, label, epoch=0,
                      generator=torch.Generator().manual_seed(1))
        model.segmenter.rate = 0.1            # at or below 0.1: no dropout
        t4, _ = model(pc, sn, node, label, epoch=0,
                      generator=torch.Generator().manual_seed(0))
        t5, _ = model(pc, sn, node, label, epoch=0,
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.equal(t1, t3)
    assert torch.equal(t4, t5)


@pytest.mark.parametrize("n_rows", [8192, 8191])
def test_batchnorm_variance_branch_at_8192_rows_matches_jax(n_rows):
    """The segmenter's layer4 normalises over exactly B * N = 8192 rows at
    ShapeNetPart: the one-pass variance E[x^2] - E[x]^2 (``n < 8192`` is
    false) on both sides; 8191 rows take the two-pass form.  Each side is
    held, bit for bit, to its own form written out with its own
    operations, and the two sides to each other."""
    rs = np.random.RandomState(n_rows)
    C = 4
    x = (0.5 * rs.randn(8, n_rows // 8 + 1, C) + 3.0).astype(np.float32)
    x = x.reshape(-1, C)[:n_rows].reshape(1, n_rows, C)
    want, _ = jl.BatchNorm().apply(
        {"params": {"scale": np.ones(C, np.float32),
                    "bias": np.zeros(C, np.float32)},
         "batch_stats": {"mean": np.zeros(C, np.float32),
                         "var": np.ones(C, np.float32)}},
        x, use_running_average=False, mutable=["batch_stats"])
    got = tl.BatchNorm(C).train()(_t(x))

    jx = jnp.asarray(x)
    jmean = jnp.mean(jx, (0, 1))
    jforms = {"one": jnp.mean(jnp.square(jx), (0, 1)) - jnp.square(jmean),
              "two": jnp.mean(jnp.square(jx - jmean), (0, 1))}
    tx = _t(x)
    tmean = tx.mean((0, 1))
    tforms = {"one": tx.square().mean((0, 1)) - tmean.square(),
              "two": (tx - tmean).square().mean((0, 1))}
    taken, other = ("one", "two") if n_rows >= 8192 else ("two", "one")

    def jnorm(var):
        return np.asarray((jx - jmean) * jax.lax.rsqrt(var + 1e-5))

    def tnorm(var):
        return _np((tx - tmean) * torch.rsqrt(var + 1e-5))

    np.testing.assert_array_equal(np.asarray(want), jnorm(jforms[taken]))
    np.testing.assert_array_equal(_np(got), tnorm(tforms[taken]))
    assert not np.array_equal(np.asarray(want), jnorm(jforms[other]))
    assert not np.array_equal(_np(got), tnorm(tforms[other]))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# convert: the segmenter's keys
# ---------------------------------------------------------------------------

def test_convert_roundtrips_a_segmenter_strictly():
    tc, flat, *_ = _run_pair("tiny", "float32", "scatter")
    model = build_model(tc, device="cpu", seed=1)
    load_jax_variables(model, flat)
    back = to_jax_variables(model)
    assert set(back) == set(flat) and len(flat) == len(model.state_dict())
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert "params/segmenter/layer1/Dense_0/kernel" in back
    assert "params/segmenter/layer1/BatchNorm_0/scale" in back
    assert "batch_stats/segmenter/layer4/BatchNorm_0/var" in back
    assert "params/segmenter/layer5/Dense_0/bias" in back
    assert not any("layer5/BatchNorm" in k for k in back)
    missing = dict(flat)
    missing.pop("params/segmenter/layer3/Dense_0/kernel")
    with pytest.raises(KeyError, match="not set"):
        load_jax_variables(model, missing)
    with pytest.raises(KeyError, match="no place"):
        load_jax_variables(model, dict(flat, **{
            "params/classifier/fc1/Dense_0/kernel": np.zeros((1, 1))}))


def test_head_group_takes_every_parameter_outside_the_encoder():
    tc = tcfg.tiny_test().replace(**_SEG)
    model = build_model(tc, device="cpu")
    opt, _ = ttrain.make_optimizer(model, tc, steps_per_epoch=4)
    groups = {g["name"]: g["params"] for g in opt.param_groups}
    assert list(groups) == ["encoder", "head"]
    head = {id(p) for p in groups["head"]}
    assert head == {id(p) for p in model.segmenter.parameters()}
    assert len(head) == 2 * 5 + 2 * 4        # 5 dense layers, 4 BatchNorms
    assert {id(p) for p in groups["encoder"]} == {
        id(p) for p in model.encoder.parameters()}


# ---------------------------------------------------------------------------
# three segment train steps against the JAX package
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    pc, sn, node, label = _inputs(cfg, seed, B=cfg.batch_size)
    rs = np.random.RandomState(100 + seed)
    seg = rs.randint(0, cfg.classes,
                     (cfg.batch_size, cfg.input_pc_num)).astype(np.int32)
    return {"pc": pc, "sn": sn, "node": node, "label": label, "seg": seg}


@pytest.fixture(scope="module", params=["scatter", "sorted_window"])
def trajectories(request):
    over = dict(_SEG, pooling=request.param, dropout=0.0, batch_size=4,
                lr=LR, bn_momentum_decay_step=1)
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    batches = [_batch(jc, seed) for seed in range(STEPS)]
    b0 = batches[0]
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0),
                           (b0["pc"], b0["sn"], b0["node"], b0["label"]),
                           steps_per_epoch=SPE)
    init = _np_flat({"params": js.params, "batch_stats": js.batch_stats})

    @jax.jit
    def jax_grads(params, batch_stats, b):
        def loss_fn(p):
            (score, _), _ = jm.apply(
                {"params": p, "batch_stats": batch_stats}, b["pc"], b["sn"],
                b["node"], b["label"], None, train=True,
                epoch=jnp.float32(0), mutable=["batch_stats"])
            return jlosses.cross_entropy_seg(score, b["seg"])
        return jax.grad(loss_fn)(params)

    j_grads = _np_flat({"params": jax_grads(js.params, js.batch_stats, b0)})

    model = build_model(tc, device="cpu")
    load_jax_variables(model, init)
    ts = ttrain.init_state(tc, device="cpu", model=model,
                           steps_per_epoch=SPE)
    j_train, j_eval = jloops.make_steps(jm, jc, SPE)
    t_train, t_eval = ttrain.make_steps(tc, SPE)
    j_losses, t_losses, j_acc, t_acc = [], [], [], []
    t_grads = None
    for i, b in enumerate(batches):
        js, jmet = j_train(js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(1))
        ts, tmet = t_train(ts, {k: _t(v) for k, v in b.items()},
                           torch.Generator().manual_seed(1))
        j_losses.append(float(jmet["loss"]))
        t_losses.append(float(tmet["loss"]))
        j_acc.append(float(jmet["seg_accuracy"]))
        t_acc.append(float(tmet["seg_accuracy"]))
        if i == 0:
            t_grads = gradients_to_jax(ts.model)
    j_ev = jax.tree.map(np.asarray, j_eval(
        js, {k: jnp.asarray(v) for k, v in b0.items()}))
    t_ev = t_eval(ts, {k: _t(v) for k, v in b0.items()})
    return dict(
        init=init, j_losses=j_losses, t_losses=t_losses, j_acc=j_acc,
        t_acc=t_acc, j_grads=j_grads, t_grads=t_grads,
        j_final=_np_flat({"params": js.params,
                          "batch_stats": js.batch_stats}),
        t_final=to_jax_variables(ts.model), t_step=ts.step, batch=b0,
        j_eval=j_ev, t_eval={k: v.numpy() for k, v in t_ev.items()})


def test_segment_train_losses_match_jax(trajectories):
    r = trajectories
    assert r["t_step"] == STEPS
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], rtol=1e-4)
    # 256 points a batch: one flipped argmax is 1/256
    np.testing.assert_allclose(r["t_acc"], r["j_acc"], atol=1.01 / 256)


def test_segment_first_step_gradients_match_jax(trajectories):
    jg, tg = trajectories["j_grads"], trajectories["t_grads"]
    assert set(tg) == set(jg)
    for k, want in jg.items():
        err = float(np.abs(tg[k] - want).max())
        tol = 1e-3 * float(np.abs(want).max()) + 1e-6
        assert err <= tol, (k, err, tol)
    # the head's skips carry real gradients into the encoder: through the
    # per-point features, the gathered node maps and the global feature
    for k in ("params/encoder/first_pointnet/PointLayer_0/Dense_0/kernel",
              "params/encoder/knnlayer/PointLayer_1/Dense_0/kernel",
              "params/encoder/final_pointnet/PointLayer_1/Dense_0/kernel",
              "params/segmenter/layer1/Dense_0/kernel"):
        assert np.abs(tg[k]).max() > 1e-4, k


def test_segment_params_and_batch_stats_after_three_steps(trajectories):
    jf, tf = trajectories["j_final"], trajectories["t_final"]
    assert set(tf) == set(jf)
    diffs = np.concatenate([np.abs(tf[k] - jf[k]).ravel()
                            for k in jf if k.startswith("params/")])
    assert (diffs > 0.1 * LR).mean() <= 2e-3, (diffs > 0.1 * LR).mean()
    for k in jf:
        if k.startswith("batch_stats/"):
            scale = max(1.0, float(np.abs(jf[k]).max()))
            assert np.abs(tf[k] - jf[k]).max() <= 1e-4 * scale, k


def test_segment_stopped_biases_never_move(trajectories):
    init, jf, tf = (trajectories["init"], trajectories["j_final"],
                    trajectories["t_final"])
    stopped = {k.replace("/BatchNorm_0/scale", "/Dense_0/bias")
               for k in init if k.endswith("/BatchNorm_0/scale")}
    assert len(stopped) == 6 + 4          # the encoder's 6, layers 1-4
    for k in init:
        if not k.startswith("params/"):
            continue
        if k in stopped:
            np.testing.assert_array_equal(tf[k], init[k])
            np.testing.assert_array_equal(jf[k], init[k])
        else:
            assert not np.array_equal(tf[k], init[k]), k


def test_segment_eval_step_matches_jax(trajectories):
    je, te = trajectories["j_eval"], trajectories["t_eval"]
    assert set(te) == set(je) == {"loss", "seg_accuracy", "iou", "loss_i",
                                  "correct_i", "iou_i", "score"}
    assert te["score"].shape == (4, 64, 50)
    scale = max(1.0, float(np.abs(je["score"]).max()))
    assert np.abs(te["score"] - je["score"]).max() <= 1e-4 * scale
    for k in ("loss_i", "loss"):
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=2e-4 * scale)
    for k in ("loss_i", "correct_i", "iou_i"):
        assert te[k].shape == (4,)
    # per-item shares of 64 points, and IoUs of at most 6 parts: a flipped
    # argmax moves them by 1/64 and by about that; none flips here
    for k in ("correct_i", "seg_accuracy", "iou_i", "iou"):
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=1e-6)
    # the per-item metrics are the batch metrics' parts
    assert abs(float(te["loss"]) - te["loss_i"].mean()) < 1e-6
    assert abs(float(te["seg_accuracy"]) - te["correct_i"].mean()) < 1e-6
    assert abs(float(te["iou"]) - te["iou_i"].mean()) < 1e-6
    b = trajectories["batch"]
    pred = te["score"].argmax(-1)
    np.testing.assert_allclose(te["correct_i"], (pred == b["seg"]).mean(-1),
                               atol=1e-6)


def test_segment_losses_match_jax():
    rs = np.random.RandomState(30)
    score = rs.randn(3, 17, 50).astype(np.float32)
    seg = rs.randint(0, 50, (3, 17)).astype(np.int32)
    np.testing.assert_allclose(
        float(ttrain.losses.cross_entropy_seg(_t(score), _t(seg))),
        float(jlosses.cross_entropy_seg(jnp.asarray(score), jnp.asarray(seg))),
        rtol=1e-6)
    seg[0] = score[0].argmax(-1)
    assert float(ttrain.losses.seg_accuracy(_t(score), _t(seg))) == float(
        jlosses.seg_accuracy(jnp.asarray(score), jnp.asarray(seg)))


def test_make_steps_dispatches_by_task():
    with pytest.raises(NotImplementedError, match="autoencode"):
        ttrain.make_steps(tcfg.autoencoder(), 10)
    for preset in ("modelnet40", "shrec16", "shapenetpart"):
        step, ev = ttrain.make_steps(getattr(tcfg, preset)(), 10)
        assert callable(step) and callable(ev)
