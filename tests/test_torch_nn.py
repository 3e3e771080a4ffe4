"""The PyTorch port's layers, encoder and classifier against the JAX
package's, on the CPU, with weights carried across by
``sonet_torch.convert``.

BatchNorm statistics are replaced by random means and variances so that
eval-mode normalisation is exercised.  The JAX side runs at highest
matmul precision (tests/conftest.py), the port in float32 on the CPU.

Tolerances, relative to the largest magnitude of the reference output:
* float32: 1e-4 -- the same arithmetic, summed in another order;
* bfloat16: 2e-2 -- both sides round to bf16 (8 mantissa bits, one ulp is
  0.4-0.8%) after every layer, but XLA and PyTorch round their matmul
  outputs and bias adds at slightly different points, so a few ulp of
  difference build up through the ~12 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu.models import build_model as j_build_model
from sonet_tpu.nn import layers as jl
from sonet_torch import config as tcfg
from sonet_torch.convert import (flatten, load_jax_variables,
                                 to_jax_variables)
from sonet_torch.models import build_model
from sonet_torch.nn import layers as tl

torch.set_num_threads(2)

RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _close(got, want, dtype):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * scale, (err, scale)


def _perturb_stats(variables, rs):
    """Flattened variables with random BatchNorm means and variances."""
    flat = flatten(variables)
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            if k.endswith("/mean"):
                flat[k] = (0.2 * rs.randn(*v.shape)).astype(np.float32)
            else:
                flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return flat


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *path, leaf = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


def _dt(name):
    return (jnp.bfloat16, torch.bfloat16) if name == "bfloat16" else (None,
                                                                       None)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_pair(jmod, tmod, *inputs, seed=0):
    rs = np.random.RandomState(seed)
    variables = jmod.init(jax.random.PRNGKey(seed), *inputs)
    flat = _perturb_stats(variables, rs)
    load_jax_variables(tmod, flat)
    want = jmod.apply(_unflatten(flat), *inputs)
    got = tmod(*(torch.from_numpy(np.asarray(x)) for x in inputs))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm,act", [("batch", "relu"), (None, "elu"),
                                      (None, None)])
def test_point_layer(dtype, norm, act):
    jdt, tdt = _dt(dtype)
    x = np.random.RandomState(1).randn(2, 30, 12).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    got, want = _layer_pair(
        jl.PointLayer(20, activation=act, normalization=norm,
                      compute_dtype=jdt),
        tl.PointLayer(12, 20, gen, activation=act, normalization=norm,
                      compute_dtype=tdt).eval(), x)
    assert str(got.dtype).endswith(dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_resnet_concat_dense(dtype):
    jdt, tdt = _dt(dtype)
    x = np.random.RandomState(2).randn(2, 40, 6).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    got, want = _layer_pair(
        jl.PointResNet((16, 24, 32, 48), compute_dtype=jdt),
        tl.PointResNet(6, (16, 24, 32, 48), gen, compute_dtype=tdt).eval(),
        x)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_net_mlp(dtype):
    jdt, tdt = _dt(dtype)
    x = np.random.RandomState(3).randn(2, 9, 10).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    got, want = _layer_pair(
        jl.PointNetMLP((32, 16), compute_dtype=jdt),
        tl.PointNetMLP(10, (32, 16), gen, compute_dtype=tdt).eval(), x)
    _close(got, want, dtype)


@pytest.mark.parametrize("center_type", ["avg", "center"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_module(dtype, center_type):
    jdt, tdt = _dt(dtype)
    rs = np.random.RandomState(4)
    coord = rs.randn(2, 16, 3).astype(np.float32)
    feat = rs.randn(2, 16, 24).astype(np.float32)
    if jdt is not None:
        feat = np.asarray(jnp.asarray(feat, jdt))     # bf16 pooled features
    idx = rs.randint(0, 16, (2, 16, 4)).astype(np.int32)
    jmod = jl.KNNModule((32, 32), compute_dtype=jdt)
    variables = jmod.init(jax.random.PRNGKey(0), coord, feat, idx,
                          center_type)
    flat = _perturb_stats(variables, rs)
    tmod = tl.KNNModule(3, 24, (32, 32), torch.Generator().manual_seed(0),
                        compute_dtype=tdt).eval()
    load_jax_variables(tmod, flat)
    wc, wf = jmod.apply(_unflatten(flat), coord, feat, idx, center_type)
    tfeat = torch.from_numpy(np.asarray(feat, np.float32))
    if tdt is not None:
        tfeat = tfeat.to(tdt)
    gc, gf = tmod(torch.from_numpy(coord), tfeat, torch.from_numpy(idx),
                  center_type)
    _close(gc, wc, "float32")
    _close(gf, wf, dtype)


def test_batchnorm_eval_matches_formula():
    bn = tl.BatchNorm(5).eval()
    rs = np.random.RandomState(5)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rs.randn(5).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rs.uniform(0.5, 2, 5).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(rs.randn(5).astype(np.float32)))
    x = torch.from_numpy(rs.randn(3, 5).astype(np.float32)).to(torch.bfloat16)
    y = bn(x)
    assert y.dtype == torch.bfloat16
    ref = ((x.float() - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5)
           * bn.weight + bn.bias).to(torch.bfloat16)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    # train mode normalises with the batch's own (biased) statistics
    xf = x.float()
    mean, var = xf.mean(0), xf.var(0, unbiased=False)
    ref_train = (((xf - mean) / torch.sqrt(var + 1e-5)) * bn.weight
                 + bn.bias).to(torch.bfloat16)
    torch.testing.assert_close(bn.train()(x), ref_train, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# encoder and classifier
# ---------------------------------------------------------------------------

_CASES = {
    # tiny_test: 64 points, 16 nodes, k=2, som_k=4, F=64
    "tiny": ("tiny_test", {}),
    # modelnet40 widths (M=64, k=3, som_k=9, F=1024, 40 classes), 300 points
    "modelnet40": ("modelnet40", {"input_pc_num": 300}),
    # som_k < 2: the final PointResNet branch (shrec16-style)
    "tiny_som_k0": ("tiny_test", {"som_k": 0}),
}


def _inputs(cfg, seed):
    rs = np.random.RandomState(seed)
    B, N, M = 2, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    sn = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    # one far node: guaranteed empty, exercising the empty-node patch
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    return pc, sn, node


_jax_cache = {}


def _run_pair(case, dtype, pooling):
    preset, over = _CASES[case]
    over = dict(over, compute_dtype=dtype, pooling=pooling, batch_size=2)
    jc = getattr(jcfg, preset)().replace(**over)
    tc = getattr(tcfg, preset)().replace(**over)
    pc, sn, node = _inputs(jc, seed=7)
    key = (case, dtype, pooling)
    if key not in _jax_cache:
        jm = j_build_model(jc)
        variables = jm.init(jax.random.PRNGKey(0), pc, sn, node)
        flat = _perturb_stats(variables, np.random.RandomState(8))
        score, enc = jm.apply(_unflatten(flat), pc, sn, node, train=False)
        _jax_cache[key] = flat, np.asarray(score), jax.tree.map(
            lambda a: None if a is None else np.asarray(a), enc._asdict())
    flat, jscore, jenc = _jax_cache[key]
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    with torch.no_grad():
        score, enc = model(*(torch.from_numpy(a) for a in (pc, sn, node)))
    return (score, enc), (jscore, jenc)


@pytest.mark.parametrize("pooling", ["scatter", "sorted_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_CASES))
def test_classifier_logits_match_jax(case, dtype, pooling):
    (score, _), (jscore, _) = _run_pair(case, dtype, pooling)
    assert score.shape == jscore.shape and score.dtype == torch.float32
    _close(score, jscore, dtype)


@pytest.mark.parametrize("pooling", ["scatter", "sorted_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["tiny", "modelnet40"])
def test_encoder_outputs_match_jax(case, dtype, pooling):
    (_, enc), (_, jenc) = _run_pair(case, dtype, pooling)
    np.testing.assert_array_equal(enc.min_idx.numpy(), jenc["min_idx"])
    np.testing.assert_array_equal(enc.mask_row_max.numpy(),
                                  jenc["mask_row_max"])
    assert not enc.mask_row_max.numpy()[:, -1].any()    # the far node
    if pooling == "sorted_window":
        np.testing.assert_array_equal(enc.perm.numpy(), jenc["perm"])
        np.testing.assert_array_equal(enc.inv_perm.numpy(), jenc["inv_perm"])
    else:
        assert enc.perm is None and jenc["perm"] is None
    _close(enc.som_node, jenc["som_node"], "float32")
    for name in ("first_pn_out_masked_max", "feature", "knn_feature"):
        _close(getattr(enc, name), jenc[name], dtype)


def test_sorted_and_scatter_pooling_agree_exactly():
    (s1, e1), _ = _run_pair("tiny", "float32", "scatter")
    (s2, e2), _ = _run_pair("tiny", "float32", "sorted_window")
    torch.testing.assert_close(e1.first_pn_out_masked_max,
                               e2.first_pn_out_masked_max, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=1e-6)


def test_precomputed_node_knn_matches_on_device_knn():
    cfg = tcfg.tiny_test().replace(batch_size=2)
    pc, sn, node = (torch.from_numpy(a) for a in _inputs(cfg, seed=9))
    model = build_model(cfg, device="cpu", seed=3)
    from sonet_torch.ops import knn
    knn_I = knn(node, cfg.som_k + 2)            # wider than som_k: sliced
    with torch.no_grad():
        a, _ = model(pc, sn, node)
        b, _ = model(pc, sn, node, knn_I)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------------

def test_convert_roundtrip_and_strictness():
    cfg = tcfg.tiny_test()
    model = build_model(cfg, device="cpu", seed=1)
    flat = to_jax_variables(model)
    assert flat["params/encoder/first_pointnet/PointLayer_3/Dense_0/kernel"
                ].shape == (64 + 256, 384)
    other = build_model(cfg, device="cpu", seed=2)
    load_jax_variables(other, flat)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="no place"):
        load_jax_variables(other, dict(flat, **{
            "params/encoder/extra/Dense_0/kernel": np.zeros((1, 1))}))
    missing = dict(flat)
    missing.pop("batch_stats/classifier/fc1/BatchNorm_0/var")
    with pytest.raises(KeyError, match="not set"):
        load_jax_variables(other, missing)
    bad = dict(flat)
    bad["params/classifier/fc3/Dense_0/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(other, bad)


def test_convert_covers_every_jax_variable():
    jc = jcfg.modelnet40().replace(input_pc_num=100)
    pc, sn, node = _inputs(jc, seed=1)
    variables = j_build_model(jc).init(jax.random.PRNGKey(0), pc, sn, node)
    flat = flatten(variables)
    model = build_model(tcfg.modelnet40(), device="cpu")
    load_jax_variables(model, flat)
    assert set(to_jax_variables(model)) == set(flat)
    assert len(flat) == len(model.state_dict())


def test_seeded_init_is_reproducible_and_he_scaled():
    cfg = tcfg.tiny_test()
    a = build_model(cfg, device="cpu", seed=5).state_dict()
    b = build_model(cfg, device="cpu", seed=5).state_dict()
    c = build_model(cfg, device="cpu", seed=6).state_dict()
    w = "encoder.knnlayer.PointLayer_0.Dense_0.weight"
    torch.testing.assert_close(a[w], b[w], rtol=0, atol=0)
    assert not torch.equal(a[w], c[w])
    big = build_model(tcfg.modelnet40(), device="cpu", seed=0).state_dict()
    k = big["encoder.final_pointnet.PointLayer_0.Dense_0.weight"]  # fan_in 515
    assert abs(float(k.std()) - (2.0 / 515) ** 0.5) < 0.05 * (2.0 / 515) ** 0.5
    assert float(big["classifier.fc1.Dense_0.bias"].abs().max()) == 0.0
