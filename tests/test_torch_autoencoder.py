"""The port's autoencoder family against the JAX package's, on the CPU:
``InstanceNorm``, ``UpConv``, the Chamfer loss, the decoder,
``AutoencoderModel``, the autoencode train and eval steps, and serving.

Inputs are made with numpy from a seed and fed to both sides; weights
cross by ``sonet_torch.convert``.  The JAX side runs at highest matmul
precision and its Pallas kernel in interpret mode (tests/conftest.py).

Tolerances, and why:
* float32 outputs: 1e-4 of max(1, the largest entry): the same
  arithmetic, summed in another order (float32 rounding through the ~20
  layers of encoder and decoder);
* bfloat16 outputs: 2e-2 of the largest coordinate: both sides round to
  bf16 after every layer, at slightly different points (1 ulp is
  0.4-0.8%).  Given the same feature the two decoders agree to the bit at
  ``tiny_test`` size; where the encoders' features differ by one bf16 ulp
  the decoder spreads that over its taps, so for the whole model the
  coordinate is the largest that the decoder emits on any tap (the taps
  are clouds in one frame; the JAX package's own bf16 forward is as far
  from its float32 one);
* Chamfer fields and gradients in float32: 1e-5;
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
from sonet_tpu import serving as jserving
from sonet_tpu.nn import decoder as jdec
from sonet_tpu.nn import layers as jl
from sonet_tpu.ops import chamfer as j_chamfer
from sonet_tpu.train import loops as jloops
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import serving as tserving
from sonet_torch import train as ttrain
from sonet_torch.convert import (flatten, gradients_to_jax,
                                 load_jax_variables, to_jax_variables)
from sonet_torch.models import AutoencoderModel, build_model
from sonet_torch.nn import decoder as tdec
from sonet_torch.nn import layers as tl
from sonet_torch.ops import chamfer as t_chamfer
from sonet_torch.ops import robust_norm
from sonet_torch.serving import ServingEngine

torch.set_num_threads(2)

RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
LR = 1e-5
STEPS = 3
SPE = 2          # steps per epoch: the third step runs in epoch 1
UNUSED_STAGE = ("decoder/conv_decoder/UpConv_5/",
                "decoder/conv_decoder/ConvToPC_2/")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype, scale=None):
    got = _np(got) if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = scale or max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * scale, (err, scale)


def _dt(name):
    return (jnp.bfloat16, torch.bfloat16) if name == "bfloat16" else (None,
                                                                       None)


def _perturb(variables, rs):
    """Flattened variables with random BatchNorm statistics and random
    normalization scales and biases, so that every affine map and the
    eval-mode normalisation are exercised."""
    flat = flatten(variables)
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            if k.endswith("/mean"):
                flat[k] = (0.2 * rs.randn(*v.shape)).astype(np.float32)
            else:
                flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif "Norm_" in k:
            flat[k] = (v + 0.2 * rs.randn(*v.shape)).astype(np.float32)
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


def _holder(name, module):
    """``module`` as the child ``name`` of an empty parent: ``convert``
    maps variables by path, and a norm or a convolution is told from a
    dense layer by its module's name."""
    parent = torch.nn.Module()
    parent.add_module(name, module)
    return parent


def _under(name, flat):
    """A leaf module's flattened variables as its parent sees them."""
    return {k.replace("/", f"/{name}/", 1): v for k, v in flat.items()}


def _np_flat(tree):
    return {k: np.array(v) for k, v in flatten(tree).items()}


# ---------------------------------------------------------------------------
# InstanceNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7), (3, 20, 7), (2, 5, 6, 7)])
def test_instance_norm_matches_jax(shape, dtype):
    rs = np.random.RandomState(len(shape))
    x = (2.0 * rs.randn(*shape) + 1.0).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jmod = jl.InstanceNorm()
    flat = _perturb(jmod.init(jax.random.PRNGKey(0), jx), rs)
    tmod = tl.InstanceNorm(shape[-1])
    load_jax_variables(_holder("InstanceNorm_0", tmod),
                       _under("InstanceNorm_0", flat))
    assert set(tmod.state_dict()) == {"weight", "bias"}      # no statistics
    want = jmod.apply(_unflatten(flat), jx)
    got = tmod(_t(x).to(_dt(dtype)[1] or torch.float32))
    # a rank-2 input gets the affine map only, in the promoted dtype
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got, np.asarray(want, np.float32), dtype)
    if len(shape) > 2 and dtype == "float32":
        # normalised per sample and channel before the affine map
        y = (_np(got) - flat["params/bias"]) / flat["params/scale"]
        axes = tuple(range(1, len(shape) - 1))
        np.testing.assert_allclose(y.mean(axes), 0.0, atol=1e-5)
        np.testing.assert_allclose(y.var(axes), 1.0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_layer_with_instance_norm_matches_jax(dtype):
    jdt, tdt = _dt(dtype)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 30, 12).astype(np.float32)
    jmod = jl.PointLayer(20, activation="relu", normalization="instance",
                         compute_dtype=jdt)
    flat = _perturb(jmod.init(jax.random.PRNGKey(0), x), rs)
    assert "params/InstanceNorm_0/scale" in flat
    tmod = tl.PointLayer(12, 20, torch.Generator().manual_seed(0),
                         normalization="instance", compute_dtype=tdt)
    load_jax_variables(tmod, flat)
    assert set(to_jax_variables(tmod)) == set(flat)
    # the bias before an InstanceNorm keeps its gradient (only a BatchNorm
    # stops it, as in the JAX package)
    assert not tmod.Dense_0.stop_bias_grad
    _close(tmod(_t(x)), jmod.apply(_unflatten(flat), x), dtype)
    with pytest.raises(NotImplementedError):
        tl.PointLayer(12, 20, torch.Generator(), normalization="layer")


# ---------------------------------------------------------------------------
# UpConv and the initialisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("norm", ["batch", None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upconv_matches_jax(dtype, norm, train):
    jdt, tdt = _dt(dtype)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 4, 6).astype(np.float32)
    kw = dict(momentum=0.1, bn_momentum_decay_step=2, bn_momentum_decay=0.5)
    jmod = jl.UpConv(10, normalization=norm, compute_dtype=jdt, **kw)
    flat = _perturb(jmod.init(jax.random.PRNGKey(0), x), rs)
    assert flat["params/Conv_0/kernel"].shape == (3, 3, 6, 10)
    tmod = tl.UpConv(6, 10, torch.Generator().manual_seed(0),
                     normalization=norm, compute_dtype=tdt, **kw).train(train)
    load_jax_variables(tmod, flat)
    assert tmod.Conv_0.weight.shape == (10, 6, 3, 3)
    want, mut = jmod.apply(_unflatten(flat), x, train=train,
                           epoch=jnp.float32(3), mutable=["batch_stats"])
    got = tmod(_t(x), epoch=3)
    assert got.shape == (2, 8, 8, 10) and got.is_contiguous()
    assert str(got.dtype).endswith(dtype)
    _close(got, np.asarray(want, np.float32), dtype)
    if norm == "batch":
        after = to_jax_variables(tmod)
        for leaf in ("mean", "var"):
            k = f"batch_stats/BatchNorm_0/{leaf}"
            w = np.asarray(mut["batch_stats"]["BatchNorm_0"][leaf])
            # eval leaves the statistics alone; train moves them by the
            # decayed momentum (0.1 * 0.5 at epoch 3)
            assert np.array_equal(w, flat[k]) != train
            np.testing.assert_allclose(after[k], w, rtol=RTOL[dtype],
                                       atol=RTOL[dtype])
    else:
        assert tmod.BatchNorm_0 is None


def test_upconv_upsample_is_nearest():
    """An identity 3x3 kernel (centre tap 1) passes the upsampled map
    through: every input pixel becomes a 2x2 block."""
    up = tl.UpConv(2, 2, torch.Generator().manual_seed(0), activation=None,
                   normalization=None)
    with torch.no_grad():
        up.Conv_0.weight.zero_()
        up.Conv_0.weight[0, 0, 1, 1] = up.Conv_0.weight[1, 1, 1, 1] = 1.0
        up.Conv_0.bias.zero_()
        x = torch.arange(2 * 3 * 2 * 2, dtype=torch.float32).reshape(2, 3, 2,
                                                                     2)
        y = up(x)
    want = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_he_normal_out_and_conv_bias_init():
    conv = tl.Conv3x3(64, 128, torch.Generator().manual_seed(0))
    std = (2.0 / (128 * 9)) ** 0.5                 # fan_out = out * 3 * 3
    # 73,728 draws: the sample std is within 1% of its value
    assert abs(float(conv.weight.detach().std()) - std) < 0.01 * std
    assert abs(float(conv.weight.detach().mean())) < 0.02 * std
    assert torch.equal(conv.bias, torch.full((128,), 0.001))
    # flax scales its fan_out initialiser the same way
    k = jl.he_normal_out()(jax.random.PRNGKey(0), (3, 3, 64, 128))
    assert abs(float(jnp.std(k)) - std) < 0.01 * std
    again = tl.Conv3x3(64, 128, torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, conv.weight)


def test_point_emitting_biases_start_uniform():
    cfg = tcfg.autoencoder()
    dec = tdec.Decoder(cfg, torch.Generator().manual_seed(0))
    b = dec.fc_decoder.linear_out.bias.detach()            # 768 draws
    assert b.shape == (768,) and float(b.min()) < -0.9 and float(b.max()) > 0.9
    assert float(b.abs().max()) <= 1.0
    assert abs(float(b.mean())) < 0.1                      # sd 0.021
    assert abs(float(b.var()) - 1.0 / 3.0) < 0.05
    for i in range(3):
        tap = getattr(dec.conv_decoder, f"ConvToPC_{i}")
        assert float(tap.Dense_0.bias.detach().abs().max()) <= 1.0
        assert float(tap.Dense_0.bias.detach().abs().min()) > 0.0
        assert float(tap.PointLayer_0.Dense_0.bias.detach().abs().max()) == 0.0
    # and no layer of the pyramid before them does
    assert float(dec.fc_decoder.PointLayer_2.Dense_0.bias.detach()
                 .abs().max()) == 0.0


# ---------------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------------

def _inputs(cfg, seed, B=2):
    rs = np.random.RandomState(seed)
    N, M = cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    sn = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    # one far node: guaranteed empty, exercising the empty-node patch
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    return pc, sn, node


def test_convert_roundtrip_of_an_autoencoder():
    jc = jcfg.tiny_test().replace(task="autoencode")
    tc = tcfg.tiny_test().replace(task="autoencode")
    variables = jmodels.build_model(jc).init(jax.random.PRNGKey(0),
                                             *_inputs(jc, 0))
    flat = _perturb(variables, np.random.RandomState(1))
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)                # raises on any key unused
    back = to_jax_variables(model)
    assert set(back) == set(flat) and len(flat) == len(model.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    k = "params/decoder/conv_decoder/UpConv_1/Conv_0/kernel"
    assert flat[k].shape == (3, 3, 64, 32)                    # HWIO
    w = model.decoder.conv_decoder.UpConv_1.Conv_0.weight
    assert w.shape == (32, 64, 3, 3)                          # OIHW
    np.testing.assert_array_equal(_np(w)[5, 7, 0, 2], flat[k][0, 2, 7, 5])
    # still strict
    with pytest.raises(KeyError, match="no place"):
        load_jax_variables(model, dict(flat, **{
            "params/decoder/conv_decoder/UpConv_6/Conv_0/kernel":
                np.zeros((3, 3, 1, 1))}))
    missing = dict(flat)
    missing.pop("params/decoder/fc_decoder/linear_out/bias")
    with pytest.raises(KeyError, match="not set"):
        load_jax_variables(model, missing)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(model, dict(flat, **{k: flat[k].T}))


def test_convert_tells_a_conv_kernel_from_a_plain_transpose():
    """A kernel with no symmetry (its taps, inputs and outputs all differ)
    through flax's convolution and the port's."""
    rs = np.random.RandomState(3)
    kernel = rs.randn(3, 3, 4, 5).astype(np.float32)
    x = rs.randn(2, 6, 7, 4).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, kernel, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tl.Conv3x3(4, 5, torch.Generator().manual_seed(0))
    holder = _holder("Conv_0", conv)
    load_jax_variables(holder, {"params/Conv_0/kernel": kernel,
                                "params/Conv_0/bias": np.zeros(5, np.float32)})
    _close(conv(_t(x)), want, "float32")
    np.testing.assert_array_equal(
        to_jax_variables(holder)["params/Conv_0/kernel"], kernel)
    # what a plain reversal of the axes (the taps transposed) would give
    wrong = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(kernel.T), padding=1).permute(0, 2, 3,
                                                                    1)
    assert float((wrong - _t(np.asarray(want))).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# Chamfer
# ---------------------------------------------------------------------------

def _clouds_pair(P, N, seed, B=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, P, 3).astype(np.float32),
            rs.randn(B, N, 3).astype(np.float32))


@pytest.mark.parametrize("P,N", [(40, 40), (24, 70), (70, 24)])
def test_chamfer_fields_match_jax(P, N):
    pred, gt = _clouds_pair(P, N, P + N)
    want = j_chamfer(jnp.asarray(pred), jnp.asarray(gt))
    got = t_chamfer(_t(pred), _t(gt))
    assert got._fields == want._fields and len(got) == 6
    for name in want._fields:
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert got.loss_array.shape == (3,)
    np.testing.assert_allclose(float(got.loss),
                               float(got.loss_array.mean()), rtol=1e-5)


@pytest.mark.parametrize("P,N", [(40, 40), (24, 70)])
def test_chamfer_gradient_matches_jax(P, N):
    pred, gt = _clouds_pair(P, N, 7 + P)
    want = jax.grad(lambda p: j_chamfer(p, jnp.asarray(gt)).loss)(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    t_chamfer(p, _t(gt)).loss.backward()
    np.testing.assert_allclose(_np(p.grad), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # both terms reach predict_pc: the forward term touches every predicted
    # point, the backward term only the points some gt point selected
    assert bool((p.grad.abs().sum(-1) > 0).all())
    g = _t(gt).requires_grad_()
    t_chamfer(_t(pred), g).loss.backward()
    want_gt = jax.grad(lambda q: j_chamfer(jnp.asarray(pred), q).loss)(
        jnp.asarray(gt))
    np.testing.assert_allclose(_np(g.grad), np.asarray(want_gt), rtol=1e-5,
                               atol=1e-5)


def test_chamfer_of_identical_clouds():
    pc, _ = _clouds_pair(30, 30, 5)
    got = t_chamfer(_t(pc), _t(pc))
    # every point is its own nearest neighbour: sqrt(0 + 1e-8) per pair
    np.testing.assert_allclose(float(got.loss), 2e-4, rtol=1e-3)
    np.testing.assert_allclose(float(robust_norm(torch.zeros(2, 3))
                                     [0]), 1e-4, rtol=1e-5)


def test_chamfer_ties_go_to_the_first_minimum():
    """Two gt points at the same distance from a predicted point: the
    selection, and so the gradient's direction, is the first one's."""
    pred = np.zeros((1, 1, 3), np.float32)
    gt = np.array([[[1, 0, 0], [-1, 0, 0], [0, 3, 0]]], np.float32)
    want = jax.grad(lambda p: j_chamfer(p, jnp.asarray(gt))
                    .forward_loss)(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    t_chamfer(p, _t(gt)).forward_loss.backward()
    np.testing.assert_allclose(_np(p.grad), np.asarray(want), atol=1e-6)
    assert float(p.grad[0, 0, 0]) < 0          # pulled toward gt[0] = +x


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_DECODER_CASES = {
    "tiny": dict(),                                # fc 16 + conv 1024
    "no_conv": dict(output_conv_pc_num=0),
    "conv_4096": dict(output_conv_pc_num=4096),
    "no_fc": dict(output_fc_pc_num=0),
    "instance_norm": dict(normalization="instance"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_DECODER_CASES))
def test_decoder_matches_jax(case, dtype):
    over = dict(_DECODER_CASES[case], task="autoencode", compute_dtype=dtype)
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    rs = np.random.RandomState(4)
    feature = rs.randn(3, jc.feature_num).astype(np.float32)
    jmod = jdec.Decoder(jc)
    flat = _perturb(jmod.init(jax.random.PRNGKey(0), feature), rs)
    tmod = tdec.Decoder(tc, torch.Generator().manual_seed(0)).eval()
    load_jax_variables(tmod, flat)
    want = jmod.apply(_unflatten(flat), feature)
    with torch.no_grad():
        got = tmod(_t(feature))
    assert got._fields == want._fields
    n_fc = tc.output_fc_pc_num
    n_conv = tc.output_conv_pc_num
    assert got.pc.shape == (3, n_fc + n_conv, 3)
    assert got.pc.dtype == torch.float32
    # in bf16 the tolerance is 2% of the largest coordinate of the cloud
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "conv_pc6" and n_conv == 1024:
            assert g is None and w.shape == (3, 4096, 3)   # not computed
        elif w is None:
            assert g is None, name
        else:
            _close(g, w, dtype)
    if n_fc and n_conv:
        torch.testing.assert_close(got.pc[:, :n_fc], got.linear_pc,
                                   rtol=0, atol=0)
        conv = got.conv_pc6 if n_conv == 4096 else got.conv_pc5
        torch.testing.assert_close(got.pc[:, n_fc:], conv, rtol=0, atol=0)


def test_decoder_rejects_an_inconsistent_output_pc_num():
    good = tcfg.autoencoder()
    assert good.output_pc_num == 1280
    tdec.Decoder(good.replace(feature_num=64), torch.Generator())
    bad = good.replace(feature_num=64, output_conv_pc_num=4096)
    with pytest.raises(ValueError, match="inconsistent"):
        tdec.Decoder(bad, torch.Generator())
    with pytest.raises(ValueError, match="inconsistent"):
        build_model(bad, device="cpu")
    jbad = jcfg.autoencoder().replace(feature_num=64, output_conv_pc_num=4096)
    with pytest.raises(ValueError, match="inconsistent"):
        jdec.Decoder(jbad).init(jax.random.PRNGKey(0),
                                np.zeros((1, 64), np.float32))


def test_unread_stage_runs_only_for_its_train_statistics():
    """With 1024 conv points nothing reads the 64x64 stage: eval skips it;
    a train forward moves its running statistics and nothing else of it,
    and builds no graph through it."""
    cfg = tcfg.tiny_test().replace(task="autoencode")
    dec = tdec.Decoder(cfg, torch.Generator().manual_seed(0))
    feature = torch.randn(4, cfg.feature_num)
    stage = [dec.conv_decoder.UpConv_5, dec.conv_decoder.ConvToPC_2]
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in stage]
    dec.eval()
    with torch.no_grad():
        out = dec(feature)
    assert out.conv_pc6 is None and not calls
    before = {k: v.clone() for k, v in dec.state_dict().items()}
    dec.train()
    out = dec(feature)
    assert out.conv_pc6 is None and len(calls) == 2
    (out.pc.sum() + out.conv_pc4.sum()).backward()
    for h in hooks:
        h.remove()
    moved = {k for k, v in dec.state_dict().items()
             if not torch.equal(v, before[k])}
    in_stage = {k for k in before if k.startswith(
        ("conv_decoder.UpConv_5.", "conv_decoder.ConvToPC_2."))}
    assert {k for k in in_stage if "running_" in k} <= moved
    assert len([k for k in in_stage if "running_" in k]) == 4
    for m in stage:
        assert all(p.grad is None for p in m.parameters())
    assert dec.conv_decoder.UpConv_4.Conv_0.weight.grad is not None


# ---------------------------------------------------------------------------
# the whole autoencoder, eval forward
# ---------------------------------------------------------------------------

_MODEL_CASES = {
    # tiny_test: 64 points, 16 nodes, F=64, 16 + 1024 output points
    "tiny": ("tiny_test", dict(task="autoencode")),
    # config.autoencoder() as it is: N=1024, M=64, k=3, som_k=9, F=1024,
    # 256 + 1024 output points
    "autoencoder": ("autoencoder", dict()),
}
_jax_cache = {}


def _run_pair(case, dtype, pooling):
    preset, over = _MODEL_CASES[case]
    over = dict(over, compute_dtype=dtype, pooling=pooling, batch_size=2)
    jc = getattr(jcfg, preset)().replace(**over)
    tc = getattr(tcfg, preset)().replace(**over)
    pc, sn, node = _inputs(jc, seed=7)
    key = (case, dtype, pooling)
    if key not in _jax_cache:
        jm = jmodels.build_model(jc)
        variables = jm.init(jax.random.PRNGKey(0), pc, sn, node)
        flat = _perturb(variables, np.random.RandomState(8))
        dec, enc = jm.apply(_unflatten(flat), pc, sn, node, train=False)
        _jax_cache[key] = flat, dec, np.asarray(enc.feature, np.float32)
    flat, jdec_out, jfeature = _jax_cache[key]
    model = build_model(tc, device="cpu")
    assert isinstance(model, AutoencoderModel)
    load_jax_variables(model, flat)
    with torch.no_grad():
        dec, enc = model(*(_t(a) for a in (pc, sn, node)))
    return tc, (dec, enc), (jdec_out, jfeature)


@pytest.mark.parametrize("pooling", ["scatter", "sorted_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_MODEL_CASES))
def test_autoencoder_forward_matches_jax(case, dtype, pooling):
    tc, (dec, enc), (jdec_out, jfeature) = _run_pair(case, dtype, pooling)
    P = tc.output_fc_pc_num + tc.output_conv_pc_num
    assert dec.pc.shape == (2, P, 3) == jdec_out.pc.shape
    assert dec.pc.dtype == torch.float32
    _close(enc.feature, jfeature, dtype)
    taps = ("pc", "linear_pc", "conv_pc4", "conv_pc5")
    largest = max(float(np.abs(np.asarray(getattr(jdec_out, n))).max())
                  for n in taps)
    for name in taps:
        _close(getattr(dec, name), getattr(jdec_out, name), dtype,
               scale=largest if dtype == "bfloat16" else None)
    assert dec.conv_pc6 is None


def test_autoencoder_preset_builds_the_reference_shapes():
    cfg = tcfg.autoencoder()
    model = build_model(cfg, device="cpu")
    conv = model.decoder.conv_decoder
    widths = [getattr(conv, f"UpConv_{i}").Conv_0.weight.shape[:2]
              for i in range(6)]
    assert widths == [(1024, 1024), (512, 1024), (256, 512), (128, 256),
                      (128, 128), (128, 128)]
    fc = model.decoder.fc_decoder
    assert fc.linear_out.weight.shape == (768, 1024)
    assert fc.PointLayer_0.Dense_0.weight.shape == (512, 1024)
    # two optimizer groups: the decoder trains at the head's rate
    opt, _ = ttrain.make_optimizer(model, cfg, steps_per_epoch=10)
    assert [g["name"] for g in opt.param_groups] == ["encoder", "head"]
    n_head = sum(p.numel() for p in opt.param_groups[1]["params"])
    assert n_head == sum(p.numel() for p in model.decoder.parameters())


# ---------------------------------------------------------------------------
# three train steps against the JAX package
# ---------------------------------------------------------------------------

def _batch(cfg, seed):
    pc, sn, node = _inputs(cfg, seed, B=cfg.batch_size)
    return {"pc": pc, "sn": sn, "node": node}


@pytest.fixture(scope="module", params=["scatter", "sorted_window"])
def trajectories(request):
    """Both sides from the same weights through the same three batches:
    per-step metrics, first-step gradients, the state after three steps,
    and the eval metrics on the first batch."""
    over = dict(task="autoencode", pooling=request.param, dropout=0.0,
                batch_size=4, lr=LR, bn_momentum_decay_step=1)
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
            (dec, _), _ = jm.apply(
                {"params": p, "batch_stats": batch_stats}, b["pc"], b["sn"],
                b["node"], None, train=True, epoch=jnp.float32(0),
                mutable=["batch_stats"])
            return jloops._ae_loss(jc, dec, b["pc"])[0]
        return jax.grad(loss_fn)(params)

    j_grads = _np_flat({"params": jax_grads(js.params, js.batch_stats, b0)})

    model = build_model(tc, device="cpu")
    load_jax_variables(model, init)
    ts = ttrain.init_state(tc, device="cpu", model=model,
                           steps_per_epoch=SPE)
    j_train, j_eval = jloops.make_steps(jm, jc, SPE)
    t_train, t_eval = ttrain.make_steps(tc, SPE)
    j_metrics, t_metrics = [], []
    t_grads = None
    for i, b in enumerate(batches):
        js, jmet = j_train(js, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(1))
        ts, tmet = t_train(ts, {k: _t(v) for k, v in b.items()},
                           torch.Generator().manual_seed(1))
        j_metrics.append({k: float(v) for k, v in jmet.items()})
        t_metrics.append({k: float(v) for k, v in tmet.items()})
        if i == 0:
            t_grads = gradients_to_jax(ts.model)
    j_ev = jax.tree.map(np.asarray, j_eval(
        js, {k: jnp.asarray(v) for k, v in b0.items()}))
    t_ev = t_eval(ts, {k: _t(v) for k, v in b0.items()})
    return dict(
        init=init, j_metrics=j_metrics, t_metrics=t_metrics, j_grads=j_grads,
        t_grads=t_grads,
        j_final=_np_flat({"params": js.params,
                          "batch_stats": js.batch_stats}),
        t_final=to_jax_variables(ts.model), t_step=ts.step,
        j_eval=j_ev, t_eval={k: v.numpy() for k, v in t_ev.items()})


def test_train_losses_and_parts_match_jax(trajectories):
    r = trajectories
    assert r["t_step"] == STEPS
    for jm, tm in zip(r["j_metrics"], r["t_metrics"]):
        assert set(tm) == set(jm) == {"loss", "chamfer", "chamfer_fwd",
                                      "chamfer_bwd", "chamfer_pc4"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(tm["loss"],
                                   tm["chamfer"] + tm["chamfer_pc4"],
                                   rtol=1e-6)


def test_first_step_gradients_match_jax(trajectories):
    jg, tg = trajectories["j_grads"], trajectories["t_grads"]
    assert set(tg) == set(jg)
    for k, want in jg.items():
        err = float(np.abs(tg[k] - want).max())
        tol = 1e-3 * float(np.abs(want).max()) + 1e-6
        assert err <= tol, (k, err, tol)
    # the loss reaches the encoder through the decoder, both branches
    for k in ("params/encoder/first_pointnet/PointLayer_0/Dense_0/kernel",
              "params/decoder/fc_decoder/linear_out/kernel",
              "params/decoder/conv_decoder/UpConv_0/Conv_0/kernel"):
        assert np.abs(tg[k]).max() > 1e-4, k


def test_params_and_batch_stats_after_three_steps(trajectories):
    jf, tf = trajectories["j_final"], trajectories["t_final"]
    assert set(tf) == set(jf)
    diffs = np.concatenate([np.abs(tf[k] - jf[k]).ravel()
                            for k in jf if k.startswith("params/")])
    assert (diffs > 0.1 * LR).mean() <= 2e-3, (diffs > 0.1 * LR).mean()
    n_stats = 0
    for k in jf:
        if k.startswith("batch_stats/"):
            scale = max(1.0, float(np.abs(jf[k]).max()))
            assert np.abs(tf[k] - jf[k]).max() <= 1e-4 * scale, k
            n_stats += 1
    # 6 BatchNorms in the encoder, 3 in the FC pyramid, 6 UpConvs, 3 taps;
    # the unread stage's two among them
    assert n_stats == 2 * 18


def test_unread_stage_and_stopped_biases_never_move(trajectories):
    """No gradient reaches the 64x64 stage (the JAX package's is zero, so
    Adam leaves it alone there too) nor a bias that a BatchNorm follows;
    every other tensor moved.  The stage's running statistics do move, on
    both sides alike (held in the test above)."""
    init, jf, tf, jg = (trajectories[k] for k in ("init", "j_final",
                                                  "t_final", "j_grads"))
    stopped = {k.replace("/BatchNorm_0/scale", "/Dense_0/bias")
               for k in init if k.endswith("/BatchNorm_0/scale")
               and "UpConv" not in k}
    assert len(stopped) == 6 + 3 + 3       # encoder, fc pyramid, the taps
    frozen = {k for k in init if k.startswith("params/")
              and any(s in k for s in UNUSED_STAGE)}
    assert len(frozen) == 4 + 6
    for k in init:
        if not k.startswith("params/"):
            continue
        if k in stopped or k in frozen:
            np.testing.assert_array_equal(tf[k], init[k], err_msg=k)
            np.testing.assert_array_equal(jf[k], init[k], err_msg=k)
        else:
            assert not np.array_equal(tf[k], init[k]), k
    for k in frozen:
        assert not jg[k].any(), k
    for k in init:
        if k.startswith("batch_stats/") and any(s in k for s in UNUSED_STAGE):
            assert not np.array_equal(tf[k], init[k]), k
            assert not np.array_equal(jf[k], init[k]), k


def test_eval_step_matches_jax(trajectories):
    je, te = trajectories["j_eval"], trajectories["t_eval"]
    assert set(te) == set(je)
    assert te["predicted_pc"].shape == (4, 16 + 1024, 3)
    scale = max(1.0, float(np.abs(je["predicted_pc"]).max()))
    assert (np.abs(te["predicted_pc"] - je["predicted_pc"]).max()
            <= 1e-4 * scale)
    # a Chamfer term moves at most as far as the points it reads
    for k in ("loss_i", "chamfer_fwd_i", "chamfer_bwd_i", "loss", "chamfer",
              "chamfer_fwd", "chamfer_bwd", "chamfer_pc4"):
        np.testing.assert_allclose(te[k], je[k], rtol=0, atol=2e-4 * scale,
                                   err_msg=k)
    assert te["loss_i"].shape == (4,)
    np.testing.assert_allclose(te["loss_i"],
                               te["chamfer_fwd_i"] + te["chamfer_bwd_i"],
                               rtol=1e-6)


def test_ae_loss_with_4096_conv_points_matches_jax():
    over = dict(task="autoencode", output_conv_pc_num=4096, batch_size=2)
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    pc, sn, node = _inputs(jc, 11)
    jm = jmodels.build_model(jc)
    flat = _perturb(jm.init(jax.random.PRNGKey(0), pc, sn, node),
                    np.random.RandomState(12))
    dec, _ = jm.apply(_unflatten(flat), pc, sn, node, train=False)
    want_loss, want = jloops._ae_loss(jc, dec, jnp.asarray(pc))
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    with torch.no_grad():
        tdec_out, _ = model(_t(pc), _t(sn), _t(node))
        got_loss, got = ttrain.loops._ae_loss(tc, tdec_out, _t(pc))
    assert tdec_out.pc.shape == (2, 16 + 4096, 3)
    assert set(got) == set(want) and "chamfer_pc5" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(got_loss) == float(got["loss"])


def test_train_loss_is_taken_against_the_dropped_cloud():
    """With point dropout on, the loss compares with the cloud the encoder
    saw, not with the batch's: a model that returns its input's first
    points has a zero forward term only against the dropped cloud."""
    cfg = tcfg.tiny_test().replace(task="autoencode",
                                   random_pc_dropout_lower_limit=0.3)
    seen = {}

    class Echo(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = torch.nn.Linear(1, 1)
            self.shift = torch.nn.Parameter(torch.zeros(()))

        def forward(self, pc, sn, node, node_knn_I=None, *, epoch=None,
                    generator=None):
            seen["pc"] = pc
            out = pc + self.shift + 0.0 * self.encoder.weight.sum()
            return tdec.DecoderOutput(out, None, out, out, None), None

    state = ttrain.init_state(cfg, device="cpu", model=Echo())
    step, _ = ttrain.make_steps(cfg, 10)
    pc, sn, node = (_t(a) for a in _inputs(cfg, 13, B=4))
    _, met = step(state, {"pc": pc, "sn": sn, "node": node},
                  torch.Generator().manual_seed(0))
    assert not torch.equal(seen["pc"], pc)           # points were dropped
    np.testing.assert_allclose(float(met["chamfer"]), 2e-4, rtol=1e-3)
    assert float(t_chamfer(seen["pc"], pc).backward_loss) > 1e-2


# ---------------------------------------------------------------------------
# serving and runs on disk
# ---------------------------------------------------------------------------

def _request(cfg, n, seed=0):
    pc, sn, node = _inputs(cfg, seed, B=n)
    return {"pc": pc, "sn": sn, "node": node}


@pytest.fixture(scope="module", params=["auto", "sorted_window"])
def served(request):
    cfg = tcfg.tiny_test().replace(task="autoencode", pooling=request.param)
    model = build_model(cfg, device="cpu", seed=0)
    engine = ServingEngine.from_model(model, cfg, device="cpu", batch_size=4)
    return cfg, model, engine


@pytest.mark.parametrize("n", [1, 4, 7])
def test_served_cloud_equals_the_forward(served, n):
    """Padding (n=1, the tail of 7) and chunking (7 = 4 + 3) change no
    answer.  Served against direct: the same float32 forward over another
    number of rows, 1e-5."""
    cfg, model, engine = served
    req = _request(cfg, n, seed=n)
    got = engine.predict(req)
    with torch.no_grad():
        want, _ = model(*(_t(req[k]) for k in ("pc", "sn", "node")))
    assert got.shape == (n, 16 + 1024, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.pc.numpy(), rtol=1e-5, atol=1e-5)


def test_serving_manifest_and_signature_match_jax(served):
    cfg, _, engine = served
    assert engine.manifest["task"] == "autoencode"
    assert engine.manifest["output"] == jserving._OUTPUT_DOC["autoencode"]
    assert engine.input_names == ["pc", "sn", "node"]
    assert (tserving.input_signature(tcfg.autoencoder(), 3)
            == jserving.input_signature(jcfg.autoencoder(), 3))
    before = engine.stats()
    engine.warmup()
    assert engine.stats() == before


@pytest.fixture(scope="module")
def ae_run(tmp_path_factory):
    """A run directory of an autoencoder trained for two steps."""
    cfg = tcfg.tiny_test().replace(task="autoencode", dropout=0.0)
    run = tmp_path_factory.mktemp("ae_run")
    cfg.save(str(run / "config.json"))
    state = ttrain.init_state(cfg, device="cpu", seed=3)
    step, _ = ttrain.make_steps(cfg, 10)
    for seed in range(2):
        state, _ = step(state, {k: _t(v) for k, v in
                                _batch(cfg, seed).items()}, None)
    path = ttrain.save_checkpoint(str(run / "ckpt"), state, state.step)
    return cfg, state, str(run), path


def test_from_run_serves_an_autoencoder_run(ae_run):
    cfg, state, run, path = ae_run
    engine = ServingEngine.from_run(run, device="cpu")
    direct = ServingEngine.from_model(state.model, cfg, device="cpu")
    req = _request(cfg, 6, seed=5)
    got = engine.predict(req)
    np.testing.assert_array_equal(got, direct.predict(req))
    assert got.shape == (6, 1040, 3) and np.isfinite(got).all()
    assert engine.manifest["checkpoint"] == path
    assert engine.manifest["task"] == "autoencode"
    fresh = ttrain.init_state(cfg, device="cpu", seed=9)
    ttrain.restore_checkpoint(path, fresh)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.step == 2


def test_restore_encoder_from_an_autoencoder_into_a_classifier(ae_run):
    """The pretrain path: the autoencoder's encoder into a classifier."""
    cfg, state, _, path = ae_run
    ccfg = tcfg.tiny_test()
    target = ttrain.init_state(ccfg, device="cpu", seed=7)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    ttrain.restore_encoder(path, target)
    after = target.model.state_dict()
    saved = state.model.state_dict()
    enc = [k for k in after if k.startswith("encoder.")]
    assert len(enc) == sum(k.startswith("encoder.") for k in saved) > 0
    for k in enc:
        assert torch.equal(after[k], saved[k]), k
    for k in after:
        if not k.startswith("encoder."):
            assert torch.equal(after[k], before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in enc)
    # and a checkpoint of another task is refused as a whole state
    with pytest.raises(RuntimeError):
        ttrain.restore_checkpoint(path, target)
