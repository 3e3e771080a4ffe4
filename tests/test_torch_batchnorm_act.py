"""The fused BatchNorm's registered operators (``sonet_torch.ops.cuda.
batchnorm_act``) on the CPU: their CPU implementations (the plain
versions) and fake kernels against ``nn.layers.BatchNorm``'s own chain,
which the CPU keeps running.  The kernels themselves are held on the card
(``tests/test_torch_cuda.py``).

Tolerances: forwards and statistics ``==`` (the same ATen operators in the
same order); gradients within 1e-5 of the largest in float32 and 1e-2 in
bf16, since the operators' backward is the closed form of autograd's
chain (other float32 roundings, and in bf16 one rounding of dy either
side of a tie)."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sonet_torch.nn import layers
from sonet_torch.nn.layers import BatchNorm, PointLayer
from sonet_torch.ops.cuda import batchnorm_act as bna

C = 24
# two-pass below 8192 rows, one-pass from there on; a rank-2 and a
# rank-4 input (the heads' (B, C), the kNN layer's (B, M, K, C))
SHAPES = [(8, C), (2, 4, 3, C), (3, 3000, C)]
DTYPES = [torch.float32, torch.bfloat16]


def _layer(seed=0):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(C, generator=gen) - 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(C, generator=gen) + 0.5)
    return bn


def _inputs(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    y = (torch.randn(shape, generator=gen) * 2 + 0.3).to(dtype)
    b = torch.randn(shape[-1], generator=gen).to(dtype)
    g = torch.randn(shape, generator=gen).to(dtype)
    return y, b, g


def _grad_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


def _close(got, want, tol):
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_operators_equal_the_batchnorm_chain(shape, dtype, relu, train):
    act = "relu" if relu else None
    y, b, g = _inputs(shape, dtype)
    bn = _layer()
    bn.train(train)
    x = y.clone().requires_grad_()
    want = bn.normalise(x, None, b, act)
    want.backward(g)
    weight = bn.weight.detach().clone().requires_grad_()
    beta = bn.bias.detach().clone().requires_grad_()
    x2 = y.clone().requires_grad_()
    if train:
        got, mean, var = bna.batchnorm_act_train(x2, b, weight, beta, bn.eps,
                                                 relu)
        xf = (y + b).float()
        rows = tuple(range(len(shape) - 1))
        assert torch.equal(mean, xf.mean(rows))
        assert mean.dtype == var.dtype == torch.float32
        assert not mean.requires_grad and not var.requires_grad
    else:
        got = bna.batchnorm_act_eval(x2, b, weight, beta, bn.running_mean,
                                     bn.running_var, bn.eps, relu)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    got.backward(g)
    tol = _grad_tol(dtype)
    _close(x2.grad, x.grad, tol)
    _close(weight.grad, bn.weight.grad, tol)
    _close(beta.grad, bn.bias.grad, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_statistics_update_the_running_ones_alike(dtype):
    """The running statistics after one update from the operator's mean
    and variance equal those of the plain chain."""
    y, b, _ = _inputs((3, 3000, C), dtype)
    bn, plain = _layer(), _layer()
    _, mean, var = bna.batchnorm_act_train(y, b, bn.weight.detach(),
                                           bn.bias.detach(), bn.eps, True)
    bn._update_running(mean, var, y.numel() // C, None)
    plain.normalise(y, None, b, "relu")
    assert torch.equal(bn.running_mean, plain.running_mean)
    assert torch.equal(bn.running_var, plain.running_var)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fake_kernels_give_the_real_shapes(dtype):
    y, b, g = _inputs((2, 4, 3, C), dtype)
    bn = _layer()
    w, beta = bn.weight.detach(), bn.bias.detach()
    rm, rv = bn.running_mean, bn.running_var
    ops = torch.ops.sonet_torch
    calls = [
        lambda y, b, g: ops.batchnorm_act_train(y, b, w, beta, 1e-5, True,
                                                ["data"]),
        lambda y, b, g: ops.batchnorm_act_eval(y, b, w, beta, rm, rv, 1e-5,
                                               False),
        lambda y, b, g: ops.batchnorm_act_backward(
            g, y, b, w, beta, rm, rv, 1e-5, True, True, ["data"]),
    ]
    for call in calls:
        real = call(y, b, g)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = call(*(mode.from_tensor(t) for t in (y, b, g)))
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert [(t.shape, t.dtype) for t in fake] == [
            (t.shape, t.dtype) for t in real]


@pytest.mark.parametrize("activation", ["relu", "elu", None])
def test_point_layer_takes_the_operators_where_fused(activation,
                                                     monkeypatch):
    """A PointLayer whose BatchNorm takes the operators (as on a card, by
    ``layers.fused``) answers as the plain chain: the same forward in
    train and eval mode, the same running statistics, close gradients;
    the activation is fused for relu and follows the operators
    otherwise."""
    gen = torch.Generator().manual_seed(0)
    plain = PointLayer(16, C, gen, activation=activation,
                       normalization="batch", compute_dtype=torch.bfloat16)
    fused = PointLayer(16, C, torch.Generator(), activation=activation,
                       normalization="batch", compute_dtype=torch.bfloat16)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(2, 500, 16, generator=gen)
    for train in (True, False):
        plain.train(train)
        fused.train(train)
        want = plain(x, epoch=3)
        want.float().square().sum().backward()
        before = dict(bna.launches)
        monkeypatch.setattr(layers, "fused", lambda t: True)
        got = fused(x, epoch=3)
        monkeypatch.undo()
        got.float().square().sum().backward()
        assert bna.launches == before        # the CPU counts no launch
        assert torch.equal(got, want)
        for (name, p), q in zip(fused.named_parameters(),
                                plain.parameters()):
            if q.grad is None:
                assert p.grad is None, name      # the detached Dense bias
            else:
                _close(p.grad, q.grad, 1e-2)
        for k, v in fused.state_dict().items():
            assert torch.equal(v, plain.state_dict()[k]), k


def test_entry_points_refuse_a_bias_with_a_gradient():
    y, b, _ = _inputs((8, C), torch.float32)
    bn = _layer()
    with pytest.raises(ValueError, match="no gradient"):
        bna.batchnorm_act_train(y, b.requires_grad_(), bn.weight, bn.bias,
                                1e-5, True)


def test_entry_points_refuse_a_device_mix():
    y, b, _ = _inputs((8, C), torch.float32)
    bn = _layer()
    with pytest.raises(ValueError, match="one CUDA device"):
        bna.batchnorm_act_eval(y, b.to("meta"), bn.weight, bn.bias,
                               bn.running_mean, bn.running_var, 1e-5, True)
