"""The auto-encoder's train step (``sonet_torch``'s ``AutoencoderModel``
through ``train.make_steps``) against the benchmark's plain reference
(``benchmark/reference/autoencoder.py``) on the CPU, in float32, at a
small size, from the same seeded random weights, raw rows and draws:
the decoder's outputs, the multi-scale Chamfer loss, the first step's
gradient of every leaf and the parameters after three Adam steps, at
both conv levels (1,024 points, read from the 32x32 tap, and 4,096, from
the 64x64 one).  No JAX here."""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, data  # noqa: E402
from benchmark.drivers.train_autoencode import weights  # noqa: E402
from benchmark.reference import autoencoder as ra  # noqa: E402
from benchmark.reference import train as rt  # noqa: E402
from sonet_torch import config, train  # noqa: E402
from sonet_torch.data.device_pipeline import DeviceData, sample_batch  # noqa: E402,E501
from sonet_torch.nn.layers import BatchNorm  # noqa: E402
from sonet_torch.train.loops import _ae_loss  # noqa: E402

LEVELS = [1024, 4096]
STEPS_PER_EPOCH = 3
ROWS = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


def setup(conv):
    cfg = config.autoencoder().replace(
        compute_dtype="float32", batch_size=4, input_pc_num=96, node_num=16,
        feature_num=64, output_conv_pc_num=conv, output_pc_num=256 + conv)
    d = dataclasses.asdict(cfg)
    w = weights(d, 5, "cpu")
    sp = data.split({"items": 12, "points": 192, "nodes": 16, "classes": 16,
                     "parts": False}, 9, "cpu")
    return cfg, d, w, sp


def program(cfg, w):
    state = train.init_state(cfg, device="cpu", seed=0,
                             steps_per_epoch=STEPS_PER_EPOCH)
    state.model.load_state_dict(w, strict=True)
    return state


@pytest.fixture
def one_thread():
    """One CPU thread: the float32 sums then run in one order in both
    packages from call to call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("conv", LEVELS)
def test_decoder_outputs_and_loss(conv, one_thread):
    cfg, d, w, sp = setup(conv)
    raw = {k: v[:4] for k, v in sp.items()}
    batch = rt.sample(raw, torch.Generator().manual_seed(3), d, True)
    state = program(cfg, w)
    model = state.model.train()
    dec, _ = model(batch["pc"], batch["sn"], batch["node"], epoch=0)
    stats = {}
    with torch.no_grad():
        ref = ra.forward(w, d, batch, True, stats=stats)
    pairs = [("pc", dec.pc), ("linear_pc", dec.linear_pc),
             ("pc4", dec.conv_pc4), ("pc5", dec.conv_pc5)]
    if conv == 4096:
        pairs.append(("pc6", dec.conv_pc6))
    else:
        assert dec.conv_pc6 is None and "pc6" not in ref
    # float32 sums in other orders through the encoder and the decoder's
    # 11 normalised layers (the program's one-hot products and gathers,
    # the reference's scatters): 1e-4 of the largest coordinate
    for name, got in pairs:
        want = ref[name]
        assert got.shape == want.shape, name
        torch.testing.assert_close(
            got.detach(), want, rtol=0,
            atol=1e-4 * max(1.0, float(want.abs().max())))
    # the multi-scale loss: float32 rounding of the same sums, and a
    # nearest point picked on a near-tie (reference/autoencoder.py)
    got_loss, aux = _ae_loss(cfg, dec, batch["pc"])
    assert ("chamfer_pc5" in aux) == (conv == 4096)
    assert float(got_loss.detach()) == pytest.approx(
        float(ra.loss(d, ref, batch)), rel=1e-5)
    # every decoder BatchNorm took one step of its running statistics from
    # its batch statistics, the 64x64 stage's too where nothing reads it
    m = cfg.bn_momentum
    norms = {n[:-len(".BatchNorm_0")]: b for n, b in model.named_modules()
             if isinstance(b, BatchNorm) and n.startswith("decoder.")}
    assert set(norms) == {n for n in stats if n.startswith("decoder.")}
    for name, bn in norms.items():
        mean, var, n = stats[name]
        b = name + ".BatchNorm_0."
        torch.testing.assert_close(
            bn.running_mean, (1 - m) * w[b + "running_mean"] + m * mean,
            rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(
            bn.running_var,
            (1 - m) * w[b + "running_var"] + m * var * n / (n - 1),
            rtol=1e-4, atol=1e-5)


def _train(cfg, d, w, sp, steps):
    """``steps`` train steps of the program and of the reference on rows
    ``ROWS[:steps]`` with draws from generators of one seed; the program's
    first gradients, losses and parameters."""
    state = program(cfg, w)
    step, _ = train.make_steps(cfg, STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(21)
    split = DeviceData(pc=sp["pc"], sn=sp["sn"], node=sp["node"],
                       label=sp["label"])
    losses, first = [], None
    for idx in ROWS[:steps]:
        _, metrics = step(state, sample_batch(split, torch.tensor(idx), gen,
                                              cfg, train=True), gen)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = {n: (None if p.grad is None else p.grad.clone())
                     for n, p in state.model.named_parameters()}
    ref = ra.train_steps(w, d, [{k: v[i] for k, v in sp.items()}
                                for i in (torch.tensor(r)
                                          for r in ROWS[:steps])],
                         torch.Generator().manual_seed(21), STEPS_PER_EPOCH)
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    return {"grad": first, "loss": losses, "params": params}, ref


@pytest.mark.parametrize("conv", LEVELS)
def test_first_step_gradients(conv, one_thread):
    cfg, d, w, sp = setup(conv)
    got, ref = _train(cfg, d, w, sp, 1)
    assert got["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    leaves = compare.kept_leaves(ref["grad"])
    # the leaves left out have no true gradient: a dense bias a BatchNorm
    # cancels (None in the program), a convolution's bias added before its
    # BatchNorm (round-off on both sides), and at 1,024 conv points the
    # unread 64x64 stage (None in the program, zero in the reference)
    for n in set(ref["grad"]) - set(leaves):
        assert (got["grad"][n] is None or n.endswith("Conv_0.bias")
                or float(got["grad"][n].norm())
                < 1e-3 * float(ref["grad"][leaves[0]].norm()) + 1e-6), n
    for n in ref["grad"]:
        if ra.unread(d, n):
            assert got["grad"][n] is None, n
    assert len(leaves) >= len(ref["grad"]) - 30
    # each kept leaf elementwise: float32 sums in other orders, 1e-4 to
    # 5e-4 of the larger of its norm and the median leaf's
    med = float(torch.tensor([float(ref["grad"][n].norm())
                              for n in leaves]).median())
    for n in leaves:
        diff = float((got["grad"][n] - ref["grad"][n]).norm())
        assert diff < 1e-3 * max(float(ref["grad"][n].norm()), med), n


@pytest.mark.parametrize("conv", LEVELS)
def test_parameters_after_three_adam_steps(conv, one_thread):
    cfg, d, w, sp = setup(conv)
    got, ref = _train(cfg, d, w, sp, 3)
    # Adam's first update moves each weight by about lr x the sign of its
    # gradient, so an entry whose gradient lies within round-off of 0 moves
    # either way and the two runs part after one step (the classifier's
    # test in benchmark/tests holds its second loss to 1e-2 for this):
    # the first loss to float32 rounding, the later ones to 1e-2 (2e-3
    # read), and each leaf's change by its norm, to 0.1 (0.044 read); a
    # state left unchanged reads 1
    assert got["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    for g, r in zip(got["loss"][1:], ref["loss"][1:]):
        assert g == pytest.approx(r, rel=1e-2)
    leaves = compare.kept_leaves(ref["grad"])
    change = {n: got["params"][n] - w[n] for n in leaves}
    gaps = compare.leaf_gaps(change, ref["change"], leaves)
    assert max(gaps.values()) < 0.1, max(gaps, key=gaps.get)
    for n in ref["change"]:
        if ra.unread(d, n):
            assert torch.equal(got["params"][n], w[n]), n
