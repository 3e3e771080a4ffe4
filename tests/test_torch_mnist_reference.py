"""The 2-D MNIST classifier's train step (``sonet_torch``'s
``ClassifierModel`` of ``config.mnist()``, through the device pipeline's
``sample_batch`` and ``train.make_steps``) against the benchmark's plain
2-D reference (``benchmark/reference/planar.py``) on the CPU, in float32,
at a small size (B=4, N=64 of 64, M=9, k=3, som_k=4, F=64), from the same
seeded weights, raw rows and draws: the logits and the loss, the first
step's gradient of every leaf, the parameters after three Adam steps, and
a planted fault (the first layer fed the raw coordinates instead of the
decentered ones) that the comparison must catch.  No JAX here."""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, data, data_planar  # noqa: E402
from benchmark.reference import planar as rp  # noqa: E402
from sonet_torch import config, train  # noqa: E402
from sonet_torch.data.device_pipeline import DeviceData, sample_batch  # noqa: E402,E501
from sonet_torch.models import build_model  # noqa: E402

STEPS_PER_EPOCH = 3
ROWS = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
POOLINGS = ["scatter", "sorted_window"]


def setup(pooling="scatter"):
    cfg = config.mnist().replace(
        compute_dtype="float32", batch_size=4, input_pc_num=64, node_num=9,
        som_k=4, feature_num=64, pooling=pooling)
    d = dataclasses.asdict(cfg)
    w = data.weights(rp.param_specs(d), 5, "cpu")
    sp = data_planar.split({"items": 12, "points": 64, "nodes": 9,
                            "classes": 10}, 9, "cpu")
    return cfg, d, w, sp


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


@pytest.fixture
def raw_coordinates(monkeypatch):
    """The planted fault: the encoder's first PointNet reads the stacked raw
    coordinates in place of the decentered ones (on the scatter path the
    stacked points are the cloud's k copies in order)."""
    from sonet_torch.nn.encoder import Encoder
    real = Encoder.forward

    def faulty(self, pc, sn, node, *args, **kw):
        first = self.first_pointnet
        hook = first.register_forward_pre_hook(
            lambda mod, a, k: ((pc.repeat(1, self.cfg.k, 1),) + a[1:], k),
            with_kwargs=True)
        try:
            return real(self, pc, sn, node, *args, **kw)
        finally:
            hook.remove()
    monkeypatch.setattr(Encoder, "forward", faulty)


def _forward_gap(pooling, train_mode):
    """The program's and the reference's logits on one batch drawn as the
    program draws it, and the first gradients: (logits gap over the
    reference's largest logit, loss gap, worst leaf's gradient gap)."""
    cfg, d, w, sp = setup(pooling)
    raw = {k: v[:4] for k, v in sp.items()}
    batch = rp.sample(raw, torch.Generator().manual_seed(3), d, train_mode)
    assert "sn" not in batch and batch["pc"].shape == (4, 64, 2)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    model.train(train_mode)
    out, _ = model(batch["pc"], None, batch["node"], epoch=0,
                   generator=torch.Generator().manual_seed(4))
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref = rp.forward(p, d, batch, train_mode,
                     torch.Generator().manual_seed(4))
    gap = (out - ref).detach().abs().max() / ref.detach().abs().max()
    logit_gap = float(gap)
    got_loss, want_loss = rp.loss(d, out, batch), rp.loss(d, ref, batch)
    got_v, want_v = float(got_loss.detach()), float(want_loss.detach())
    loss_gap = abs(got_v - want_v) / want_v
    if not train_mode:
        return logit_gap, loss_gap, None
    got_loss.backward()
    want_loss.backward()
    ref_grad = {n: p[n].grad for n in rp.trainable(rp.param_specs(d))}
    prog_grad = {n: q.grad for n, q in model.named_parameters()}
    leaves = compare.kept_leaves(ref_grad)
    assert len(leaves) >= len(ref_grad) - 12
    return logit_gap, loss_gap, compare.leaf_gap(prog_grad, ref_grad, leaves)


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("train_mode", [True, False])
def test_logits_loss_and_gradients(pooling, train_mode, one_thread):
    logit_gap, loss_gap, grad_gap = _forward_gap(pooling, train_mode)
    # float32 sums in other orders (the program's one-hot products or
    # segment sums and gathers, the reference's scatters): read 6e-6 to
    # 1e-5 of the largest logit, 2e-7 of the loss, 1.4e-5 of the worst
    # leaf's gradient norm
    assert logit_gap < 1e-4 and loss_gap < 1e-5
    if train_mode:
        assert grad_gap < 1e-3


def test_raw_coordinates_fail_the_comparison(one_thread, raw_coordinates):
    """The planted fault moves the logits, the loss and the gradients far
    past the tolerances above, which the sound program meets with room
    (read: 1.25 of the largest logit, 0.107 of the loss, 0.30 of the worst
    leaf's gradient)."""
    logit_gap, loss_gap, grad_gap = _forward_gap("scatter", True)
    assert logit_gap > 1e-4 and loss_gap > 1e-5 and grad_gap > 1e-3


def _train(cfg, d, w, sp, steps):
    """``steps`` train steps of the program (the device pipeline's
    ``sample_batch`` over a resident 2-D split without normals, then
    ``make_steps``' train step) and of the reference on rows
    ``ROWS[:steps]``, with draws from generators of one seed."""
    state = train.init_state(cfg, device="cpu", seed=0,
                             steps_per_epoch=STEPS_PER_EPOCH)
    state.model.load_state_dict(w, strict=True)
    step, _ = train.make_steps(cfg, STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(21)
    split = DeviceData(pc=sp["pc"], sn=None, node=sp["node"],
                       label=sp["label"])
    losses, first = [], None
    for idx in ROWS[:steps]:
        batch = sample_batch(split, torch.tensor(idx), gen, cfg, train=True)
        assert "sn" not in batch
        _, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = {n: (None if p.grad is None else p.grad.clone())
                     for n, p in state.model.named_parameters()}
    ref = rp.train_steps(w, d, [{k: v[torch.tensor(r)] for k, v in sp.items()}
                                for r in ROWS[:steps]],
                         torch.Generator().manual_seed(21), STEPS_PER_EPOCH)
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    return {"grad": first, "loss": losses, "params": params}, ref


@pytest.mark.parametrize("pooling", POOLINGS)
def test_first_step_gradients(pooling, one_thread):
    cfg, d, w, sp = setup(pooling)
    got, ref = _train(cfg, d, w, sp, 1)
    # the draws are the program's: the same subset (none: N of N), jitter,
    # scale and dropout masks, so the loss to float32 rounding
    assert got["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    leaves = compare.kept_leaves(ref["grad"])
    # the leaves left out have no true gradient: a dense bias that a
    # BatchNorm cancels (None in the program)
    for n in set(ref["grad"]) - set(leaves):
        assert got["grad"][n] is None or float(got["grad"][n].norm()) < \
            1e-3 * float(ref["grad"][leaves[0]].norm()) + 1e-6, n
    # each kept leaf elementwise: float32 sums in other orders, 1e-4 of the
    # larger of its norm and the median leaf's at most
    med = float(torch.tensor([float(ref["grad"][n].norm())
                              for n in leaves]).median())
    for n in leaves:
        diff = float((got["grad"][n] - ref["grad"][n]).norm())
        assert diff < 1e-3 * max(float(ref["grad"][n].norm()), med), n


def test_parameters_after_three_adam_steps(one_thread):
    cfg, d, w, sp = setup()
    got, ref = _train(cfg, d, w, sp, 3)
    # Adam's first update moves each weight by about lr x the sign of its
    # gradient, so an entry whose gradient lies within round-off of 0 moves
    # either way and the two runs part after one step: the first loss to
    # float32 rounding, the later ones to 1e-2 (2.5e-4 read), and each
    # leaf's change by its norm to 0.1 (0.003 read; a state left unchanged
    # reads 1)
    assert got["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    for g, r in zip(got["loss"][1:], ref["loss"][1:]):
        assert g == pytest.approx(r, rel=1e-2)
    leaves = compare.kept_leaves(ref["grad"])
    change = {n: got["params"][n] - w[n] for n in leaves}
    gaps = compare.leaf_gaps(change, ref["change"], leaves)
    assert max(gaps.values()) < 0.1, max(gaps, key=gaps.get)
