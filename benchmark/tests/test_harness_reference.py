"""The plain reference against the program (``sonet_torch``) on the CPU at
a tiny size in float32: the same weights, batch and random draws give the
same outputs, gradients and first training steps.  (This test may import
both; the reference itself imports nothing of the program.)"""

import dataclasses

import pytest
import torch

from benchmark import compare, data
from benchmark.reference import model as rm, train as rt
from benchmark.reference.precision import Precision


def setup(task):
    from sonet_torch.config import modelnet40, shapenetpart
    base = modelnet40() if task == "classify" else shapenetpart()
    cfg = base.replace(compute_dtype="float32", batch_size=4,
                       input_pc_num=96, node_num=16, feature_num=64)
    d = dataclasses.asdict(cfg)
    w = data.weights(rm.param_specs(d), 5, "cpu")
    sp = data.split({"items": 8, "points": 192, "nodes": 16,
                     "classes": 40 if task == "classify" else 16,
                     "parts": task == "segment"}, 9, "cpu")
    return cfg, d, w, sp


def port_forward(cfg, w, batch, train, gen):
    from sonet_torch.models import build_model
    model = build_model(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    model.train(train)
    args = [batch["pc"], batch["sn"], batch["node"]]
    if cfg.task == "segment":
        args.append(batch["label"])
    out, _ = model(*args, epoch=0, generator=gen)
    return model, out


@pytest.mark.parametrize("task", ["classify", "segment"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_and_gradients(task, train):
    cfg, d, w, sp = setup(task)
    raw = {k: v[:4] for k, v in sp.items()}
    batch = rt.sample(raw, torch.Generator().manual_seed(3), d, train)
    model, out = port_forward(cfg, w, batch, train,
                              torch.Generator().manual_seed(4))
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref = rm.forward(p, d, batch, train, torch.Generator().manual_seed(4))
    torch.testing.assert_close(out.float(), ref, rtol=1e-4, atol=1e-4)
    if not train:
        return
    rm.loss(d, out, batch).backward()
    rm.loss(d, ref, batch).backward()
    ref_grad = {n: p[n].grad for n in rm.trainable(rm.param_specs(d))}
    prog_grad = {n: q.grad for n, q in model.named_parameters()}
    leaves = compare.kept_leaves(ref_grad)
    assert len(leaves) >= len(ref_grad) - 12
    # float32 sums in other orders (the program's one-hot products and
    # gathers, the reference's scatters): 1e-4 to 3e-4 of a leaf's norm
    assert compare.leaf_gap(prog_grad, ref_grad, leaves) < 1e-3


def test_float8_control_departs():
    cfg, d, w, sp = setup("classify")
    batch = rt.sample({k: v[:4] for k, v in sp.items()},
                      torch.Generator().manual_seed(3), d, False)
    ref = rt.serve(w, d, batch)
    ctl = rt.serve(w, d, batch, prec=Precision("float8"))
    assert 1e-2 < compare.logit_gap(ctl, ref) < 1.0
    assert compare.logit_gap(ref, ref) == 0.0


def test_train_steps_follow_the_program():
    from sonet_torch.data.device_pipeline import DeviceData, sample_batch
    from sonet_torch.train import init_state, make_steps
    cfg, d, w, sp = setup("classify")
    state = init_state(cfg, device="cpu", steps_per_epoch=2)
    state.model.load_state_dict(w, strict=True)
    step, _ = make_steps(cfg, 2)
    gen = torch.Generator().manual_seed(21)
    split = DeviceData(pc=sp["pc"], sn=sp["sn"], node=sp["node"],
                       label=sp["label"])
    rows = [torch.tensor([0, 1, 2, 3]), torch.tensor([4, 5, 6, 7])]
    losses = []
    for idx in rows:
        _, m = step(state, sample_batch(split, idx, gen, cfg, train=True),
                    gen)
        losses.append(float(m["loss"]))
    ref = rt.train_steps(w, d, [{k: v[i] for k, v in sp.items()}
                                for i in rows],
                         torch.Generator().manual_seed(21), 2)
    assert losses[0] == pytest.approx(ref["loss"][0], rel=1e-5)
    assert losses[1] == pytest.approx(ref["loss"][1], rel=1e-2)


def test_learning_rate_halving():
    d = {"lr": 1e-3, "lr_decay_step": 20, "lr_decay_ratio": 0.5,
         "lr_clip": 1e-5}
    assert rt.learning_rate(d, 0, 10) == 1e-3
    assert rt.learning_rate(d, 10 * 20, 10) == 1e-3     # epoch 20
    assert rt.learning_rate(d, 10 * 21, 10) == 5e-4     # epoch 21
