"""The port's CUDA kernels on the card.  Every test here is marked
``cuda`` and skips on a host without one; the file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the edge cases it holds the kernel to)
from sonet_torch import config, train
from sonet_torch.models import build_model
from sonet_torch.nn import layers as nn_layers
from sonet_torch import ops as seg_ops
from sonet_torch.ops import segment as seg
from sonet_torch.ops.cuda import batchnorm_act as bna
from sonet_torch.ops.cuda import adam_step as adam
from sonet_torch.ops.cuda import segment_argmax as sam
from sonet_torch.ops.cuda import segment_max_grad as smg
from sonet_torch.ops.cuda import segment_max_window as smw
from sonet_torch.ops.cuda import segment_sums as ss
from sonet_torch.ops.cuda import sorts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bulk_kernel_on_two_tiles(cuda_device, dtype):
    # the smallest input that refills nothing and still crosses a tile
    rows = 2 * (24576 // (384 * torch.empty(0, dtype=dtype).element_size()))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((1, rows, 384), generator=gen,
                       device=cuda_device).to(dtype)
    ids = torch.sort(torch.randint(0, 4, (1, rows), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values
    assert smw.kernel_path(data) == "bulk"
    got = smw.windowed_vals(data, ids, 4)
    torch.cuda.synchronize()
    assert bool((got == smw.windowed_vals_plain(data, ids, 4)).all())


def test_kernel_edge_cases_equal_plain(cuda_device):
    """One node a cloud, N below and at a multiple of a tile, more blocks
    than tiles, unsorted and out-of-range ids on the bulk kernel, run,
    tile and cloud boundaries that meet, zeros of both signs and -inf,
    unaligned views: each on the kernel its shape names, each ``==``."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    failed = []
    for name, data, ids, m, path in chip_smoke.kernel1_cases(
            torch, gen, cuda_device):
        assert smw.kernel_path(data) == path, name
        got = smw.windowed_vals(data, ids, m)
        torch.cuda.synchronize()
        if not bool((got == smw.windowed_vals_plain(data, ids, m)).all()):
            failed.append(name)
    assert not failed


def test_kernel_equals_plain_at_b64(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((64, 15000, 384), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ids = torch.sort(torch.randint(0, 64, (64, 15000), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values
    assert smw.kernel_path(data) == "bulk"
    got = smw.windowed_vals(data, ids, 64)
    torch.cuda.synchronize()
    for b in range(0, 64, 8):
        want = smw.windowed_vals_plain(data[b:b + 8], ids[b:b + 8], 64)
        assert bool((got[b:b + 8] == want).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sorted_ids", [((2, 1000, 96), False),
                                              ((3, 1001, 33), True),
                                              ((8, 15000, 384), True)])
def test_kernel_equals_plain(cuda_device, dtype, shape, sorted_ids):
    B, N, C = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    ids = torch.randint(0, 70, (B, N), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    if sorted_ids:
        ids = torch.sort(ids, dim=1).values
    before = smw.windowed_vals.launches
    got = smw.windowed_vals(data, ids, 64)       # ids >= 64 are ignored
    torch.cuda.synchronize()
    assert smw.windowed_vals.launches == before + 1
    want = smw.windowed_vals_plain(data, ids, 64)
    assert bool((got == want).all())             # -0.0 == 0.0


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    data = torch.zeros(2, 8, 4, device=cuda_device)
    ids = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        smw.windowed_vals(data, ids.long(), 3)
    with pytest.raises(TypeError):
        smw.windowed_vals(data.half(), ids, 3)
    with pytest.raises(ValueError):
        smw.windowed_vals(data.transpose(1, 2), ids[:, :4], 3)
    with pytest.raises(ValueError):
        smw.windowed_vals(data, ids.cpu(), 3)


def test_model_on_card_matches_cpu(cuda_device):
    cfg = config.tiny_test()
    rs = np.random.RandomState(0)
    pc = rs.randn(4, 64, 3).astype(np.float32)
    sn = rs.randn(4, 64, 3).astype(np.float32)
    node = pc[:, :16] + 0.1 * rs.randn(4, 16, 3).astype(np.float32)
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device=cuda_device, seed=0)
    before = smw.windowed_vals.launches
    with torch.no_grad():
        want, _ = cpu(*(torch.from_numpy(a) for a in (pc, sn, node)))
        got, _ = gpu(*(torch.from_numpy(a).to(cuda_device)
                       for a in (pc, sn, node)))
    assert smw.windowed_vals.launches == before + 1
    # float32 on both; cuBLAS sums in another order than the CPU
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# kernel 2: segment_argmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,M,sorted_ids", [((2, 1000, 96), 16, False),
                                                ((3, 1001, 33), 16, True),
                                                ((2, 500, 128), 20, False),
                                                ((8, 15000, 384), 64, True)])
def test_argmax_kernel_equals_plain(cuda_device, shape, M, sorted_ids):
    B, N, C = shape
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    data = torch.randn(shape, generator=gen, device=cuda_device)
    ids = torch.randint(0, M - 2, (B, N), generator=gen, device=cuda_device,
                        dtype=torch.int32)            # the last two nodes empty
    ids[:, ::97] = M + 5                              # ignored ids
    if sorted_ids:
        ids = torch.sort(ids, dim=1).values
    # planted exact ties: each of a few rows copied onto a later row of
    # the same node, and a row of zeros of both signs
    for n in range(0, N - 1, 211):
        data[:, n + 1] = data[:, n]
        ids[:, n + 1] = ids[:, n]
    data[:, 3] = 0.0
    data[:, 4] = -0.0
    before = sam.segment_argmax.launches
    got = sam.segment_argmax(data, ids, M)
    torch.cuda.synchronize()
    assert sam.segment_argmax.launches == before + 1
    want = sam.segment_argmax_plain(data, ids, M)
    assert bool((got == want).all())
    assert bool((got[:, M - 2:] == 0).all())
    # the values behind the indices are kernel 1's maxima on non-empty nodes
    vals = torch.gather(data, 1, got.long())
    ref = smw.windowed_vals(data, ids, M)
    full = ref > -3e38
    assert bool((vals[full] == ref[full]).all())


def test_argmax_kernel_rejects_what_it_does_not_take(cuda_device):
    data = torch.zeros(2, 8, 4, device=cuda_device)
    ids = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        sam.segment_argmax(data, ids.long(), 3)
    with pytest.raises(TypeError):
        sam.segment_argmax(data.bfloat16(), ids, 3)
    with pytest.raises(ValueError):
        sam.segment_argmax(data.transpose(1, 2), ids[:, :4], 3)
    with pytest.raises(ValueError):
        sam.segment_argmax(data, ids.cpu(), 3)


# ---------------------------------------------------------------------------
# the train step on the card
# ---------------------------------------------------------------------------

def _tiny_batch(cfg, device, seed=0):
    rs = np.random.RandomState(seed)
    B, N, M = 4, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    batch = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
             "node": pc[:, :M] + 0.1 * rs.randn(B, M, 3).astype(np.float32),
             "label": rs.randint(0, cfg.classes, B)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().cpu() for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    # float32 on both sides, summed in another order: 1e-3 of the
    # tensor's largest entry, plus 1e-6 for noise-level gradients
    for n, w in want.items():
        tol = 1e-3 * float(w.abs().max()) + 1e-6
        err = float((got[n] - w).abs().max())
        assert err <= tol, (n, err, tol)


def test_train_step_on_card_matches_cpu(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config.tiny_test().replace(dropout=0.0, batch_size=4)
    states, metrics = {}, {}
    step, _ = train.make_classify_steps(cfg, steps_per_epoch=10)
    for dev in ("cpu", cuda_device):
        state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=10)
        before = smw.windowed_vals.launches
        states[str(dev)], metrics[str(dev)] = step(
            state, _tiny_batch(cfg, dev), None)
        launched = smw.windowed_vals.launches - before
        assert launched == (1 if dev == cuda_device else 0)
    cpu, card = states["cpu"], states[str(cuda_device)]
    # one float32 step: the same arithmetic, summed in another order
    torch.testing.assert_close(metrics[str(cuda_device)]["loss"].cpu(),
                               metrics["cpu"]["loss"], rtol=1e-4, atol=1e-5)
    _assert_grads_close(_grads(card.model), _grads(cpu.model))
    # Adam turns a noise-level gradient of either sign into a step of
    # +-lr, so no bound on the largest difference can fail: almost every
    # parameter must be within 0.1 lr
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel()
                       for a, b in zip(card.model.parameters(),
                                       cpu.model.parameters())])
    assert float((diffs > 0.1 * cfg.lr).float().mean()) <= 2e-3


def test_first_pointnet_gradient_through_kernel(cuda_device):
    """The pooling kernel has a backward: first_pointnet's gradients on
    the kernel path are non-zero and equal the scatter path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config.tiny_test().replace(dropout=0.0, batch_size=4)
    grads = {}
    for pooling in ("sorted_window", "scatter"):
        c = cfg.replace(pooling=pooling)
        model = build_model(c, device=cuda_device, seed=0).train()
        batch = _tiny_batch(c, cuda_device)
        score, _ = model(batch["pc"], batch["sn"], batch["node"], epoch=0)
        train.losses.cross_entropy(score, batch["label"]).backward()
        grads[pooling] = {n: g for n, g in _grads(model).items()
                          if n.startswith("encoder.first_pointnet.")}
    kernel, scatter = grads["sorted_window"], grads["scatter"]
    w = "encoder.first_pointnet.PointLayer_0.Dense_0.weight"
    assert float(kernel[w].abs().max()) > 1e-3
    _assert_grads_close(kernel, scatter)


# ---------------------------------------------------------------------------
# the part segmenter, its gathers and the run round trip on the card
# ---------------------------------------------------------------------------

def _seg_cfg(**over):
    return config.tiny_test().replace(task="segment", classes=50,
                                      batch_size=4, **over)


def _seg_batch(cfg, device, seed=0):
    rs = np.random.RandomState(seed)
    B, N, M = 4, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    batch = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
             "node": pc[:, :M] + 0.1 * rs.randn(B, M, 3).astype(np.float32),
             "label": rs.randint(0, 16, B).astype(np.int32),
             "seg": rs.randint(0, cfg.classes, (B, N))}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathers_on_card_match_cpu(cuda_device, dtype):
    """``permute_points`` exactly; ``gather_by_segment`` forward exactly
    and its backward within one bf16 spacing (float32: 1e-5): a float32
    sum over a node's ~50 rows in another order, rounded once."""
    from sonet_torch.ops import gather_by_segment, one_hot, permute_points
    rs = np.random.RandomState(0)
    B, N, M, C = 2, 400, 8, 64
    ids = np.sort(rs.randint(0, M, (B, N)), axis=1).astype(np.int32)
    perm = np.stack([rs.permutation(N) for _ in range(B)]).astype(np.int32)
    inv = np.argsort(perm, axis=1).astype(np.int32)
    table = rs.randn(B, M, C).astype(np.float32)
    x = rs.randn(B, N, C).astype(np.float32)
    g = rs.randn(B, N, C).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        t = lambda a: torch.from_numpy(a).to(dev)            # noqa: E731
        tab = t(table).requires_grad_()
        pts = t(x).to(dtype).requires_grad_()
        rows = gather_by_segment(tab, t(ids), one_hot(t(ids), M, dtype))
        moved = permute_points(pts, t(perm), t(inv))
        rows.backward(t(g).to(dtype))
        moved.backward(t(g).to(dtype))
        out[str(dev)] = [a.detach().float().cpu()
                         for a in (rows, moved, pts.grad, tab.grad)]
    for got, want in list(zip(out[str(cuda_device)], out["cpu"]))[:3]:
        assert torch.equal(got, want)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out[str(cuda_device)][3], out["cpu"][3],
                               rtol=tol, atol=1e-5)


def test_segmenter_on_card_matches_cpu(cuda_device):
    cfg = _seg_cfg()
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device=cuda_device, seed=0)
    names = ("pc", "sn", "node", "label")
    before = smw.windowed_vals.launches
    with torch.no_grad():
        want, _ = cpu(*(_seg_batch(cfg, "cpu")[n] for n in names))
        got, enc = gpu(*(_seg_batch(cfg, cuda_device)[n] for n in names))
    assert smw.windowed_vals.launches == before + 1
    assert enc.inv_perm is not None                  # the sorted pipeline
    assert got.shape == (4, cfg.input_pc_num, 50)
    # float32 on both; cuBLAS sums in another order than the CPU
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_captured_segment_eval_step_equals_eager(cuda_device):
    """The segmenter's eval step, IoU included, as a captured graph (the
    ``Trainer``'s eval on a card): its part table reaches the card before
    the capture, which may not copy from pageable host memory."""
    from sonet_torch.train.graphs import StepGraph
    cfg = _seg_cfg()
    state = train.init_state(cfg, device=cuda_device, seed=0)
    _, eval_step = train.make_steps(cfg, 1)
    batch = _seg_batch(cfg, cuda_device)
    graph = StepGraph(lambda **b: eval_step(state, b), cuda_device)
    got = {k: v.clone() for k, v in graph(**batch).items()}
    want = eval_step(state, batch)
    assert graph.captures == 1 and graph.replays == 1
    assert torch.equal(got["iou_i"], want["iou_i"])
    assert torch.equal(got["loss"], want["loss"])


def test_segment_train_step_on_card_matches_cpu(cuda_device):
    """One float32 train step: the loss, one kernel launch, a gradient for
    every trainable tensor.  The gradients themselves are compared under
    the running statistics.  With batch statistics the segmenter's
    gradient is no continuous function of its inputs: a relative change
    of 2e-7 in the weights, the size of float32 rounding, flips ReLUs and
    pooling winners that BatchNorm has centred on zero and moves single
    gradients by up to 18% of a tensor's largest entry on the CPU alone
    (``tools/torch_grad_sensitivity.py``, which shares this batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _seg_cfg(dropout=0.0)
    step, _ = train.make_steps(cfg, steps_per_epoch=10)
    metrics, grads = {}, {}
    for dev in ("cpu", cuda_device):
        state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=10)
        batch = _seg_batch(cfg, dev)
        model = state.model.eval()               # running statistics
        score, _ = model(*(batch[n] for n in ("pc", "sn", "node", "label")),
                         epoch=0)
        train.losses.cross_entropy_seg(score, batch["seg"]).backward()
        grads[str(dev)] = _grads(model)
        before = smw.windowed_vals.launches
        state, metrics[str(dev)] = step(state, batch, None)
        assert smw.windowed_vals.launches - before == (
            1 if dev == cuda_device else 0)
        stopped = chip_smoke._no_gradient(model, cfg)
        assert all((p.grad is None) == (n in stopped)
                   for n, p in model.named_parameters())
    torch.testing.assert_close(metrics[str(cuda_device)]["loss"].cpu(),
                               metrics["cpu"]["loss"], rtol=1e-4, atol=1e-5)
    _assert_grads_close(grads[str(cuda_device)], grads["cpu"])
    w = "segmenter.layer1.Dense_0.weight"
    assert float(grads[str(cuda_device)][w].abs().max()) > 1e-4


def test_run_round_trip_on_card(cuda_device, tmp_path):
    """A run written on the card restores bit for bit onto the card and
    onto the CPU, Adam's moments beside their parameters and its step
    counters where a live optimizer keeps them; ``from_run`` answers as
    ``from_model``; ``restore_encoder`` sets only ``encoder.*``."""
    from sonet_torch.serving import ServingEngine
    cfg = _seg_cfg(dropout=0.6)
    step, _ = train.make_steps(cfg, steps_per_epoch=10)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    batch = _seg_batch(cfg, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    cfg.save(str(tmp_path / "config.json"))
    path = train.save_checkpoint(str(tmp_path / "ckpt"), state, state.step)
    for dev in (cuda_device, "cpu"):
        fresh = train.restore_checkpoint(path, train.init_state(
            cfg, device=dev, seed=9))
        assert fresh.step == 2
        for k, v in state.model.state_dict().items():
            r = fresh.model.state_dict()[k]
            assert r.device.type == torch.device(dev).type, k
            assert torch.equal(r.cpu(), v.cpu()), k
        want = state.optimizer.state_dict()["state"]
        got = fresh.optimizer.state_dict()["state"]
        assert list(got) == list(want)
        for i, entry in want.items():
            for name, t in entry.items():
                r = got[i][name]
                assert torch.equal(r.cpu(), t.cpu()), (i, name)
                where = "cpu" if name == "step" else torch.device(dev).type
                assert r.device.type == where, (i, name)
    # the restored state trains on as the original does
    twin = train.restore_checkpoint(path, train.init_state(
        cfg, device=cuda_device, seed=9))
    losses = [float(step(s, batch, torch.Generator(
        device=cuda_device).manual_seed(5))[1]["loss"]) for s in (state, twin)]
    assert losses[0] == losses[1]

    req = {k: v.cpu().numpy() for k, v in batch.items() if k != "seg"}
    a = ServingEngine.from_run(str(tmp_path), device=cuda_device).predict(req)
    b = ServingEngine.from_model(fresh.model.to(cuda_device), cfg,
                                 device=cuda_device).predict(req)
    assert a.shape == (4, cfg.input_pc_num, 50) and np.array_equal(a, b)

    cls_state = train.init_state(config.tiny_test(), device=cuda_device,
                                 seed=3)
    cls_path = train.save_checkpoint(str(tmp_path / "cls"), cls_state, 0)
    before = {k: v.clone() for k, v in twin.model.state_dict().items()}
    train.restore_encoder(cls_path, twin)
    for k, v in twin.model.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(v, cls_state.model.state_dict()[k]), k
        else:
            assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the autoencoder and the SOM on the card
# ---------------------------------------------------------------------------

def _true_float32_on_card():
    """Float32 products and convolutions on the card as on the CPU: cuDNN
    takes TF32 for float32 convolutions unless told not to, which moves
    the decoder's output by 1e-3 of its largest coordinate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ae_batch(cfg, device, seed=0):
    """Clouds on squeezed spheres, with SOM nodes fitted on ``device``."""
    from sonet_torch import som
    rs = np.random.RandomState(seed)
    u = rs.randn(4, cfg.input_pc_num, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pc = (u * rs.uniform(0.4, 1.0, (4, 1, 3))).astype(np.float32)
    node = som.fit(pc, som.SOMConfig(cfg.rows, cfg.cols, 3), device=device)
    return {"pc": torch.from_numpy(pc).to(device),
            "sn": torch.from_numpy(u.astype(np.float32)).to(device),
            "node": node}


def test_autoencoder_on_card_matches_cpu(cuda_device):
    _true_float32_on_card()
    cfg = config.tiny_test().replace(task="autoencode")
    batch = _ae_batch(cfg, cuda_device)
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device=cuda_device, seed=0)
    before = smw.windowed_vals.launches
    with torch.no_grad():
        want, _ = cpu(*(batch[k].cpu() for k in ("pc", "sn", "node")))
        got, _ = gpu(*(batch[k] for k in ("pc", "sn", "node")))
    assert smw.windowed_vals.launches == before + 1
    assert got.pc.shape == (4, 16 + 1024, 3) and got.conv_pc6 is None
    # float32 on both; cuBLAS and cuDNN sum in another order than the
    # CPU: 1e-4 of each tap's largest coordinate
    for name in ("pc", "linear_pc", "conv_pc4", "conv_pc5"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(got, name).cpu(), w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))


def test_autoencode_train_step_on_card_matches_cpu(cuda_device):
    """One float32 train step: the Chamfer loss and its parts, and every
    gradient.  The gradients are taken from a forward with the running
    statistics, just before the step, where they do not hang on the order
    of the statistics' sums (``chip_smoke.py`` holds the train-mode
    gradients on its own batch)."""
    _true_float32_on_card()
    cfg = config.tiny_test().replace(task="autoencode", dropout=0.0,
                                     batch_size=4)
    step, _ = train.make_steps(cfg, steps_per_epoch=10)
    card_batch = _ae_batch(cfg, cuda_device)
    grads, metrics = {}, {}
    for dev in ("cpu", cuda_device):
        state = train.init_state(cfg, device=dev, seed=0, steps_per_epoch=10)
        batch = {k: v.to(dev) for k, v in card_batch.items()}
        dec, _ = state.model.eval()(batch["pc"], batch["sn"], batch["node"])
        train.loops._ae_loss(cfg, dec, batch["pc"])[0].backward()
        grads[str(dev)] = _grads(state.model)
        before = smw.windowed_vals.launches
        _, metrics[str(dev)] = step(state, batch, None)
        launched = smw.windowed_vals.launches - before
        assert launched == (1 if dev == cuda_device else 0)
    # the train step's loss and its parts, with batch statistics over 4
    # clouds: 1e-4 of max(1, the value)
    for k, want in metrics["cpu"].items():
        torch.testing.assert_close(metrics[str(cuda_device)][k].cpu(), want,
                                   rtol=1e-4, atol=1e-4)
    _assert_grads_close(grads[str(cuda_device)], grads["cpu"])
    w = "decoder.conv_decoder.UpConv_0.Conv_0.weight"
    assert float(grads[str(cuda_device)][w].abs().max()) > 1e-5


@pytest.mark.parametrize("schedule", ["prep", "online"])
def test_som_fit_on_card_matches_cpu(cuda_device, schedule):
    from sonet_torch import som
    rs = np.random.RandomState(3)
    u = rs.randn(8, 1024, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    x = torch.from_numpy((u * rs.uniform(0.4, 1.0, (8, 1, 3)))
                         .astype(np.float32))
    cfg = som.SOMConfig(8, 8, 3, schedule=schedule)
    init = som.init_nodes(cfg, 8, device="cpu")
    one_cpu = som.batch_update(init, x, 0.5, 0.4, cfg)
    one_card = som.batch_update(init.to(cuda_device), x.to(cuda_device), 0.5,
                                0.4, cfg)
    # float32 sums over a node's points taken in another order
    torch.testing.assert_close(one_card.cpu(), one_cpu, rtol=0, atol=1e-5)

    def qe(points, nodes):
        d = (points[:, :, None, :] - nodes[:, None, :, :]).norm(dim=-1)
        return float(d.min(-1).values.mean())

    on_cpu = som.fit(x, cfg, device="cpu")
    on_card = som.fit(x, cfg, device=cuda_device)
    assert on_card.is_cuda and on_card.shape == (8, 64, 3)
    # a fit can amplify rounding (a changed winner moves later winners),
    # so the whole fit is held by what it is for, within 1%
    assert abs(qe(x, on_card.cpu()) - qe(x, on_cpu)) <= 1e-2 * qe(x, on_cpu)
    assert qe(x, on_card.cpu()) < 0.8 * qe(x, init)
    # true float32 whatever the matmul switch says
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with_tf32 = som.fit(x, cfg, device=cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(with_tf32, on_card)


# ---------------------------------------------------------------------------
# point dropout, retrieval ranking and the Trainer on the card
# ---------------------------------------------------------------------------

def test_random_point_dropout_on_a_cuda_generator(cuda_device):
    N, lower = 5000, 0.8
    pc = torch.arange(2 * N * 3, dtype=torch.float32,
                      device=cuda_device).reshape(2, N, 3)
    outs = []
    for _ in range(2):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        out_pc, out_sn = train.random_point_dropout(pc, -pc, gen, lower)
        outs.append(out_pc)
        assert out_pc.is_cuda and out_pc.shape == pc.shape
        torch.testing.assert_close(out_sn, -out_pc, rtol=0, atol=0)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    idx = (outs[0][0, :, 0] / 3).long().cpu()   # the source row of each slot
    keep = len(set(idx.tolist()))
    assert round(lower * N) - 1 <= keep < N
    assert set(idx[keep:].tolist()) <= set(idx[:keep].tolist())
    torch.testing.assert_close(outs[0][1] - outs[0][0],
                               torch.full((N, 3), 3.0 * N,
                                          device=cuda_device), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["grid", "normal"])
def test_rank_all_on_card_equals_cpu(cuda_device, kind):
    """Grid scores: every squared distance exact on both devices, so the
    distances differ by the square root's last bit at most and duplicate
    rows are true ties.  Normal scores: the squared distances within the
    float32 rounding of |a|^2 + |b|^2 - 2 a.b, C eps (|a|^2 + |b|^2), on
    each side."""
    from sonet_torch import retrieval
    rs = np.random.RandomState(0)
    if kind == "grid":
        s = rs.randint(-16, 17, (200, 55)).astype(np.float32) / 8
        s[100:120] = s[:20]                                  # exact ties
    else:
        s = (5 * rs.randn(200, 55)).astype(np.float32)
    want = retrieval.rank_all(s)
    got = retrieval.rank_all(torch.from_numpy(s).to(cuda_device))
    n2 = (s.astype(np.float64) ** 2).sum(1)
    eps = float(np.finfo(np.float32).eps)
    for q, ((gi, gd), (wi, wd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi)
        if kind == "grid":
            np.testing.assert_allclose(gd, wd, rtol=2 * eps, atol=0)
        else:
            bound = 2 * 55 * eps * (n2[q] + n2[gi])
            diff = np.abs(gd.astype(np.float64) ** 2
                          - wd.astype(np.float64) ** 2)
            assert (diff <= bound).all(), q


def test_trainer_on_card(cuda_device, tmp_path):
    from sonet_torch import retrieval
    from sonet_torch.train.trainer import Trainer
    cfg = config.tiny_test().replace(
        checkpoints_dir=str(tmp_path), name="card",
        random_pc_dropout_lower_limit=0.8)
    t = Trainer(cfg, quiet=True, resume=False, device=cuda_device)
    assert t.train_set.som_node.shape == (64, 16, 3)
    before = smw.windowed_vals.launches
    metrics = t.fit(epochs=1)
    # captured steps: a warm-up and a capture of the train step and of the
    # eval step, then a replay a train step and an eval batch (16 + 4)
    assert smw.windowed_vals.launches - before == 4
    assert (t.train_graph.replays, t.eval_graph.replays) == (16, 4)
    assert t.evaluate() == t.evaluate() == metrics
    assert t.state.step == 16 and np.isfinite(metrics["loss"])
    assert all(p.is_cuda for p in t.model.parameters())
    t.request_stop()
    t.fit(epochs=1)
    t2 = Trainer(cfg, quiet=True, device=cuda_device)
    assert t2.state.step == 17
    a, b = t.model.state_dict(), t2.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    scores, labels, ids = retrieval.extract_scores(
        t.eval_step, t.state, t.test_loader, t._pinned_batch)
    assert scores.shape == (16, cfg.classes) and np.isfinite(scores).all()


# ---------------------------------------------------------------------------
# the device-resident pipeline's captured steps
# ---------------------------------------------------------------------------

def _device_trainer(tmp_path, device, name, **over):
    from sonet_torch.train.trainer import Trainer
    cfg = config.tiny_test().replace(
        checkpoints_dir=str(tmp_path), name=name, input_pipeline="device",
        random_pc_dropout_lower_limit=0.8, **over)
    return Trainer(cfg, quiet=True, resume=False, device=device)


def test_captured_train_step_equals_eager(cuda_device, tmp_path):
    """Float32 here: the replay runs the eager step's kernels on the same
    inputs, so loss and update agree to float32 rounding."""
    t = _device_trainer(tmp_path, cuda_device, "cap")
    assert all(g["capturable"] for g in t.state.optimizer.param_groups)
    captures = t.train_graph.captures
    eager, graph, rel = chip_smoke.captured_and_eager_step(t)
    assert t.train_graph.captures == captures + 1
    assert graph == pytest.approx(eager, rel=1e-5, abs=1e-6)
    assert rel < 1e-3


def test_captured_step_follows_the_epoch(cuda_device, tmp_path):
    """lr halves and the BatchNorm momentum decays every epoch here: a graph
    that kept an earlier epoch's values would move the weights by twice
    the eager step's update and the running statistics by another
    momentum."""
    t = _device_trainer(tmp_path, cuda_device, "epochs", lr_decay_step=1,
                        bn_momentum_decay_step=1)
    for epoch in range(2):
        t.train_epoch(epoch)
    assert t.train_graph.captures == 2       # epoch 0's key and epoch 1's
    eager, graph, rel = chip_smoke.captured_and_eager_step(t)
    keys = [t._keys[e] for e in range(3)]
    assert t.train_graph.captured_key == keys[2] != keys[1] != keys[0]
    assert keys[2][0] == tuple(t.cfg.lr / 2 for _ in keys[2][0])
    assert all(m == pytest.approx(0.1 * 0.6 ** 2) for m in keys[2][1])
    assert graph == pytest.approx(eager, rel=1e-5, abs=1e-6)
    assert rel < 1e-3


def test_captured_replays_draw_anew_as_eager_steps_do(cuda_device):
    """Two replays of a captured sampling step on the same rows draw other
    subsamples and augmentations, and the same ones as two eager calls
    from the same generator state."""
    from sonet_torch.data import device_pipeline as dp
    from sonet_torch.train.graphs import EpochGraph
    cfg = config.tiny_test().replace(input_pc_num=64, rot_horizontal=True,
                                     rot_perturbation=True,
                                     translation_perturbation=True)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.Generator(device="cpu").manual_seed(0)
    data = dp.DeviceData(
        pc=torch.randn((6, 200, 3), generator=g).to(cuda_device),
        sn=torch.randn((6, 200, 3), generator=g).to(cuda_device),
        node=torch.randn((6, cfg.node_num, 3), generator=g).to(cuda_device),
        label=torch.arange(6).to(cuda_device))

    def step(d, idx):
        b = dp.sample_batch(d, idx, gen, cfg, train=True)
        return {"pc": b["pc"], "node": b["node"], "sn": b["sn"]}

    table = np.array([[0, 1, 2, 3]] * 2)
    state = gen.get_state()
    graph = EpochGraph(step, cuda_device, generators=(gen,))
    got = graph.run(data, table)
    assert graph.captures == 1 and graph.replays == 2
    gen.set_state(state)
    want = [step(data, torch.from_numpy(r).to(cuda_device)) for r in table]
    for k in got:
        assert not np.array_equal(got[k][0], got[k][1]), k
        for i in range(2):
            np.testing.assert_array_equal(got[k][i], want[i][k].cpu().numpy())


def test_captured_replays_are_device_rows_of_their_range(cuda_device):
    """Under a profiler that records CUDA, each replay of a captured epoch
    gives one device row ``sonet:EpochGraph.replay``, and the rows follow
    one another without overlapping."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sonet_torch.data import device_pipeline as dp
    from sonet_torch.train.graphs import REPLAY, EpochGraph
    cfg = config.tiny_test().replace(input_pc_num=64)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.Generator(device="cpu").manual_seed(0)
    data = dp.DeviceData(
        pc=torch.randn((6, 200, 3), generator=g).to(cuda_device),
        sn=torch.randn((6, 200, 3), generator=g).to(cuda_device),
        node=torch.randn((6, cfg.node_num, 3), generator=g).to(cuda_device),
        label=torch.arange(6).to(cuda_device))

    def step(d, idx):
        b = dp.sample_batch(d, idx, gen, cfg, train=True)
        return {"pc": b["pc"].sum(), "sn": b["sn"].sum()}

    table = np.array([[0, 1, 2, 3]] * 4)
    graph = EpochGraph(step, cuda_device, generators=(gen,))
    graph.run(data, table)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.run(data, table)
    assert graph.captures == 1 and graph.replays == 8
    rows = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and e.name() == REPLAY)
    assert len(rows) == len(table)
    assert all(e > s for s, e in rows)
    assert all(a[1] <= b[0] for a, b in zip(rows, rows[1:]))


def test_device_pipeline_trainer_on_card(cuda_device, tmp_path):
    """A device-pipeline run: kernel 1 launched only by warm-ups and
    captures, the epoch replayed; eval twice to the same bits; the run
    restored bit for bit into a host-pipeline Trainer, and a host run into
    a device-pipeline one; chunked training equal to resident bit for
    bit."""
    from sonet_torch.train.trainer import Trainer
    t = _device_trainer(tmp_path, cuda_device, "dev")
    before = smw.windowed_vals.launches
    metrics = t.fit(epochs=1)
    # a warm-up and a capture of the train step and of the eval step
    assert smw.windowed_vals.launches - before == 4
    assert (t.train_graph.replays, t.eval_graph.replays) == (16, 4)
    assert t.state.step == 16 and np.isfinite(metrics["loss"])
    assert t.evaluate() == t.evaluate() == metrics
    t._save()
    host = Trainer(t.cfg.replace(input_pipeline="host"), quiet=True,
                   device=cuda_device)
    assert host.state.step == 16
    # every pipeline's steps are captured on a card
    assert all(g["capturable"] for g in host.state.optimizer.param_groups)
    a, b = t.model.state_dict(), host.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = t.state.optimizer.state, host.state.optimizer.state
    for pa, pb in zip(t.model.parameters(), host.model.parameters()):
        assert set(sa.get(pa, {})) == set(sb.get(pb, {}))
        for k, v in sa.get(pa, {}).items():
            assert torch.equal(v.cpu(), sb[pb][k].cpu()), k
    host.fit(epochs=1)
    back = Trainer(t.cfg, quiet=True, device=cuda_device)
    assert back.state.step == 32
    a, b = host.model.state_dict(), back.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    chunked = _device_trainer(tmp_path, cuda_device, "chunked",
                              device_budget_gb=2e-6)
    assert chunked.device_train.num_chunks >= 3
    resident = _device_trainer(tmp_path, cuda_device, "resident")
    for tr in (chunked, resident):
        tr.train_epoch(0)
    a, b = chunked.model.state_dict(), resident.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the host pipeline's captured steps, the captured served forward, the
# registered operator and exported artifacts
# ---------------------------------------------------------------------------

def _host_trainer(tmp_path, device, name, **over):
    from sonet_torch.train.trainer import Trainer
    cfg = config.tiny_test().replace(
        checkpoints_dir=str(tmp_path), name=name,
        random_pc_dropout_lower_limit=0.8, **over)
    return Trainer(cfg, quiet=True, resume=False, device=device)


def test_host_captured_train_step_equals_eager(cuda_device, tmp_path):
    """The host pipeline's replay of a batch runs the eager step's kernels
    on the same inputs and generator state (float32 here)."""
    t = _host_trainer(tmp_path, cuda_device, "hostcap")
    assert all(g["capturable"] for g in t.state.optimizer.param_groups)
    batch = next(iter(t.train_loader))
    eager, graph, rel = chip_smoke.captured_and_eager_host_step(t, batch)
    assert t.train_graph.captures == 1 and t.train_graph.replays == 1
    assert graph == pytest.approx(eager, rel=1e-5, abs=1e-6)
    assert rel < 1e-3


def test_host_captured_step_follows_the_epoch(cuda_device, tmp_path):
    """lr halves and the BatchNorm momentum decays every epoch: the host
    pipeline's step is captured again for each epoch's values."""
    t = _host_trainer(tmp_path, cuda_device, "hostepochs", lr_decay_step=1,
                      bn_momentum_decay_step=1)
    for epoch in range(2):
        t.train_epoch(epoch)
    assert t.train_graph.captures == 2
    assert t.train_graph.replays == 2 * t.steps_per_epoch
    batch = next(iter(t.train_loader))
    eager, graph, rel = chip_smoke.captured_and_eager_host_step(t, batch)
    assert t.train_graph.captures == 3
    keys = [t._keys[e] for e in range(3)]
    assert keys[2] != keys[1] != keys[0]
    assert keys[2][0] == tuple(t.cfg.lr / 2 for _ in keys[2][0])
    assert graph == pytest.approx(eager, rel=1e-5, abs=1e-6)
    assert rel < 1e-3


def test_captured_served_forward_equals_eager(cuda_device):
    from sonet_torch.serving import ServingEngine, build_serve_fn
    cfg = config.tiny_test()
    model = build_model(cfg, device=cuda_device, seed=0)
    engine = ServingEngine.from_model(model, cfg, device=cuda_device)
    before = smw.windowed_vals.launches
    engine.warmup()
    assert engine.graph.captures == 1
    # the warm-up step and the capture; a replay launches nothing
    assert smw.windowed_vals.launches - before == 2
    rs = np.random.RandomState(0)
    x = {i["name"]: rs.randn(11, *i["shape"][1:]).astype(i["dtype"])
         for i in engine.manifest["inputs"]}
    replays = engine.graph.replays
    got = engine.predict(x)
    B = engine.batch_size
    assert engine.graph.replays - replays == -(-11 // B)   # the last padded
    assert smw.windowed_vals.launches - before == 2
    serve = build_serve_fn(model, cfg)
    want = serve(*(torch.from_numpy(x[n][:B]).to(cuda_device)
                   for n in engine.input_names)).float().cpu().numpy()
    # the same kernels on the same inputs
    np.testing.assert_array_equal(got[:B], want)


def test_windowed_vals_op_equals_the_ctypes_launch(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((2, 3000, 384), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ids = torch.sort(torch.randint(0, 64, (2, 3000), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values
    out = torch.empty((2, 64, 384), dtype=torch.float32, device=cuda_device)
    err = smw._kernel(data.data_ptr(), 1, ids.data_ptr(), out.data_ptr(),
                      2, 3000, 384, 64, cuda_device.index or 0,
                      torch.cuda.current_stream().cuda_stream)
    assert err == 0
    before = smw.windowed_vals.launches
    got = torch.ops.sonet_torch.windowed_vals(data, ids, 64)
    torch.cuda.synchronize()
    assert smw.windowed_vals.launches == before + 1
    assert bool((got == out).all())


def _small_run(tmp_path, device):
    """A float32 ``tiny_test`` run written from ``device``: (its directory,
    its configuration)."""
    cfg = config.tiny_test().replace(compute_dtype="float32")
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "config.json"))
    state = train.init_state(cfg, device=device, seed=1)
    train.save_checkpoint(str(run / "ckpt"), state, 1)
    return run, cfg


def test_cuda_export_replays_as_from_model(cuda_device, tmp_path):
    """A cuda export of a small run keeps the operator, loads with it, and
    answers as ``from_run`` does through one captured graph a bucket."""
    from sonet_torch.serving import ServingEngine, export_run
    run, cfg = _small_run(tmp_path, cuda_device)
    out = str(tmp_path / "art")
    manifest = export_run(str(run), out_dir=out, device=cuda_device,
                          poly_batch=True)
    assert manifest["buckets"] == [1, 2, 4]
    assert manifest["pooling"] == "sorted_window"
    engine = ServingEngine.from_artifact(out, device=cuda_device)
    engine.warmup()
    assert engine.graph.captures == len(manifest["buckets"])
    ref = ServingEngine.from_run(str(run), device=cuda_device)
    rs = np.random.RandomState(0)
    x = {i["name"]: rs.randn(cfg.batch_size, *i["shape"][1:]).astype(
        i["dtype"]) for i in ref.manifest["inputs"]}
    got, want = engine.predict(x), ref.predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["cuda", "portable"])
def test_cpu_stored_export_moves_onto_the_card(cuda_device, tmp_path, form):
    """An artifact whose program lies on the CPU (a ``cuda`` export traced
    on the CPU, keeping the operator; a portable symbolic one, which is
    always stored on the CPU) is moved onto the card by ``load_exported``
    and answers as ``from_run`` on the same pooling.  On a card a symbolic
    artifact's warm-up captures every size the micro-batcher fills."""
    from sonet_torch.serving import ServingEngine, _restore_run, export_run
    run, cfg = _small_run(tmp_path, cuda_device)
    out = str(tmp_path / "art")
    if form == "cuda":
        manifest = export_run(str(run), out_dir=out, device="cpu",
                              platforms=["cuda"])
    else:
        manifest = export_run(str(run), out_dir=out, device=cuda_device,
                              platforms=["cpu", "cuda"], poly_batch=True)
    program = torch.export.load(os.path.join(out, "model.pt2"))
    assert {t.device.type for t in program.state_dict.values()} == {"cpu"}
    pooling = "sorted_window" if form == "cuda" else "scatter"
    assert manifest["pooling"] == pooling
    engine = ServingEngine.from_artifact(out, device=cuda_device)
    engine.warmup()
    assert engine.graph.captures == (1 if form == "cuda" else 4)
    rcfg, model, _, _ = _restore_run(str(run), device=cuda_device,
                                     pooling=pooling)
    ref = ServingEngine.from_model(model, rcfg, device=cuda_device)
    rs = np.random.RandomState(0)
    x = {i["name"]: rs.randn(cfg.batch_size, *i["shape"][1:]).astype(
        i["dtype"]) for i in ref.manifest["inputs"]}
    got, want = engine.predict(x), ref.predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the oracles, remat and the profiling utilities on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_the_sorted_and_onehot_oracles(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    data = torch.randn((8, 15000, 384), generator=gen,
                       device=cuda_device).to(dtype)
    ids = torch.sort(torch.randint(0, 64, (8, 15000), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values
    got = smw.windowed_vals(data, ids, 64)
    torch.cuda.synchronize()
    assert chip_smoke._same_as_oracles(torch, got, data, ids, 64)


@pytest.mark.parametrize("pooling", ["sorted_window", "scatter"])
def test_remat_step_on_card_equals_the_plain_step(cuda_device, pooling):
    cfg = config.tiny_test().replace(pooling=pooling, dropout=0.0)
    rs = np.random.RandomState(0)
    batch = {"pc": rs.randn(4, 64, 3), "sn": rs.randn(4, 64, 3),
             "node": rs.randn(4, 16, 3)}
    batch = {k: torch.tensor(v, dtype=torch.float32, device=cuda_device)
             for k, v in batch.items()}
    batch["label"] = torch.tensor([0, 1, 2, 3], device=cuda_device)
    init = build_model(cfg, device=cuda_device, seed=0).state_dict()
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = build_model(c, device=cuda_device)
        model.load_state_dict(init)
        st = train.init_state(c, device=cuda_device, model=model)
        step, _ = train.make_steps(c, 100)
        _, m = step(st, batch, None)
        out[remat] = (m["loss"].clone(),
                      {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                      {k: v.clone() for k, v in model.state_dict().items()})
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0) and set(g0) == set(g1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_device_time_reads_the_cards_kernels(cuda_device):
    from sonet_torch.utils import hlocat, tprof
    cfg = config.tiny_test()
    model = build_model(cfg, device=cuda_device)
    x = [torch.randn(4, 64, 3, device=cuda_device),
         torch.randn(4, 64, 3, device=cuda_device),
         torch.randn(4, 16, 3, device=cuda_device)]

    def forward(*t):
        with torch.inference_mode():
            return model(*t)[0]
    total, per_op = tprof.device_time(forward, x, iters=3)
    assert total > 0 and abs(sum(per_op.values()) - total) < 1e-9
    cats = hlocat.categorize(per_op)
    assert cats.get("pooling kernel", 0) > 0 and cats.get("GEMMs", 0) > 0


def test_scan_bench_replays_a_graph(cuda_device):
    from sonet_torch.utils.profiling import scan_bench
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((8, 3072, 384), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ids = torch.sort(torch.randint(0, 64, (8, 3072), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values
    ms = scan_bench(smw.windowed_vals, (data, ids, 64), iters=10, reps=5)
    assert 0 < ms < 1.0


# ---------------------------------------------------------------------------
# the fused BatchNorm kernels (csrc/batchnorm_act.cu)
# ---------------------------------------------------------------------------

# the main path's (rows, width): the first PointNet's three layers over
# 8 x 15,000 stacked points, the segmenter head's first layer over 24,576,
# the kNN layer's 4,608 (two-pass variance) and a head's rank-2 rows
BN_SHAPES = [(120000, 64), (120000, 128), (120000, 256), (24576, 1024),
             (4608, 512), (8, 512)]


def _bn_inputs(rows, width, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    y = (torch.randn((rows, width), generator=gen, device=device) * 2
         + 0.3).to(dtype)
    b = torch.randn(width, generator=gen, device=device).to(dtype)
    g = torch.randn((rows, width), generator=gen, device=device).to(dtype)
    bn = nn_layers.BatchNorm(width).to(device)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
        bn.running_mean.normal_(0.3, 0.1, generator=gen)
        bn.running_var.uniform_(3.0, 5.0, generator=gen)
    return y, b, g, bn


def _bn_run(bn, y, b, g, act):
    x = y.clone().requires_grad_()
    out = bn.normalise(x, None, b, act)
    out.backward(g)
    return out.detach(), x.grad, bn.weight.grad, bn.bias.grad


def _rel_err(got, want):
    """Largest difference over the largest entry of ``want``."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("train_mode", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,width", BN_SHAPES)
def test_batchnorm_kernels_equal_the_plain_chain(cuda_device, monkeypatch,
                                                 rows, width, dtype,
                                                 train_mode, act):
    """The fused kernels against ``BatchNorm``'s unfused chain run on the
    card, its gradients by autograd.

    With the running statistics the forward is ``==`` (the same float32
    operations, each rounded once, in the same order) and the gradients
    agree within 1e-4 of the largest entry in float32 (the closed form of
    autograd's chain, rounded elsewhere; 120,000-term sums in another
    order) and 2e-2 in bf16 (one bf16 step of dy, 0.4-0.8%).

    With batch statistics the sums run in another order: mean and
    variance within 1e-5 of the variance's scale, the forward within one
    step of its type where a last-bit change of the statistics moves it.
    The backward kernels then equal, at the same tolerances, the plain
    backward from the kernels' own statistics; against autograd of the
    plain chain, whose statistics differ in their last bits, a ReLU mask
    flips wherever a pre-activation lies within those bits of 0, moving
    that element's dy by up to the largest entry and a channel's sums by
    one term: at most 1e-5 of dy's elements may differ beyond the
    tolerance, and the parameters' gradients agree in norm within
    1e-2."""
    y, b, g, bn = _bn_inputs(rows, width, dtype, cuda_device)
    plain = nn_layers.BatchNorm(width).to(cuda_device)
    plain.load_state_dict(bn.state_dict())
    bn.train(train_mode)
    plain.train(train_mode)
    relu = act == "relu"
    before = dict(bna.launches)
    got = _bn_run(bn, y, b, g, act)
    mode = "train" if train_mode else "eval"
    assert bna.launches[mode] == before[mode] + 1
    assert bna.launches["backward"] == before["backward"] + 1
    monkeypatch.setattr(nn_layers, "fused", lambda t: False)
    want = _bn_run(plain, y, b, g, act)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    tol = 1e-4 if f32 else 2e-2
    names = ("dy", "dweight", "dbias")
    if not train_mode:
        assert torch.equal(got[0], want[0])
        for name, a, w in zip(names, got[1:], want[1:]):
            assert _rel_err(a, w) <= tol, (name, _rel_err(a, w))
        return
    w, beta = bn.weight.detach(), bn.bias.detach()
    _, mean, var = bna.batchnorm_act_train(y, b, w, beta, bn.eps, relu)
    h = (y + b).float()
    want_mean = h.mean(0)
    want_var = ((h - want_mean).square().mean(0) if rows < 8192
                else h.square().mean(0) - want_mean.square())
    scale = float(want_var.max())
    assert float((mean - want_mean).abs().max()) <= 1e-5 * scale
    assert float((var - want_var).abs().max()) <= 1e-5 * scale
    for k in ("running_mean", "running_var"):
        ref = getattr(plain, k)
        assert float((getattr(bn, k) - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max()), k
    # one step of the type at the element, or a normalised value moved by
    # the statistics' last bits where the output is near 0
    step = 2 ** -22 if f32 else 2 ** -7
    err = (got[0].float() - want[0].float()).abs()
    assert bool((err <= step * want[0].float().abs() + 1e-4).all())
    same_stats = bna.batchnorm_act_backward_plain(g, y, b, w, beta, mean,
                                                  var, bn.eps, relu, True)
    for name, a, w_ in zip(names, got[1:], same_stats):
        assert _rel_err(a, w_) <= tol, (name, _rel_err(a, w_))
    off = (got[1].float() - want[1].float()).abs() > tol * float(
        want[1].float().abs().max())
    assert float(off.float().mean()) <= 1e-5
    for name, a, w_ in zip(names[1:], got[2:], want[2:]):
        rel = float((a - w_).norm() / w_.norm())
        assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("rows,width", [(120000, 64), (4608, 512), (8, 512)])
def test_batchnorm_kernels_are_deterministic(cuda_device, rows, width):
    y, b, g, bn = _bn_inputs(rows, width, torch.bfloat16, cuda_device)
    runs = [_bn_run(bn, y, b, g, "relu") for _ in range(2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_batchnorm_kernels_reject_what_they_do_not_take(cuda_device):
    y, b, g, bn = _bn_inputs(64, 16, torch.float32, cuda_device)
    w, beta = bn.weight.detach(), bn.bias.detach()
    with pytest.raises(ValueError, match="contiguous"):
        bna.batchnorm_act_train(torch.zeros(16, 64, device=cuda_device).t(),
                                b, w, beta, 1e-5, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        bna.batchnorm_act_train(y[:, :12].contiguous(), b[:12], w[:12],
                                beta[:12], 1e-5, True)
    with pytest.raises(ValueError, match="one CUDA device"):
        bna.batchnorm_act_train(y, b.cpu(), w, beta, 1e-5, True)
    with pytest.raises(TypeError):
        bna.batchnorm_act_eval(y.half(), None, w, beta, bn.running_mean,
                               bn.running_var, 1e-5, False)


@pytest.mark.parametrize("train_mode", [True, False])
def test_a_batchnorm_the_kernels_do_not_take_is_refused_on_the_card(
        cuda_device, train_mode, monkeypatch):
    """On the card a BatchNorm has one path, the fused kernels: a width
    they do not take raises there, and the plain chain never runs."""
    bn = nn_layers.BatchNorm(12).to(cuda_device).train(train_mode)
    y = torch.randn(64, 12, device=cuda_device)
    plain, forward = [], nn_layers.BatchNorm.forward
    monkeypatch.setattr(nn_layers.BatchNorm, "forward",
                        lambda self, *a: plain.append(a) or forward(self, *a))
    with pytest.raises(ValueError, match="multiple of 8"):
        bn.normalise(y, None, None, "relu")
    assert plain == []


def _full_batch(cfg, device, seed=0):
    rs = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    batch = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
             "node": pc[:, :M] + 0.1 * rs.randn(B, M, 3).astype(np.float32)}
    if cfg.task == "segment":
        batch["label"] = rs.randint(0, 16, B).astype(np.int32)
        batch["seg"] = rs.randint(0, cfg.classes, (B, N))
    else:
        batch["label"] = rs.randint(0, cfg.classes, B)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("preset", ["modelnet40", "shapenetpart"])
def test_batchnorm_kernels_engage_in_every_layer_of_the_train_step(
        cuda_device, preset):
    """Every BatchNorm of the full-width train step runs the kernels once
    forward and once backward in each call, counted at the capture of a
    graph (kernel 1's one call a step counts the calls); a replay
    launches nothing from the host and gives the eager step's loss."""
    from sonet_torch.train.graphs import StepGraph
    cfg = getattr(config, preset)().replace(dropout=0.0)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    train.state.set_capturable(state.optimizer, True)
    norms = [m for m in state.model.modules()
             if isinstance(m, nn_layers.BatchNorm)]
    ran, fused = [], nn_layers.BatchNorm._fused

    def recorded(self, *a):
        ran.append(self)
        return fused(self, *a)
    step, _ = train.make_steps(cfg, 10)
    batch = _full_batch(cfg, cuda_device)
    restore = train.state.snapshot(state)
    nn_layers.BatchNorm._fused = recorded
    try:
        eager = float(step(state, batch, None)[1]["loss"])
    finally:
        nn_layers.BatchNorm._fused = fused
    restore()
    assert sorted(map(id, ran)) == sorted(map(id, norms))
    before, calls0 = dict(bna.launches), smw.windowed_vals.launches
    graph = StepGraph(lambda **b: step(state, b, None)[1], cuda_device,
                      snapshot=lambda: train.state.snapshot(state))
    replayed = float(graph(**batch)["loss"])
    calls = smw.windowed_vals.launches - calls0
    grew = {k: bna.launches[k] - before[k] for k in before}
    assert calls >= 1 and grew == {"train": calls * len(norms), "eval": 0,
                                   "backward": calls * len(norms)}
    assert replayed == eager
    restore()
    graph(**batch)
    assert {k: bna.launches[k] - before[k] for k in before} == grew


def _ae_device_epoch(device, items=24):
    """``config.autoencoder()`` at full width (bf16) as the device pipeline
    trains it: a resident split of ``items`` 2,048-point clouds with
    nodes, ``init_state`` with a capturable Adam, and an ``EpochGraph``
    over ``make_steps``' train step with ``sample_batch``.  Returns (the
    graph, the eager step, the split, the state, the generator)."""
    from sonet_torch.data import device_pipeline as dp
    from sonet_torch.train.graphs import EpochGraph
    cfg = config.autoencoder()
    g = torch.Generator().manual_seed(0)
    u = torch.randn((items, 2048, 3), generator=g)
    u = u / u.norm(dim=-1, keepdim=True)
    pc = u * (0.4 + 0.6 * torch.rand((items, 1, 3), generator=g))
    node = pc[:, :cfg.node_num] + 0.05 * torch.randn(
        (items, cfg.node_num, 3), generator=g)
    data = dp.DeviceData(pc=pc.to(device), sn=u.to(device),
                         node=node.to(device),
                         label=torch.zeros(items, dtype=torch.int64,
                                           device=device))
    state = train.init_state(cfg, device=device, seed=0, steps_per_epoch=10)
    train.state.set_capturable(state.optimizer, True)
    step_fn, _ = train.make_steps(cfg, 10)
    gen = torch.Generator(device=device).manual_seed(7)

    def step(d, idx):
        return step_fn(state, dp.sample_batch(d, idx, gen, cfg, train=True),
                       gen)[1]

    def advance():
        state.step += 1
    graph = EpochGraph(step, device, generators=(gen,),
                       snapshot=lambda: train.state.snapshot(state),
                       on_replay=advance)
    return graph, step, data, state, gen


def test_captured_autoencode_step_equals_eager(cuda_device):
    """One full-width autoencode step from the same weights, Adam state and
    draws, eagerly and as a replay of the device pipeline's captured step:
    the forward is the same kernels on the same inputs (the loss and its
    parts, the running statistics).  The backward adds with atomics (the
    Chamfer gathers' and the encoder's gathers' scatter-adds), whose other
    orders the bf16 backward rounds apart: the replay's gradients (Adam's
    first moment) differ from the eager step's by about 0.5% of their
    norm (5.4e-3 read on an H100), so they are held to 2e-2 over every
    leaf whose true gradient is not zero (a convolution's bias before its
    BatchNorm has none: its gradient is round-off, on both sides)."""
    graph, step, data, state, gen = _ae_device_epoch(cuda_device)
    model, opt = state.model, state.optimizer
    row = np.arange(8)[None]
    restore, gen_state = train.state.snapshot(state), gen.get_state()

    def moments():
        return {n: opt.state[p]["exp_avg"].clone()
                for n, p in model.named_parameters() if p in opt.state}
    eager = {k: float(v) for k, v in step(
        data, torch.from_numpy(row[0]).to(cuda_device)).items()}
    eager_m = moments()
    eager_buf = {n: b.clone() for n, b in model.named_buffers()}
    restore()
    gen.set_state(gen_state)
    replay = graph.run(data, row)
    assert graph.captures == 1 and state.step == 1
    assert set(replay) == set(eager)
    for k, v in eager.items():
        assert float(replay[k][0]) == pytest.approx(v, rel=1e-6), k
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, eager_buf[n], rtol=1e-6, atol=1e-7)
    got_m = moments()
    assert set(got_m) == set(eager_m)
    num = den = 0.0
    for n, m in eager_m.items():
        if not n.endswith("Conv_0.bias"):
            num += float((got_m[n] - m).double().square().sum())
            den += float(m.double().square().sum())
    assert (num / den) ** 0.5 < 2e-2


def test_chamfer_calls_two_a_captured_autoencode_step(cuda_device):
    """``chamfer.calls`` counts the final cloud's (1,280 points) and pc4's
    (256) Chamfer calls once each a step that Python runs: the capture's
    warm-up and the capture itself, and no replay."""
    from sonet_torch.ops import chamfer
    graph, _, data, _, _ = _ae_device_epoch(cuda_device)
    before, k1 = dict(chamfer.calls), smw.windowed_vals.launches
    graph.run(data, np.arange(24).reshape(3, 8))
    ran = smw.windowed_vals.launches - k1       # one a Python-run step
    assert graph.captures == 1 and ran == 2
    grew = {k: v - before.get(k, 0) for k, v in chamfer.calls.items()
            if v != before.get(k, 0)}
    assert grew == {(1280, 1024): ran, (256, 1024): ran}
    graph.run(data, np.arange(16).reshape(2, 8))
    assert graph.captures == 1 and smw.windowed_vals.launches - k1 == ran
    assert {k: v - before.get(k, 0) for k, v in chamfer.calls.items()
            if v != before.get(k, 0)} == grew


def test_batchnorm_kernels_engage_in_every_decoder_layer(cuda_device):
    """Every BatchNorm of the full-width autoencode step runs the fused
    kernels forward in each step Python runs, and backward but for the
    two of the 64x64 stage, which runs without a graph for its running
    statistics; the decoder's include the two-pass path at 8 rows (the FC
    branch) and 32-2,048 rows (the first four convolutions), and the NHWC
    convolutions whose bias keeps its gradient."""
    graph, _, data, state, _ = _ae_device_epoch(cuda_device)
    norms = [m for m in state.model.modules()
             if isinstance(m, nn_layers.BatchNorm)]
    unread = [m for n, m in state.model.named_modules()
              if isinstance(m, nn_layers.BatchNorm)
              and (".UpConv_5." in n or ".ConvToPC_2." in n)]
    assert len(unread) == 2
    ran, fused = [], nn_layers.BatchNorm._fused

    def recorded(self, y, *a):
        ran.append((self, y.numel() // y.shape[-1], y.dim()))
        return fused(self, y, *a)
    before, k1 = dict(bna.launches), smw.windowed_vals.launches
    nn_layers.BatchNorm._fused = recorded
    try:
        graph.run(data, np.arange(16).reshape(2, 8))
    finally:
        nn_layers.BatchNorm._fused = fused
    calls = smw.windowed_vals.launches - k1
    assert calls == 2
    assert sorted(id(m) for m, _, _ in ran) == sorted(
        id(m) for m in norms for _ in range(calls))
    rows = {r for m, r, _ in ran}
    assert {8, 32, 128, 512, 2048} <= rows
    assert any(dim == 4 for _, _, dim in ran)
    grew = {k: bna.launches[k] - before[k] for k in before}
    assert grew == {"train": calls * len(norms), "eval": 0,
                    "backward": calls * (len(norms) - len(unread))}


# ---------------------------------------------------------------------------
# node pooling's backward: csrc/segment_max_grad.cu
# ---------------------------------------------------------------------------

def _pool_grad_both(data, ids, out, counts, g, point0_idx=None):
    """(the kernels' gradient, the plain version's), both on the card."""
    before = smg.segment_max_grad.launches
    got = smg.segment_max_grad(data, ids, out, counts, g, point0_idx)
    torch.cuda.synchronize()
    assert smg.segment_max_grad.launches == before + 1
    want = smg.route_max_grad_plain(data, ids, out, counts, g, point0_idx)
    return got, want


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("shape,dtype", [
    (chip_smoke.POOL_GRAD_SHAPES[0], torch.bfloat16),
    (chip_smoke.POOL_GRAD_SHAPES[1], torch.bfloat16),
    (chip_smoke.POOL_GRAD_SHAPES[2], torch.bfloat16),
    (chip_smoke.POOL_GRAD_SHAPES[0], torch.float32)])
def test_segment_max_grad_kernels_equal_plain(cuda_device, shape, dtype,
                                              sorted_ids):
    """At the main path's shapes, every node occupied: the kernels'
    gradient ``==`` the plain version's, every element."""
    B, N, C, M = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((B, N, C), generator=gen,
                       device=cuda_device).to(dtype)
    ids = torch.randint(0, M, (B, N), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    if sorted_ids:
        ids = torch.sort(ids, dim=1).values.contiguous()
    out, counts, g = chip_smoke.pool_grad_inputs(torch, gen, data, ids, M)
    assert bool((counts > 0).all())
    assert smg.vector_path(data)
    got, want = _pool_grad_both(data, ids, out, counts, g)
    assert torch.equal(got, want)


def test_segment_max_grad_edge_cases(cuda_device):
    """Planted ties, empty nodes with and without ``point0_idx`` (that row
    within one rounding), ids outside [0, M), counts and cotangents of
    other types, narrow, wide, odd and unaligned rows, zeros of both
    signs and -inf: each on the path its shape names, each ``==`` but
    that row."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    failed = {}
    for name, data, ids, out, counts, g, p0, vector in (
            chip_smoke.pool_grad_cases(torch, gen, cuda_device)):
        assert smg.vector_path(data) == vector, name
        got, want = _pool_grad_both(data, ids, out, counts, g, p0)
        bad = chip_smoke.pool_grad_mismatch(torch, got, want, counts, g, p0)
        if bad:
            failed[name] = bad
    assert not failed


def test_segment_max_grad_is_deterministic(cuda_device):
    """Integer tie counts: two calls on the same inputs, unsorted ids
    included, give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    data = torch.randn((8, 3072, 384), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, 64, (8, 3072), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    out, counts, g = chip_smoke.pool_grad_inputs(torch, gen, data, ids, 64)
    first = smg.segment_max_grad(data, ids, out, counts, g)
    assert torch.equal(first, smg.segment_max_grad(data, ids, out, counts, g))


def test_segment_max_grad_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    data = torch.randn((2, 100, 64), generator=gen, device=cuda_device)
    ids = torch.randint(0, 8, (2, 100), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    out, counts, g = chip_smoke.pool_grad_inputs(torch, gen, data, ids, 8)
    before = smg.segment_max_grad.launches
    with pytest.raises(TypeError, match="data dtype"):
        smg.segment_max_grad(data.half(), ids, out.half(), counts, g)
    with pytest.raises(TypeError, match="out dtype"):
        smg.segment_max_grad(data, ids, out.bfloat16(), counts, g)
    with pytest.raises(TypeError, match="seg_ids dtype"):
        smg.segment_max_grad(data, ids.long(), out, counts, g)
    with pytest.raises(ValueError, match="contiguous"):
        smg.segment_max_grad(data.transpose(0, 1).contiguous().transpose(
            0, 1), ids, out, counts, g)
    with pytest.raises(ValueError, match="counts"):
        smg.segment_max_grad(data, ids, out, counts[:, :4], g)
    with pytest.raises(ValueError, match="one CUDA device"):
        smg.segment_max_grad(data, ids, out, counts.cpu(), g)
    assert smg.segment_max_grad.launches == before


def test_segment_max_grad_engages_once_a_captured_modelnet40_step(
        cuda_device, monkeypatch):
    """The full-width modelnet40 train step, eager and as a captured
    graph: node pooling's backward goes through the kernels once in each
    step that Python runs (the eager step, the capture's warm-up and the
    capture) and in no replay; the eager step's and the replayed
    step's gradient each equal the plain version's on their inputs, and
    the replayed one equals the kernels' eager call on the same inputs."""
    from sonet_torch.train.graphs import StepGraph
    cfg = config.modelnet40().replace(dropout=0.0)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    train.state.set_capturable(state.optimizer, True)
    step, _ = train.make_steps(cfg, 10)
    batch = _full_batch(cfg, cuda_device)
    seen, real = [], seg.route_max_grad

    def recorded(*a, **k):
        grad = real(*a, **k)
        # detached: a saved input would keep its step's autograd graph,
        # and an older graph's nodes break the next capture
        seen.append(([t.detach() for t in a], k, grad.detach()))
        return grad
    monkeypatch.setattr(seg, "route_max_grad", recorded)
    restore = train.state.snapshot(state)
    launches0, calls0 = (smg.segment_max_grad.launches,
                         smw.windowed_vals.launches)
    eager = float(step(state, batch, None)[1]["loss"])
    assert smg.segment_max_grad.launches - launches0 == 1 == len(seen)
    eager_in = [t.clone() for t in seen[0][0]]
    eager_grad = seen[0][2].clone()
    restore()
    graph = StepGraph(lambda **b: step(state, b, None)[1], cuda_device,
                      snapshot=lambda: train.state.snapshot(state))
    replayed = float(graph(**batch)["loss"])
    torch.cuda.synchronize()
    calls = smw.windowed_vals.launches - calls0
    assert calls == 3 == len(seen)          # eager, warm-up, capture
    assert smg.segment_max_grad.launches - launches0 == calls
    assert replayed == eager
    # the replay wrote the captured step's tensors, held here since capture
    captured_in, captured_grad = seen[2][0], seen[2][2]
    p0 = seen[0][1]["point0_idx"]
    for inputs, grad in ((eager_in, eager_grad),
                         (captured_in, captured_grad)):
        data, ids, out, counts, g = inputs
        want = smg.route_max_grad_plain(data, ids, out, counts, g, p0)
        assert not chip_smoke.pool_grad_mismatch(torch, grad, want, counts,
                                                 g, p0)
    # the forward is the same kernels on the same inputs
    for a, b in zip(eager_in[:4], captured_in[:4]):
        assert torch.equal(a, b)
    again = smg.segment_max_grad(*captured_in, seen[2][1]["point0_idx"])
    assert torch.equal(again, captured_grad)
    before = smg.segment_max_grad.launches
    graph(**batch)                          # a replay launches nothing
    assert smg.segment_max_grad.launches == before


# ---------------------------------------------------------------------------
# node recentering's segment sums: csrc/segment_sums.cu
# ---------------------------------------------------------------------------

def _sums_both(ids, x, M):
    """(the kernel's (counts, sums), the plain version's), both on the
    card; the kernel launched once."""
    before = ss.segment_sums.launches
    got = ss.segment_sums(ids, x, M)
    torch.cuda.synchronize()
    assert ss.segment_sums.launches == before + 1
    return got, ss.segment_sums_plain(ids, x, M)


@pytest.mark.parametrize("shape", chip_smoke.SUMS_SHAPES)
def test_segment_sums_kernel_equals_plain(cuda_device, shape):
    """At the main path's shapes, node-sorted ids of a real top-k
    assignment: counts ``==`` the plain version's, the card's one-hot
    product, and the sums within ``SUMS_RTOL`` of the absolute sums from it
    and from a float64 sum; at B >= 2, where cuBLAS adds a node's rows in
    their order as the kernel does, the sums ``==`` too (at B = 1 it takes
    another kernel, which adds them in another order)."""
    B, N, D, M = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pc = torch.randn((B, N // 3, D), generator=gen, device=cuda_device)
    nodes = pc[:, torch.randperm(N // 3, generator=gen,
                                 device=cuda_device)[:M]]
    ids = torch.sort(seg_ops.assign_topk(pc, nodes, 3).min_idx,
                     dim=1).values.contiguous()
    x = torch.randn((B, N, D), generator=gen, device=cuda_device)
    got, want = _sums_both(ids, x, M)
    assert not chip_smoke.segment_sums_mismatch(torch, got, want, ids, x, M)
    if B > 1:
        assert torch.equal(got[1], want[1])


def test_segment_sums_edge_cases(cuda_device):
    """Empty nodes, every row on one node (the first, a middle, the last),
    ids outside [0, M), M=1, N=0, a node a row, and the search's round
    edges: each within the rule of ``segment_sums_mismatch``, an empty
    node's count and sum 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    failed = {}
    for name, ids, x, M in chip_smoke.segment_sums_cases(torch, gen,
                                                         cuda_device):
        got, want = _sums_both(ids, x, M)
        bad = chip_smoke.segment_sums_mismatch(torch, got, want, ids, x, M)
        empty = got[0] == 0
        if bool(got[1][empty].any()):
            bad.append("an empty node's sum is not 0")
        if bad:
            failed[name] = bad
    assert not failed


def test_segment_sums_is_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.sort(torch.randint(0, 64, (8, 15000), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values.contiguous()
    x = torch.randn((8, 15000, 3), generator=gen, device=cuda_device)
    first = ss.segment_sums(ids, x, 64)
    second = ss.segment_sums(ids, x, 64)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_segment_sums_replays_in_a_graph(cuda_device):
    """Captured in a CUDA graph, the kernel launches once at the capture
    and none at a replay, and a replay over new inputs written in place
    gives the eager call's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def inputs():
        ids = torch.sort(torch.randint(0, 64, (8, 3072), generator=gen,
                                       device=cuda_device,
                                       dtype=torch.int32), dim=1).values
        return ids, torch.randn((8, 3072, 3), generator=gen,
                                device=cuda_device)
    ids, x = inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.segment_sums(ids, x, 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ss.segment_sums.launches
    with torch.cuda.graph(graph):
        out = ss.segment_sums(ids, x, 64)
    assert ss.segment_sums.launches == before + 1
    new_ids, new_x = inputs()
    ids.copy_(new_ids)
    x.copy_(new_x)
    graph.replay()
    torch.cuda.synchronize()
    assert ss.segment_sums.launches == before + 1
    want = ss.segment_sums(new_ids.contiguous(), new_x, 64)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_segment_sums_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.sort(torch.randint(0, 8, (2, 100), generator=gen,
                                   device=cuda_device, dtype=torch.int32),
                     dim=1).values.contiguous()
    x = torch.randn((2, 100, 3), generator=gen, device=cuda_device)
    before = ss.segment_sums.launches
    with pytest.raises(TypeError, match="x dtype"):
        ss.segment_sums(ids, x.bfloat16(), 8)
    with pytest.raises(TypeError, match="seg_ids dtype"):
        ss.segment_sums(ids.long(), x, 8)
    with pytest.raises(ValueError, match="want"):
        ss.segment_sums(ids, torch.randn((2, 100, 4), device=cuda_device), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sums(ids, x.transpose(0, 1).contiguous().transpose(0, 1),
                        8)
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.segment_sums(ids.cpu(), x, 8)
    assert ss.segment_sums.launches == before
    # the CPU takes the plain version and launches nothing
    ss.segment_sums(ids.cpu(), x.cpu(), 8)
    assert ss.segment_sums.launches == before


def test_segment_sums_engage_once_an_encoder_forward(cuda_device,
                                                     monkeypatch):
    """The full-width modelnet40 train step, eager and captured: every
    encoder forward that Python runs (the eager step, the capture's warm-up
    and the capture) launches the segment-sum kernel once, as it calls
    kernel 1 once, and a replay launches nothing; no forward makes the
    float32 one-hot ``bmm`` of the recentering; the replayed step's loss
    is the eager step's."""
    from sonet_torch.train.graphs import StepGraph
    cfg = config.modelnet40().replace(dropout=0.0)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    train.state.set_capturable(state.optimizer, True)
    step, _ = train.make_steps(cfg, 10)
    batch = _full_batch(cfg, cuda_device)
    products, real_bmm = [], torch.bmm

    def recorded(a, b, *args, **kw):
        products.append((tuple(a.shape), tuple(b.shape)))
        return real_bmm(a, b, *args, **kw)
    monkeypatch.setattr(torch, "bmm", recorded)
    restore = train.state.snapshot(state)
    sums0, calls0 = ss.segment_sums.launches, smw.windowed_vals.launches
    eager = float(step(state, batch, None)[1]["loss"])
    assert ss.segment_sums.launches - sums0 == 1
    restore()
    graph = StepGraph(lambda **b: step(state, b, None)[1], cuda_device,
                      snapshot=lambda: train.state.snapshot(state))
    replayed = float(graph(**batch)["loss"])
    torch.cuda.synchronize()
    calls = smw.windowed_vals.launches - calls0
    assert calls == 3 == ss.segment_sums.launches - sums0
    assert replayed == eager
    B, kN, M = cfg.batch_size, cfg.k * cfg.input_pc_num, cfg.node_num
    assert ((B, M, kN), (B, kN, 3)) not in products
    before = ss.segment_sums.launches
    graph(**batch)
    torch.cuda.synchronize()
    assert ss.segment_sums.launches == before


# ---------------------------------------------------------------------------
# the 2-D MNIST classifier through the device pipeline's captured epoch
# ---------------------------------------------------------------------------

def _mnist_device_epoch(device, items=24):
    """``config.mnist()`` at full width (bf16, B=8, N=512 of 512 2-D points
    without normals, M=25, k=3, som_k=9) as the device pipeline trains it:
    a resident split of ``items`` stroke clouds with nodes, ``init_state``
    with a capturable Adam, and an ``EpochGraph`` over ``make_steps``'
    train step with ``sample_batch``.  Returns (the graph, the eager step,
    the split, the state)."""
    from sonet_torch.data import device_pipeline as dp
    from sonet_torch.train.graphs import EpochGraph
    cfg = config.mnist()
    g = torch.Generator().manual_seed(0)
    t = torch.rand((items, 512, 1), generator=g) * 2 * np.pi
    freq = (torch.arange(items) % 5 + 1).float()[:, None, None]
    pc = torch.cat([torch.sin(freq * t), torch.cos(t)], -1) \
        + 0.03 * torch.randn((items, 512, 2), generator=g)
    node = pc[:, :cfg.node_num] + 0.05 * torch.randn(
        (items, cfg.node_num, 2), generator=g)
    data = dp.DeviceData(pc=pc.to(device), sn=None, node=node.to(device),
                         label=(torch.arange(items) % 10).to(device))
    state = train.init_state(cfg, device=device, seed=0, steps_per_epoch=10)
    train.state.set_capturable(state.optimizer, True)
    step_fn, _ = train.make_steps(cfg, 10)
    gen = torch.Generator(device=device).manual_seed(7)

    def step(d, idx):
        return step_fn(state, dp.sample_batch(d, idx, gen, cfg, train=True),
                       gen)[1]

    def advance():
        state.step += 1
    graph = EpochGraph(step, device, generators=(gen,),
                       snapshot=lambda: train.state.snapshot(state),
                       on_replay=advance)
    return graph, step, data, state


def _kernel_counters():
    return (smw.windowed_vals.launches, smg.segment_max_grad.launches,
            ss.segment_sums.launches, dict(bna.launches))


def test_mnist_step_engages_every_kernel_once_a_python_run_step(
        cuda_device, monkeypatch):
    """The full-width 2-D MNIST train step captured by ``EpochGraph``: the
    capture's two Python-run steps (the warm-up and the capture) each
    launch kernel 1 once, at (8, 1,536, 384) with M=25, node pooling's
    backward once, the segment sums once, and every BatchNorm's fused
    kernels once forward and once backward; the replays launch nothing
    from the host, and a second part replays the same graph."""
    graph, _, data, state = _mnist_device_epoch(cuda_device)
    norms = [m for m in state.model.modules()
             if isinstance(m, nn_layers.BatchNorm)]
    shapes, real = [], smw._kernel

    def recording(*args):                  # the C function: B, N, C, M
        shapes.append(tuple(args[4:8]))
        return real(*args)
    monkeypatch.setattr(smw, "_kernel", recording)
    k0, g0, s0, b0 = _kernel_counters()
    out = graph.run(data, np.arange(24).reshape(3, 8))
    torch.cuda.synchronize()
    k1, g1, s1, b1 = _kernel_counters()
    ran = k1 - k0
    assert graph.captures == 1 and graph.replays == 3 and ran == 2
    assert np.isfinite(out["loss"]).all() and state.step == 3
    assert g1 - g0 == ran and s1 - s0 == ran
    assert {m: b1[m] - b0[m] for m in b0} == {
        "train": ran * len(norms), "eval": 0, "backward": ran * len(norms)}
    assert set(shapes) == {(8, 1536, 384, 25)}
    graph.run(data, np.arange(16).reshape(2, 8))
    torch.cuda.synchronize()
    assert graph.captures == 1 and graph.replays == 5
    assert _kernel_counters() == (k1, g1, s1, b1)


def test_mnist_grouping_range_in_a_profiled_eager_step(cuda_device):
    """``sonet:grouping`` appears once in a profiled eager 2-D step, and the
    device rows its ops and their backward launched include the segment
    sums and the node sort."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import span_time
    from sonet_torch.nn.encoder import GROUPING
    _, step, data, _ = _mnist_device_epoch(cuda_device)
    idx = torch.arange(8, device=cuda_device)
    step(data, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(data, idx)
        torch.cuda.synchronize()
    ev = span_time.collect(prof)
    assert sum(o.name == GROUPING for o in ev.ops) == 1
    fwd, bwd = span_time.span_ops(ev, GROUPING, 0, 2 ** 63)
    corr = {o.corr for o in fwd + bwd}
    rows = [name for name, _, _, c in ev.rows if c in corr]
    assert any("segment_sums" in r for r in rows), rows
    assert any("sort" in r.lower() for r in rows), rows
    assert span_time.span_device_s(ev, GROUPING, 0, 2 ** 63) > 0


# ---------------------------------------------------------------------------
# Adam's update of both groups: csrc/adam_step.cu
# ---------------------------------------------------------------------------

ADAM_ODD_SHAPES = ((0,), (1,), (3,), (5, 7), (1023,), (1025,), (4097, 3),
                   (64, 1, 3), (129,))


def _like(t, unaligned):
    """A copy of ``t``, contiguous, placed 4 bytes past a 16-byte boundary
    when ``unaligned``."""
    if not unaligned:
        return t.clone()
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _adam_groups_on(kind, device):
    """(encoder tensors, head tensors, which to place unaligned): a
    modelnet40 model's parameters by group, odd sizes with every third
    tensor unaligned, or 300 small tensors (three launches)."""
    g = torch.Generator(device=device).manual_seed(1)
    if kind == "modelnet40":
        model = build_model(config.modelnet40(), device=device, seed=0)
        named = [(n, p.detach()) for n, p in model.named_parameters()]
        enc = [p for n, p in named if n.startswith("encoder.")]
        head = [p for n, p in named if not n.startswith("encoder.")]
        return enc, head, set()
    shapes = (ADAM_ODD_SHAPES if kind == "odd" else
              [((i * 37) % 600 + 1,) for i in range(300)])
    ts = [torch.randn(s, generator=g, device=device) for s in shapes]
    unaligned = {i for i in range(len(ts)) if kind == "odd" and i % 3 == 1}
    half = len(ts) // 2
    return ts[:half], ts[half:], unaligned


def _adam_twins(groups, unaligned, lrs, capturable):
    """The reference, ``torch.optim.Adam(foreach=True, capturable=True)``,
    and the kernel's optimizer (a plain ``torch.optim.Adam`` holding the
    state, ``capturable`` as asked), each over its own copy of the
    tensors, both groups at their own rate."""
    flat = [t for grp in groups for t in grp]
    sides = []
    for opts in (dict(foreach=True, capturable=True),
                 dict(capturable=capturable)):
        ps = [torch.nn.Parameter(_like(t, i in unaligned))
              for i, t in enumerate(flat)]
        n0 = len(groups[0])
        opt = torch.optim.Adam(
            [{"params": ps[:n0], "lr": lrs[0], "name": "encoder"},
             {"params": ps[n0:], "lr": lrs[1], "name": "head"}],
            betas=(0.9, 0.999), eps=1e-8, **opts)
        sides.append((ps, opt))
    return sides


def _adam_gaps(ref, ours):
    """{what: (tensors that differ, their largest gap in ulps)} over the
    parameters, moments and counters of two (params, optimizer) sides."""
    gaps = {}
    (pr, opt_r), (po, opt_o) = ref, ours
    for a, b in zip(pr, po):
        pairs = [("param", a.detach(), b.detach())]
        if a in opt_r.state or b in opt_o.state:
            sa, sb = opt_r.state[a], opt_o.state[b]
            pairs += [(k, sa[k], sb[k].to(sa[k].device))
                      for k in ("exp_avg", "exp_avg_sq", "step")]
        for what, x, y in pairs:
            if not torch.equal(x, y):
                d = (x.double() - y.double()).abs()
                ulp = torch.from_numpy(np.spacing(np.abs(
                    x.float().cpu().numpy()))).to(x.device).double()
                n, worst = gaps.get(what, (0, 0.0))
                gaps[what] = (n + 1, max(worst, float((d / ulp).max())))
    return gaps


@pytest.mark.parametrize("capturable", [True, False])
@pytest.mark.parametrize("kind", ["modelnet40", "odd", "many"])
def test_adam_step_equals_capturable_foreach_adam_bit_for_bit(
        cuda_device, kind, capturable):
    """Three updates of both groups at different rates through
    ``adam_update`` (the kernel; counters on the card, or on the host for
    an eager Adam) against ``torch.optim.Adam(foreach=True,
    capturable=True)`` on the same tensors and gradients: the same
    parameters, moments and counters, bit for bit, on the classifier's
    parameters, on odd sizes (tails, empty, unaligned tensors: the scalar
    path) and on 300 tensors (three launches); one call a step."""
    enc, head, unaligned = _adam_groups_on(kind, cuda_device)
    ref, ours = _adam_twins((enc, head), unaligned, (1e-3, 3e-4), capturable)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    before = adam.adam_step.launches
    for k in range(3):
        for i, (a, b) in enumerate(zip(ref[0], ours[0])):
            grad = torch.randn(a.shape, generator=gen, device=cuda_device) \
                * 10.0 ** (i % 5 - 3)
            a.grad, b.grad = _like(grad, i in unaligned), \
                _like(grad, i in unaligned)
        ref[1].step()
        train.state.adam_update(ours[1])
    torch.cuda.synchronize()
    assert adam.adam_step.launches - before == 3
    assert _adam_gaps(ref, ours) == {}
    where = "cuda" if capturable else "cpu"
    assert all(st["step"].device.type == where and float(st["step"]) == 3
               for st in ours[1].state.values())


def test_adam_update_leaves_a_parameter_without_gradient_alone(cuda_device):
    """A parameter whose ``.grad`` is None is neither touched nor given
    state, in either group; the others match the foreach Adam's bits."""
    enc, head, _ = _adam_groups_on("odd", cuda_device)
    ref, ours = _adam_twins((enc, head), set(), (1e-3, 3e-4), True)
    skip = {2, len(enc) + 1}
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for _ in range(2):
        for i, (a, b) in enumerate(zip(ref[0], ours[0])):
            grad = torch.randn(a.shape, generator=gen, device=cuda_device)
            a.grad = b.grad = None if i in skip else grad
        ref[1].step()
        train.state.adam_update(ours[1])
    torch.cuda.synchronize()
    for i in skip:
        assert ours[0][i] not in ours[1].state
        assert torch.equal(ours[0][i].detach(), (enc + head)[i])
    assert _adam_gaps(ref, ours) == {}


def test_adam_step_launches_once_a_python_run_step(cuda_device):
    """The full-width modelnet40 train step, eager and captured: the eager
    step, the capture's warm-up and the capture each call the kernel once;
    a replay calls nothing from the host, and its trace holds the kernel
    and no foreach ``multi_tensor_apply_kernel``; the replayed step's
    parameters are the eager step's."""
    from torch.profiler import ProfilerActivity, profile

    from sonet_torch.train.graphs import StepGraph
    cfg = config.modelnet40().replace(dropout=0.0)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    train.state.set_capturable(state.optimizer, True)
    step, _ = train.make_steps(cfg, 10)
    batch = _full_batch(cfg, cuda_device)
    restore = train.state.snapshot(state)
    calls0 = adam.adam_step.launches
    step(state, batch, None)
    eager = [p.detach().clone() for p in state.model.parameters()]
    assert adam.adam_step.launches - calls0 == 1
    restore()
    graph = StepGraph(lambda **b: step(state, b, None)[1], cuda_device,
                      snapshot=lambda: train.state.snapshot(state))
    graph(**batch)
    torch.cuda.synchronize()
    assert adam.adam_step.launches - calls0 == 3
    assert all(torch.equal(a, b.detach()) for a, b in
               zip(eager, state.model.parameters()))
    before = adam.adam_step.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph(**batch)
        torch.cuda.synchronize()
    assert adam.adam_step.launches == before
    names = [e.key for e in prof.key_averages()]
    assert any("adam_step_chunks" in n for n in names), names
    assert not any("multi_tensor_apply_kernel" in n for n in names), names


def test_checkpoint_from_the_kernel_path_resumes_bit_for_bit(cuda_device,
                                                             tmp_path):
    """A capturable run trained by the kernel, written as a checkpoint
    after two steps and restored into a fresh state, takes the next two
    steps to the same weights, moments and counters as the run that went
    on; the checkpoint holds the counters on the host, as an eager Adam
    writes them."""
    cfg = _seg_cfg(dropout=0.0)
    step, _ = train.make_steps(cfg, steps_per_epoch=10)
    state = train.init_state(cfg, device=cuda_device, seed=0)
    train.state.set_capturable(state.optimizer, True)
    batch = _seg_batch(cfg, cuda_device)
    for _ in range(2):
        step(state, batch, None)
    path = train.save_checkpoint(str(tmp_path / "ckpt"), state, state.step)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert all(st["step"].device.type == "cpu" and float(st["step"]) == 2
               for st in saved["optimizer"]["state"].values())
    twin = train.init_state(cfg, device=cuda_device, seed=9)
    train.state.set_capturable(twin.optimizer, True)
    twin = train.restore_checkpoint(path, twin)
    calls0 = adam.adam_step.launches
    for s in (state, twin):
        for _ in range(2):
            step(s, batch, None)
    torch.cuda.synchronize()
    assert adam.adam_step.launches - calls0 == 4
    for (k, a), b in zip(state.model.state_dict().items(),
                         twin.model.state_dict().values()):
        assert torch.equal(a, b), k
    want = state.optimizer.state_dict()["state"]
    got = twin.optimizer.state_dict()["state"]
    assert list(got) == list(want)
    for i, entry in want.items():
        for name, t in entry.items():
            assert got[i][name].device == t.device, (i, name)
            assert torch.equal(got[i][name], t), (i, name)


# ---------------------------------------------------------------------------
# the train step's three sorts: csrc/sorts.cu
# ---------------------------------------------------------------------------

SORT_KERNELS = ("counting_sort", "smallest_k_sort", "subset_sort")
# the PyTorch kernels of the stable sorts the three replace: the in-block
# sort and the segmented radix sort of float32 or int32 keys
TORCH_SORTS = ("radixSortKVInPlace", "fill_index_and_segment",
               "sort_postprocess", "Policy<float", "Policy<int,")


def _sort_both(op, *args):
    """(the kernel's outputs, the plain version's: the stable torch.sort
    code it replaces), both on the card; the kernel launched once."""
    fn = getattr(sorts, op)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return got, chip_smoke.sort_references(torch)[op](*args)


@pytest.mark.parametrize("shape", chip_smoke.SORT_SHAPES,
                         ids=[s[0] for s in chip_smoke.SORT_SHAPES])
def test_sorts_equal_the_stable_sort_at_the_cells_shapes(cuda_device, shape):
    """At each cell's shapes, on realistic inputs: the assignment's and the
    kNN's top-k, the node sort of the assignment's ids and the subsample,
    each bit for bit what the stable ``torch.sort`` it replaces gives on
    the card, and ``point0_idx`` each cloud's first sorted slot of its
    point 0's node."""
    cells, B, raw, N, D, M, k, som_k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    keys, d_assign, d_knn, ids = chip_smoke.sort_inputs(
        torch, gen, cuda_device, B, raw, N, D, M, k)
    calls = [("smallest_k", (d_assign, k)), ("smallest_k", (d_knn, som_k)),
             ("node_sort", (ids, M))]
    if raw > N:
        calls.append(("subset_select", (keys, N)))
    for op, args in calls:
        got, want = _sort_both(op, *args)
        assert not chip_smoke.sorts_mismatch(torch, got, want), op
    sorted_ids, perm, inv, point0 = sorts.node_sort(ids, M)
    assert torch.equal(sorted_ids, torch.gather(ids, 1, perm).int())
    assert torch.equal(torch.gather(perm, 1, inv), torch.arange(
        ids.shape[1], device=cuda_device).expand_as(perm))
    assert torch.equal(point0, inv[:, 0])
    first = torch.searchsorted(sorted_ids, ids[:, :1].contiguous())[:, 0]
    assert torch.equal(point0, first)


@pytest.mark.parametrize("op", ["node_sort", "smallest_k", "subset_select"])
def test_sorts_edge_cases(cuda_device, op):
    """Ties, every value equal, zeros of both signs, NaN with infinities,
    the kNN's pinned diagonal, k = L and every k up to 16, one node for
    every id, empty nodes, M = 1 and 1024, n = 0 and n = L, row lengths at
    the kernels' warp and step edges: each output the stable sort's bits,
    and two calls the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = {"node_sort": chip_smoke.node_sort_cases,
             "smallest_k": chip_smoke.smallest_k_cases,
             "subset_select": chip_smoke.subset_select_cases}[op](
                 torch, gen, cuda_device)
    failed = {}
    for name, *args in cases:
        got, want = _sort_both(op, *args)
        again = getattr(sorts, op)(*args)
        bad = chip_smoke.sorts_mismatch(torch, got, want)
        if chip_smoke.sorts_mismatch(torch, got, again):
            bad.append("two calls differ")
        if bad:
            failed[name] = bad
    assert not failed


def test_smallest_k_puts_nan_last_as_torch_sort_does(cuda_device):
    """NaN sorts after +inf and NaNs keep their index order: a row with
    fewer finite values than k returns its NaNs last, in index order."""
    nan, inf = float("nan"), float("inf")
    d = torch.tensor([[nan, 2.0, inf, nan, -0.0, 0.0, nan, -inf]],
                     device=cuda_device)
    vals, idx = sorts.smallest_k(d, 8)
    assert idx.tolist() == [[7, 4, 5, 1, 2, 0, 3, 6]]
    assert chip_smoke.same_bits(torch, vals, d[:, idx[0]])
    want = torch.sort(d, dim=-1, stable=True)
    assert torch.equal(idx, want.indices)


def test_sorts_reject_what_they_do_not_take(cuda_device):
    d = torch.rand((4, 64), device=cuda_device)
    ids = torch.zeros((2, 30), dtype=torch.int32, device=cuda_device)
    counts = (sorts.node_sort.launches, sorts.smallest_k.launches,
              sorts.subset_select.launches)
    for fn, args, err, match in (
            (sorts.smallest_k, (d.double(), 3), TypeError, "dtype"),
            (sorts.smallest_k, (d, 17), ValueError, "k <="),
            (sorts.smallest_k, (d[:, :2], 3), ValueError, "k <="),
            (sorts.smallest_k, (d.t(), 3), ValueError, "contiguous"),
            (sorts.smallest_k, (d.cpu().to("meta"), 3), ValueError,
             "one CUDA device"),
            (sorts.node_sort, (ids.long(), 8), TypeError, "dtype"),
            (sorts.node_sort, (ids, 1025), ValueError, "range"),
            (sorts.node_sort, (ids[:, :0], 8), ValueError, "L >= 1"),
            (sorts.node_sort, (ids.t(), 8), ValueError, "contiguous"),
            (sorts.subset_select, (d.double(), 3), TypeError, "dtype"),
            (sorts.subset_select, (d, 65), ValueError, "n <= L"),
            (sorts.subset_select, (torch.empty(
                (1, sorts.SUBSET_MAX_KEYS + 1), device="meta"), 3),
             ValueError, str(sorts.SUBSET_MAX_KEYS)),
            (sorts.subset_select, (d.t(), 3), ValueError, "contiguous")):
        with pytest.raises(err, match=match):
            fn(*args)
    assert counts == (sorts.node_sort.launches, sorts.smallest_k.launches,
                      sorts.subset_select.launches)


def test_sorts_engage_once_a_captured_modelnet40_step(cuda_device):
    """The full-width modelnet40 train step behind the device pipeline's
    subsample (10,000 points a cloud, 5,000 kept), captured by
    ``EpochGraph``: each of the capture's two Python-run steps launches the
    subset selection once, the node sort once, as it launches kernel 1,
    and the top-k selection twice (the assignment and the nodes' kNN); the
    replays launch none; in a profiled replay the device rows that a
    sort's name matches (the benchmark's ``sorts`` bucket) hold the three
    kernels and none of the PyTorch sorts they replace: what else is left
    there sorts int64 keys (``index_put_`` with ``accumulate``, the kNN
    gather's backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import BUCKETS
    from sonet_torch.data import device_pipeline as dp
    from sonet_torch.train.graphs import EpochGraph
    cfg = config.modelnet40().replace(dropout=0.0)
    g = torch.Generator().manual_seed(0)
    pc = torch.randn((16, 10000, 3), generator=g)
    data = dp.DeviceData(
        pc=pc.to(cuda_device),
        sn=torch.nn.functional.normalize(torch.randn((16, 10000, 3),
                                                     generator=g), dim=-1)
        .to(cuda_device),
        node=(pc[:, :64] + 0.05 * torch.randn((16, 64, 3), generator=g))
        .to(cuda_device),
        label=(torch.arange(16) % 40).to(cuda_device))
    state = train.init_state(cfg, device=cuda_device, seed=0,
                             steps_per_epoch=10)
    train.state.set_capturable(state.optimizer, True)
    step_fn, _ = train.make_steps(cfg, 10)
    gen = torch.Generator(device=cuda_device).manual_seed(7)

    def step(d, idx):
        return step_fn(state, dp.sample_batch(d, idx, gen, cfg, train=True),
                       gen)[1]
    graph = EpochGraph(step, cuda_device, generators=(gen,),
                       snapshot=lambda: train.state.snapshot(state))

    def counts():
        return (smw.windowed_vals.launches, sorts.node_sort.launches,
                sorts.smallest_k.launches, sorts.subset_select.launches)
    before = counts()
    out = graph.run(data, np.arange(16).reshape(2, 8))
    torch.cuda.synchronize()
    ran, nodes, topk, subset = (a - b for a, b in zip(counts(), before))
    assert graph.captures == 1 and graph.replays == 2 and ran == 2
    assert np.isfinite(out["loss"]).all()
    assert (nodes, topk, subset) == (ran, 2 * ran, ran)
    after = counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.run(data, np.arange(8).reshape(1, 8))
        torch.cuda.synchronize()
    assert counts() == after and graph.replays == 3
    pattern = dict(BUCKETS)["sorts"]
    rows = [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and pattern.search(e.name)]
    for kernel in SORT_KERNELS:
        assert any(kernel in r for r in rows), kernel
    others = {r for r in rows if not any(k in r for k in SORT_KERNELS)}
    assert not {r for r in others if any(k in r for k in TORCH_SORTS)}
    assert all("Policy<long" in r for r in others), others
