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
from sonet_torch.ops.cuda import segment_argmax as sam
from sonet_torch.ops.cuda import segment_max_window as smw

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
