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
    err = smw._kernel()(data.data_ptr(), 1, ids.data_ptr(), out.data_ptr(),
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
