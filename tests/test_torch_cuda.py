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
