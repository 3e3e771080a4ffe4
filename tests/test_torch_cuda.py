"""The port's CUDA kernels on the card.  Every test here is marked
``cuda`` and skips on a host without one; the file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sonet_torch import config
from sonet_torch.models import build_model
from sonet_torch.ops.cuda import segment_max_window as smw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


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
