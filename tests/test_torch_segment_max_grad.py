"""Node pooling's backward as the operator ``sonet_torch::segment_max_grad``
(``sonet_torch/ops/cuda/segment_max_grad.py``) on the CPU: its plain
version against a per-node loop written here, the CPU dispatch, autograd
through it, and ``torch.library.opcheck``.  The CUDA kernels behind it
are held to the same plain version on the card (``tests/test_torch_cuda.py``).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the rule the card holds the kernels to)
from sonet_torch.ops import segment, segment_counts, segment_max_fast
from sonet_torch.ops.cuda import segment_max_grad as smg

B, N, C, M = 3, 90, 24, 10
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CASES = ("sorted", "unsorted", "ties", "empty_point0", "empty_row0",
         "outside", "reduce_ties")


def _case(name, dtype, seed=0):
    """(data, ids, out, counts, g, point0_idx, reduce_ties) for ``name``:
    random data rounded to ``dtype`` with ids sorted (or not), planted
    ties (a node's first row copied onto its next two), empty nodes (3
    and the last two) whose cotangent goes to ``point0_idx`` or row 0,
    ids outside [0, M), or a hook that doubles the tie counts."""
    gen = torch.Generator().manual_seed(seed)
    data = torch.randn((B, N, C), generator=gen).to(dtype)
    hi = M - 2 if name.startswith("empty") else M
    lo = -2 if name == "outside" else 0
    ids = torch.randint(lo, hi + (2 if name == "outside" else 0), (B, N),
                        generator=gen, dtype=torch.int32)
    if name.startswith("empty"):
        ids[ids == 3] = 2
    if name != "unsorted":
        ids = torch.sort(ids, dim=1).values.contiguous()
    if name == "ties":
        for b in range(B):
            for m in range(M):
                rows = torch.nonzero(ids[b] == m)[:, 0]
                data[b, rows[1:3]] = data[b, rows[0]].clone()
    counts = segment_counts(ids, M)
    out = _loop_forward(data, ids, counts)
    g = torch.randn((B, M, C), generator=gen).to(dtype)
    p0 = (torch.randint(1, N, (B,), generator=gen)
          if name == "empty_point0" else None)
    hook = (lambda t: 2 * t) if name == "reduce_ties" else None
    return data, ids, out, counts, g, p0, hook


def _loop_forward(data, ids, counts):
    out = data[:, :1].expand(B, M, C).clone()       # empty: point 0's row
    for b in range(B):
        for m in range(M):
            if counts[b, m]:
                out[b, m] = data[b][ids[b] == m].amax(0)
    return out


def _loop_grad(data, ids, out, counts, g, p0, hook):
    """The gradient node by node: each node's cotangent split equally over
    its winners in each channel (the tie counts, passed through ``hook``,
    divided in float32 and rounded once to the data's type), the empty
    nodes' cotangent summed onto ``p0``'s row."""
    grad = torch.zeros_like(data)
    for b in range(B):
        for m in range(M):
            rows = ids[b] == m
            if not bool(rows.any()):
                continue
            win = data[b][rows] == out[b, m]                   # (n, C)
            ties = win.sum(0).float()
            if hook is not None:
                ties = hook(ties)
            ratio = (g[b, m].float() / ties.clamp_min(1.0)).to(data.dtype)
            grad[b][rows] = torch.where(win, ratio, torch.zeros_like(ratio))
        empty = torch.zeros(C)
        for m in range(M):
            if counts[b, m] == 0:
                empty = empty + g[b, m].float()
        row = 0 if p0 is None else int(p0[b])
        grad[b, row] = (grad[b, row].float() + empty.to(data.dtype).float()
                        ).to(data.dtype)
    return grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_plain_operator_equals_a_per_node_loop(name, dtype):
    data, ids, out, counts, g, p0, hook = _case(name, DTYPES[dtype])
    want = _loop_grad(data, ids, out, counts, g, p0, hook)
    if name == "ties":
        # the planted copies tie at the maximum of many (node, channel)s
        tied = [int(((data[b][ids[b] == m] == out[b, m]).sum(0) >= 3).sum())
                for b in range(B) for m in range(M)]
        assert sum(tied) >= 10
    if hook is None:
        got = segment.route_max_grad(data, ids, out, counts, g, p0)
    else:
        got = smg.route_max_grad_plain(data, ids, out, counts, g, p0,
                                       reduce_ties=hook)
    assert got.dtype == want.dtype
    assert not chip_smoke.pool_grad_mismatch(torch, got, want, counts, g,
                                             p0)
    if name.startswith("empty"):
        assert bool((counts == 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_dispatch_takes_the_plain_body(dtype, monkeypatch):
    """On the CPU the operator runs ``route_max_grad_plain`` once a call
    and the kernels' launch counter stays where it was."""
    data, ids, out, counts, g, p0, _ = _case("empty_point0", DTYPES[dtype])
    calls, plain = [], smg.route_max_grad_plain

    def counted(*a, **k):
        calls.append(a[0].device)
        return plain(*a, **k)
    monkeypatch.setattr(smg, "route_max_grad_plain", counted)
    before = smg.segment_max_grad.launches
    got = segment.route_max_grad(data, ids, out, counts, g, p0)
    assert calls == [torch.device("cpu")]
    assert smg.segment_max_grad.launches == before
    assert torch.equal(got, plain(data, ids, out, counts, g, p0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("point0", [False, True])
def test_segment_max_fast_gradient_through_the_operator(dtype, point0,
                                                        monkeypatch):
    """``segment_max_fast``'s backward goes through the operator once and
    gives what ``route_max_grad_plain`` gives on its saved tensors."""
    data, ids, _, counts, g, p0, _ = _case(
        "empty_point0" if point0 else "ties", DTYPES[dtype])
    calls, plain = [], smg.route_max_grad_plain
    monkeypatch.setattr(smg, "route_max_grad_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    x = data.clone().requires_grad_()
    out = segment_max_fast(x, ids, M, counts=counts, point0_idx=p0)
    out.backward(g)
    assert calls == [1]
    assert torch.equal(x.grad, plain(data, ids, out.detach(), counts, g, p0))


@pytest.mark.parametrize("case", ["bfloat16", "float32", "point0",
                                  "float32_cotangent"])
def test_opcheck(case):
    """Schema, fake kernel, autograd registration and AOT dispatch of the
    operator, by ``torch.library.opcheck``."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    data, ids, out, counts, g, p0, _ = _case(
        "empty_point0" if case == "point0" else "sorted", dtype)
    if case == "float32_cotangent":
        g = g.float()
    torch.library.opcheck(torch.ops.sonet_torch.segment_max_grad.default,
                          (data, ids, out, counts, g, p0, []))


def test_entry_point_refuses_a_device_mix():
    data, ids, out, counts, g, _, _ = _case("sorted", torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        smg.segment_max_grad(data, ids, out, counts.to("meta"), g)
