"""Node pooling's backward, the gradient of a segment max with respect
to its input: the plain version ``route_max_grad_plain`` and the CUDA
kernels ``csrc/segment_max_grad.cu`` behind the same function.

The function is a registered operator, ``sonet_torch::segment_max_grad``
(``torch.library.custom_op``): its CPU implementation is the plain
version, ``route_max_grad_plain`` (one-hot products and a tie-count
product); its CUDA implementation zeroes an int32 (B, M, C) tie table and
launches the two kernels: the first reads ``data``, counts the ties and
writes the winners as a bit mask (one byte a thread a row), the second
reads the mask and writes the gradient; its fake implementation gives the
(B, N, C) shape.  ``tie_axes`` names the mesh axes whose ranks
hold other points of the same nodes (``ops.segment_fast._PointsMax``):
the tie counts are summed over them, between the two launches on the
card, since ties split a node's cotangent over all of its points.

``segment_max_grad`` is the op's checked entry point, which
``ops.segment`` names ``route_max_grad``: the dispatcher takes the plain
version only for tensors on the CPU; for CUDA tensors the op launches the
kernels or raises; any other device raises.  It never falls back.
``segment_max_grad.launches`` counts the CUDA calls, each a launch of
both kernels (in a CUDA graph, its capture).

The kernels' ``grad`` equals the plain version's bit for bit (``==``),
but on the ``point0_idx`` row when a node is empty: there the empty
nodes' cotangent is summed in another order, within one rounding in the
data's type.
"""

from __future__ import annotations

import ctypes

import torch

from ...parallel import collectives
from ..gather import take_rows
from ..pairwise import one_hot
from . import DTYPE_CODE, launcher, same_device

_COUNTS_CODE = {torch.float32: 0, torch.int32: 1, torch.int64: 2}
_POINT0_CODE = {torch.int32: 0, torch.int64: 1}
_p, _i = ctypes.c_void_p, ctypes.c_int
_ties = launcher("segment_max_grad", "sonet_pool_grad_ties",
                 [_p, _i, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p])
_route = launcher("segment_max_grad", "sonet_pool_grad_route",
                  [_p, _i, _p, _p, _p, _p, _i, _p, _i, _p, _i, _p, _i, _i, _i,
                   _i, _i, _p])
_width = launcher("segment_max_grad", "sonet_pool_grad_mask_width",
                  [_p, _i, _i], query=True)


def route_max_grad_plain(data: torch.Tensor, seg_ids: torch.Tensor,
                         out: torch.Tensor, counts: torch.Tensor,
                         g: torch.Tensor,
                         point0_idx: torch.Tensor | None = None,
                         reduce_ties=None) -> torch.Tensor:
    """Gradient of a segment max with respect to ``data`` (B, N, C), given
    the forward's output ``out`` (B, M, C) in ``data.dtype``, the node
    ``counts`` (B, M) and the output cotangent ``g`` (B, M, C).

    The winner mask is ``data == out`` at each point's node: exact, since
    ``out`` holds values taken from ``data``.  Ties split the cotangent
    equally (tie counts rounded before the division).  An empty node
    forwarded the feature at ``point0_idx`` (B,) (default position 0), so
    its cotangent goes there.  bf16 data routes through bf16 one-hot
    products (exact: one 1.0 per row), float32 data through gathers.

    Under a points mesh (``ops.segment_fast.windowed_vals_sharded``)
    ``data`` is this rank's part of the points and ``reduce_ties`` sums
    the (B, M, C) tie counts over the ``points`` ranks, since ties split
    the cotangent over the whole node, not over this rank's slice.
    """
    M = out.shape[1]
    bf16 = data.dtype == torch.bfloat16
    if bf16:
        onehot = one_hot(seg_ids, M, torch.bfloat16)          # (B, N, M)
        out_pp = torch.bmm(onehot, out.to(torch.bfloat16))
    else:
        onehot = one_hot(seg_ids, M, torch.float32)
        out_pp = take_rows(out, seg_ids)
    # 0/1 entries are exact in bf16, halving the (B, N, C) mask traffic
    eq = (data == out_pp).to(data.dtype)
    # tie counts per (node, channel), summed in float32 and rounded so
    # that the division below is exact
    ties = torch.round(torch.bmm(onehot.float().transpose(1, 2), eq.float()))
    if reduce_ties is not None:
        ties = reduce_ties(ties)
    empty = (counts == 0)[..., None]                          # (B, M, 1)
    g = g.float()
    # divide per node before routing: one (B, N, C) product, not two
    ratio = torch.where(empty, 0.0, g) / torch.clamp_min(ties, 1.0)
    if bf16:
        ratio_pp = torch.bmm(onehot, ratio.to(torch.bfloat16))  # bf16 out
    else:
        ratio_pp = take_rows(ratio, seg_ids)
    grad = eq * ratio_pp
    # empty nodes forwarded the point-0 feature: their cotangent goes there
    g_empty = torch.where(empty, g, 0.0).sum(1).to(grad.dtype)  # (B, C)
    batch = torch.arange(data.shape[0], device=data.device)
    p0 = (torch.zeros_like(batch) if point0_idx is None
          else point0_idx.long())
    grad[batch, p0] += g_empty
    return grad.to(data.dtype)


def mask_width(data: torch.Tensor) -> int:
    """The winners' mask's bytes a row for ``data`` (B, N, C): a byte a
    thread, C / 8 in bf16 (C / 4 in float32) where a thread takes 16 bytes
    of the row (C a multiple of that, ``data`` on a 16-byte boundary),
    else C (one channel a thread)."""
    return _width(data.data_ptr(), DTYPE_CODE[data.dtype], data.shape[-1])


def vector_path(data: torch.Tensor) -> bool:
    """True if the kernels take 16 bytes of a row a thread for ``data``."""
    return mask_width(data) < data.shape[-1]


def _check(data, seg_ids, out, counts, g, point0_idx):
    """Raises on what the kernels do not take."""
    if data.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_max_grad: data dtype {data.dtype}, want "
                        "float32 or bfloat16")
    if out.dtype != data.dtype:
        raise TypeError(f"segment_max_grad: out dtype {out.dtype}, want "
                        f"data's ({data.dtype})")
    if g.dtype not in DTYPE_CODE:
        raise TypeError(f"segment_max_grad: cotangent dtype {g.dtype}, want "
                        "float32 or bfloat16")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_max_grad: seg_ids dtype {seg_ids.dtype}, "
                        "want int32")
    if point0_idx is not None and (point0_idx.dtype.is_floating_point
                                   or point0_idx.dtype.is_complex):
        raise TypeError(f"segment_max_grad: point0_idx dtype "
                        f"{point0_idx.dtype}, want an integer type")
    if data.dim() != 3 or out.dim() != 3:
        raise ValueError(f"segment_max_grad: data {tuple(data.shape)}, out "
                         f"{tuple(out.shape)}; want (B, N, C), (B, M, C)")
    B, N, C = data.shape
    M = out.shape[1]
    want = {"seg_ids": (seg_ids, (B, N)), "out": (out, (B, M, C)),
            "counts": (counts, (B, M)), "g": (g, (B, M, C))}
    if point0_idx is not None:
        want["point0_idx"] = (point0_idx, (B,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"segment_max_grad: {name} {tuple(t.shape)}, "
                             f"want {shape} for data {tuple(data.shape)}")
    if not (data.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_max_grad: data and seg_ids must be "
                         "contiguous")
    # the kernels index points (B * N) and channels with 32-bit ints
    if B * N >= 2 ** 31 or C >= 2 ** 24 or M >= 2 ** 31:
        raise ValueError(f"segment_max_grad: B={B}, N={N}, C={C}, M={M} out "
                         "of the kernels' range")
    same_device("segment_max_grad", data=data, seg_ids=seg_ids, out=out,
                counts=counts, g=g, point0_idx=point0_idx)


def _cuda(data, seg_ids, out, counts, g, point0_idx, tie_axes):
    _check(data, seg_ids, out, counts, g, point0_idx)
    B, N, C = data.shape
    M = out.shape[1]
    out, g = out.contiguous(), g.contiguous()
    if counts.dtype not in _COUNTS_CODE:
        counts = (counts != 0).to(torch.int32)
    counts = counts.contiguous()
    if point0_idx is not None:
        if point0_idx.dtype not in _POINT0_CODE:
            point0_idx = point0_idx.long()
        point0_idx = point0_idx.contiguous()
    dev = data.device.index
    stream = torch.cuda.current_stream(data.device).cuda_stream
    code = DTYPE_CODE[data.dtype]
    ties = torch.zeros((B, M, C), dtype=torch.int32, device=data.device)
    mask = torch.empty((B * N, mask_width(data)), dtype=torch.uint8,
                       device=data.device)
    _ties(data.data_ptr(), code, seg_ids.data_ptr(), out.data_ptr(),
          ties.data_ptr(), mask.data_ptr(), B, N, C, M, dev, stream)
    if tie_axes:
        ties = collectives.all_reduce(ties, tuple(tie_axes))
    grad = torch.empty_like(data)
    _route(data.data_ptr(), code, mask.data_ptr(), seg_ids.data_ptr(),
          ties.data_ptr(), counts.data_ptr(), _COUNTS_CODE[counts.dtype],
          g.data_ptr(), DTYPE_CODE[g.dtype],
          None if point0_idx is None else point0_idx.data_ptr(),
          0 if point0_idx is None else _POINT0_CODE[point0_idx.dtype],
          grad.data_ptr(), B, N, C, M, dev, stream)
    segment_max_grad.launches += 1
    return grad


@torch.library.custom_op(
    "sonet_torch::segment_max_grad", mutates_args=(), device_types="cpu",
    schema="(Tensor data, Tensor seg_ids, Tensor out, Tensor counts, "
           "Tensor g, Tensor? point0_idx, str[] tie_axes) -> Tensor")
def _op(data, seg_ids, out, counts, g, point0_idx, tie_axes):
    axes = tuple(tie_axes)
    return route_max_grad_plain(
        data, seg_ids, out, counts, g, point0_idx,
        reduce_ties=(lambda t: collectives.all_reduce(t, axes)) if axes
        else None)


@_op.register_fake
def _(data, seg_ids, out, counts, g, point0_idx, tie_axes):
    return torch.empty_like(data)


_op.register_kernel("cuda")(_cuda)


def segment_max_grad(data: torch.Tensor, seg_ids: torch.Tensor,
                     out: torch.Tensor, counts: torch.Tensor,
                     g: torch.Tensor, point0_idx: torch.Tensor | None = None,
                     tie_axes=()) -> torch.Tensor:
    """Gradient (B, N, C) in ``data``'s type of a segment max of ``data``
    (B, N, C) over ``seg_ids`` (B, N), given its output ``out`` (B, M, C)
    in ``data``'s type, the node ``counts`` (B, M) and the cotangent ``g``
    (B, M, C); the contract of ``route_max_grad_plain``, with
    the tie counts summed over the mesh axes ``tie_axes`` in effect.  On
    the CPU the plain version, on a CUDA device the kernels."""
    same_device("segment_max_grad", data=data, seg_ids=seg_ids, out=out,
                counts=counts, g=g, point0_idx=point0_idx)
    return torch.ops.sonet_torch.segment_max_grad(
        data, seg_ids, out, counts, g, point0_idx, list(tie_axes))


segment_max_grad.launches = 0
