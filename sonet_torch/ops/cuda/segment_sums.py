"""Node recentering's sums over node-sorted rows: the plain version
``segment_sums_plain`` and the CUDA kernel ``csrc/segment_sums.cu`` behind
the same function.

The function is a registered operator, ``sonet_torch::segment_sums``
(``torch.library.custom_op``): its CPU implementation is the plain
version, the one-hot arithmetic the encoder ran before it had the kernel
(the float32 one-hot's column sums and its transposed product with the
rows), so the CPU gives the same bits as that; its CUDA implementation
launches the kernel, one block a (cloud, node) summing that node's run of
rows; its fake implementation gives the (B, M) and (B, M, D) shapes, so
``torch.export`` keeps it as one node of an exported program.  Its
backward routes each node's sum cotangent to the node's rows
(``ops.gather.take_rows``); ``counts`` has no gradient.

``segment_sums`` is the op's checked entry point: it takes the plain
version only for tensors on the CPU; for CUDA tensors the op launches the
kernel or raises; any other device raises.  It never falls back.
``segment_sums.launches`` counts the kernel's launches (in a CUDA graph,
its capture).

The kernel finds each node's run by searching the ids, so on the card the
ids must be sorted in each cloud, as ``nn.encoder``'s sorted pipeline
sorts them; the plain version takes any order.  The kernel adds a node's
rows one after another in their order, as the one-hot product adds them on
the card (cuBLAS's float32 FFMA kernel: one accumulator an output, the
other nodes' rows adding exact zeros), so at the encoder's shapes it gives
that product's bits (``chip_smoke.py`` and the card tests hold it so at
B >= 2; for a single cloud cuBLAS takes another kernel, which adds in
another order); the CPU's product may add in another order too.  The
counts are exact on both.
"""

from __future__ import annotations

import ctypes

import torch

from ..gather import take_rows
from ..pairwise import one_hot
from . import launcher, same_device

DIMS = (2, 3)         # the coordinates a row the kernel takes
_p, _i = ctypes.c_void_p, ctypes.c_int
_kernel = launcher("segment_sums", "sonet_segment_sums",
                   [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p])


def segment_sums_plain(seg_ids: torch.Tensor, x: torch.Tensor,
                       num_segments: int):
    """(counts (B, M), sums (B, M, D)), both float32: the rows of ``x``
    (B, N, D) float32 with ``seg_ids`` (B, N) == node, counted and summed
    through the float32 one-hot (B, N, M); ids outside ``[0, M)`` count
    nowhere.  Any order of the ids."""
    onehot = one_hot(seg_ids, num_segments, torch.float32)
    return onehot.sum(1, dtype=torch.float32), torch.bmm(
        onehot.transpose(1, 2), x)


def _check(seg_ids, x, num_segments):
    """Raises on what the function does not take."""
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_sums: seg_ids dtype {seg_ids.dtype}, want "
                        "int32")
    if x.dtype != torch.float32:
        raise TypeError(f"segment_sums: x dtype {x.dtype}, want float32")
    if (seg_ids.dim() != 2 or x.dim() != 3
            or tuple(x.shape[:2]) != tuple(seg_ids.shape)
            or x.shape[2] not in DIMS):
        raise ValueError(f"segment_sums: seg_ids {tuple(seg_ids.shape)}, x "
                         f"{tuple(x.shape)}; want (B, N) and (B, N, D) with "
                         f"D in {DIMS}")
    B, N, _ = x.shape
    # the kernel indexes rows within a cloud and its blocks with 32-bit ints
    if not 0 <= num_segments < 2 ** 31 or N >= 2 ** 31 \
            or B * num_segments >= 2 ** 31:
        raise ValueError(f"segment_sums: B={B}, N={N}, M={num_segments} out "
                         "of the kernel's range")
    same_device("segment_sums", seg_ids=seg_ids, x=x)


@torch.library.custom_op(
    "sonet_torch::segment_sums", mutates_args=(), device_types="cpu",
    schema="(Tensor seg_ids, Tensor x, int num_segments) -> (Tensor, Tensor)")
def _op(seg_ids, x, num_segments):
    return segment_sums_plain(seg_ids, x, num_segments)


@_op.register_fake
def _(seg_ids, x, num_segments):
    B, _, D = x.shape
    return (x.new_empty((B, num_segments)),
            x.new_empty((B, num_segments, D)))


@_op.register_kernel("cuda")
def _(seg_ids, x, num_segments):
    _check(seg_ids, x, num_segments)
    if not (seg_ids.is_contiguous() and x.is_contiguous()):
        raise ValueError("segment_sums: seg_ids and x must be contiguous")
    B, N, D = x.shape
    counts = torch.empty((B, num_segments), dtype=torch.float32,
                         device=x.device)
    sums = torch.empty((B, num_segments, D), dtype=torch.float32,
                       device=x.device)
    # the C function switches to the tensors' device for its launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _kernel(seg_ids.data_ptr(), x.data_ptr(), counts.data_ptr(),
            sums.data_ptr(), B, N, D, num_segments, x.device.index, stream)
    segment_sums.launches += 1
    return counts, sums


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])
    ctx.mark_non_differentiable(output[0])


def _backward(ctx, g_counts, g_sums):
    (seg_ids,) = ctx.saved_tensors
    return None, take_rows(g_sums, seg_ids), None


_op.register_autograd(_backward, setup_context=_setup_context)


def segment_sums(seg_ids: torch.Tensor, x: torch.Tensor, num_segments: int):
    """(counts (B, M), sums (B, M, D)), both float32: how many rows of
    ``x`` (B, N, D) float32, D = 2 or 3, each node holds by ``seg_ids``
    (B, N) int32, and the sum of their coordinates; an empty node has
    count 0 and sum 0, and ids outside ``[0, M)`` count nowhere.  On the
    CPU the plain version (any order of the ids); on a CUDA device the
    kernel, which needs the ids sorted in each cloud."""
    _check(seg_ids, x, int(num_segments))
    return torch.ops.sonet_torch.segment_sums(seg_ids, x, int(num_segments))


segment_sums.launches = 0
