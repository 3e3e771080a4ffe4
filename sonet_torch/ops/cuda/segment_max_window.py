"""Windowed segment max: the CUDA kernel ``csrc/segment_max_window.cu``
behind the same function as the JAX package's Pallas kernel
``ops/pallas/segment_max_window.py:windowed_vals``, plus its plain
PyTorch version.

The function is a registered operator, ``sonet_torch::windowed_vals``
(``torch.library.custom_op``): its CPU implementation is the plain
version, its CUDA implementation launches the kernel, and its fake
implementation gives the (B, M, C) float32 shape, so ``torch.export``
traces a model through it and keeps it as one node of the exported
program.  ``windowed_vals`` is the op's checked entry point: it takes the
plain version only for tensors on the CPU; for CUDA tensors the op
launches the kernel or raises; any other device raises.  It never falls
back.  ``windowed_vals.launches`` counts the kernel's launches (in a CUDA
graph, its capture).

The source holds two kernels for the one function.  ``kernel_path`` says
which one an input takes, by its shape and alignment alone: ``"bulk"``
(persistent blocks fed by bulk asynchronous copies through a ring in
shared memory; the main path's inputs take it) or ``"direct"`` (loads
straight from global memory, for every other input).
"""

from __future__ import annotations

import ctypes

import torch

from ..segment import segment_counts
from . import load

NEG = -3.0e38
_BLOCK_M = 8          # nodes per pass of the plain version
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BULK_ROW_BYTES = (256, 2048)     # a row the bulk kernel takes, in bytes
_fn = None


def windowed_vals_plain(data: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: f32 (B, M, C) per-node maxima of ``data``
    (B, N, C) over the points with ``seg_ids`` (B, N) == node, -3e38 for
    an empty node; ids outside ``[0, M)`` are ignored.  A masked max over
    a few nodes at a time."""
    B, N, C = data.shape
    M = num_segments
    out = torch.full((B, M, C), NEG, dtype=torch.float32, device=data.device)
    if N == 0:
        return out
    x = data.float()[:, :, None, :]                       # (B, N, 1, C)
    neg = torch.tensor(NEG, dtype=torch.float32, device=data.device)
    for m0 in range(0, M, _BLOCK_M):
        mids = torch.arange(m0, min(m0 + _BLOCK_M, M), device=data.device,
                            dtype=seg_ids.dtype)
        member = (seg_ids[:, :, None] == mids)[..., None]  # (B, N, bm, 1)
        out[:, m0:m0 + _BLOCK_M] = torch.where(member, x, neg).amax(1)
    # an all -inf node reads -3e38 in the kernel too (it starts there)
    return out.clamp_min_(NEG)


def kernel_path(data: torch.Tensor) -> str:
    """Which kernel ``windowed_vals`` launches for ``data`` (B, N, C) on
    the card: ``"bulk"`` if a row is a multiple of 16 bytes between 256
    and 2048 and the storage starts on a 16-byte boundary, as a bulk
    asynchronous copy needs, else ``"direct"``.  The same rule as
    ``bulk_path`` in ``csrc/segment_max_window.cu``; nothing else, and no
    error caught, chooses."""
    row = data.shape[-1] * data.element_size()
    lo, hi = _BULK_ROW_BYTES
    aligned = row % 16 == 0 and data.data_ptr() % 16 == 0
    return "bulk" if aligned and lo <= row <= hi else "direct"


def _kernel():
    global _fn
    if _fn is None:
        fn = load("segment_max_window").sonet_segment_max_window
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def windowed_vals(data: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """f32 (B, M, C) per-node maxima, empty nodes at -3e38 (callers patch
    empties; see ``segment_max_windowed`` and ``ops.segment_fast``).

    data (B, N, C) bf16 or f32, contiguous; seg_ids (B, N) int32, sorted
    for speed, any order for correctness.  Both on the CPU (the plain
    version) or both on one CUDA device (the kernel).
    """
    dev, ids_dev = data.device, seg_ids.device
    if not (dev == ids_dev and dev.type in ("cpu", "cuda")):
        raise ValueError(f"windowed_vals: data on {dev} and seg_ids on "
                         f"{ids_dev}; both must be on one CUDA device (or "
                         "both on the CPU)")
    return torch.ops.sonet_torch.windowed_vals(data, seg_ids,
                                               int(num_segments))


windowed_vals.launches = 0


@torch.library.custom_op(
    "sonet_torch::windowed_vals", mutates_args=(), device_types="cpu",
    schema="(Tensor data, Tensor seg_ids, int num_segments) -> Tensor")
def _op(data, seg_ids, num_segments):
    return windowed_vals_plain(data, seg_ids, num_segments)


@_op.register_fake
def _(data, seg_ids, num_segments):
    B, _, C = data.shape
    return data.new_empty((B, num_segments, C), dtype=torch.float32)


@_op.register_kernel("cuda")
def _(data, seg_ids, num_segments):
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"windowed_vals: data dtype {data.dtype}, want "
                        "float32 or bfloat16")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"windowed_vals: seg_ids dtype {seg_ids.dtype}, "
                        "want int32")
    if data.dim() != 3 or tuple(seg_ids.shape) != tuple(data.shape[:2]):
        raise ValueError(f"windowed_vals: data {tuple(data.shape)} and "
                         f"seg_ids {tuple(seg_ids.shape)}; want (B, N, C) "
                         "and (B, N)")
    if not (data.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("windowed_vals: data and seg_ids must be contiguous")
    if seg_ids.device != data.device:
        raise ValueError(f"windowed_vals: data on {data.device} and seg_ids "
                         f"on {seg_ids.device}; want one CUDA device")
    B, N, C = data.shape
    M = int(num_segments)
    # the kernels index rows (B * N) and channels with 32-bit ints
    if B * N >= 2 ** 31 or C >= 2 ** 24 or not 0 <= M < 2 ** 31:
        raise ValueError(f"windowed_vals: B={B}, N={N}, C={C}, M={M} out of "
                         "the kernel's range")
    out = torch.empty((B, M, C), dtype=torch.float32, device=data.device)
    # the C function switches to the tensors' device for its launches
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _kernel()(data.data_ptr(), _DTYPE_CODE[data.dtype],
                    seg_ids.data_ptr(), out.data_ptr(), B, N, C, M,
                    data.device.index, stream)
    if err != 0:
        raise RuntimeError(f"segment_max_window kernel launch failed: "
                           f"cudaError {err}")
    windowed_vals.launches += 1
    return out


def segment_max_windowed(data: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int,
                         counts: torch.Tensor | None = None) -> torch.Tensor:
    """Segment max values (B, M, C) in ``data.dtype``; an empty node takes
    data[:, 0].  ``counts`` (B, M) may be passed to skip recounting."""
    vals = windowed_vals(data, seg_ids, num_segments)
    if counts is None:
        counts = segment_counts(seg_ids, num_segments)
    empty = (counts == 0)[..., None]
    return torch.where(empty, data[:, 0:1, :].float(), vals).to(data.dtype)
