"""Segment argmax: the CUDA kernel ``csrc/segment_argmax.cu`` behind the
same function as the JAX package's Pallas kernel
``ops/pallas/segment_argmax.py:segment_argmax``, plus its plain PyTorch
version and the value form (the counterpart of ``segment_max_pallas``).

``segment_argmax`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
``segment_argmax.launches`` counts the kernel's launches.  No path of the
model calls it: it is the reference's ``index_max`` semantics (first
maximum wins), kept beside the windowed kernel as a cross-check.
"""

from __future__ import annotations

import ctypes

import torch

from . import load

NEG = -3.0e38
_BLOCK_M = 8          # nodes per pass of the plain version
_fn = None


def segment_argmax_plain(data: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Plain PyTorch version: int32 (B, M, C), for each node and channel
    the lowest position n with ``seg_ids[b, n] == m`` whose value is the
    node's maximum; 0 for an empty node or one with no value above -3e38.
    Ids outside ``[0, M)`` are ignored.  A masked max and a masked min of
    positions over a few nodes at a time."""
    B, N, C = data.shape
    M = num_segments
    out = torch.zeros((B, M, C), dtype=torch.int32, device=data.device)
    if N == 0:
        return out
    x = data.float()[:, :, None, :]                       # (B, N, 1, C)
    pos = torch.arange(N, dtype=torch.int32,
                       device=data.device)[None, :, None, None]
    for m0 in range(0, M, _BLOCK_M):
        mids = torch.arange(m0, min(m0 + _BLOCK_M, M), device=data.device,
                            dtype=seg_ids.dtype)
        member = (seg_ids[:, :, None] == mids)[..., None]  # (B, N, bm, 1)
        masked = torch.where(member, x, float("-inf"))
        best = masked.amax(1, keepdim=True)                # (B, 1, bm, C)
        won = member & (masked == best) & (best > NEG)
        first = torch.where(won, pos, N).amin(1)           # (B, bm, C)
        out[:, m0:m0 + _BLOCK_M] = torch.where(first < N, first, 0)
    return out


def _kernel():
    global _fn
    if _fn is None:
        fn = load("segment_argmax").sonet_segment_argmax
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_argmax(data: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """int32 (B, M, C) index of the first maximum per node and channel;
    0 for an empty node (see ``segment_argmax_plain``).

    data (B, N, C) float32, contiguous; seg_ids (B, N) int32, sorted for
    speed, any order for correctness.  Not differentiable.
    """
    if data.device.type == "cpu" and seg_ids.device.type == "cpu":
        return segment_argmax_plain(data, seg_ids, num_segments)
    if data.device.type != "cuda" or seg_ids.device != data.device:
        raise ValueError(f"segment_argmax: data on {data.device} and seg_ids "
                         f"on {seg_ids.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    if data.dtype != torch.float32:
        raise TypeError(f"segment_argmax: data dtype {data.dtype}, want "
                        "float32")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_argmax: seg_ids dtype {seg_ids.dtype}, "
                        "want int32")
    if data.dim() != 3 or tuple(seg_ids.shape) != tuple(data.shape[:2]):
        raise ValueError(f"segment_argmax: data {tuple(data.shape)} and "
                         f"seg_ids {tuple(seg_ids.shape)}; want (B, N, C) "
                         "and (B, N)")
    if not (data.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_argmax: data and seg_ids must be contiguous")
    B, N, C = data.shape
    M = int(num_segments)
    if B > 65535 or N > 64 * 65535 or max(C, M) >= 2 ** 31 or M < 0:
        raise ValueError(f"segment_argmax: B={B}, N={N}, C={C}, M={M} out of "
                         "the kernel's range")
    keys = torch.empty((B, M, C), dtype=torch.int64, device=data.device)
    out = torch.empty((B, M, C), dtype=torch.int32, device=data.device)
    fn = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), seg_ids.data_ptr(), keys.data_ptr(),
                 out.data_ptr(), B, N, C, M, stream)
    if err != 0:
        raise RuntimeError(f"segment_argmax kernel launch failed: "
                           f"cudaError {err}")
    segment_argmax.launches += 1
    return out


segment_argmax.launches = 0


def segment_max_argmax(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment max values (B, M, C) in ``data.dtype`` as a gather through
    ``segment_argmax`` (empty node -> data[:, 0]).  Its gradient is the
    gather's: a (B, M, C) scatter-add into the winning rows."""
    idx = segment_argmax(data.detach().float().contiguous(), seg_ids,
                         num_segments)
    return torch.gather(data, 1, idx.long())
