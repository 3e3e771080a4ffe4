"""The train step's three sorts as exact selections and counting sorts: the
plain versions and the CUDA kernels of ``csrc/sorts.cu`` behind the same
functions.

* ``node_sort(ids, M)``: a stable sort of each cloud's node ids (B, L) in
  [0, M), M up to ``NODE_SORT_MAX_NODES``: the sorted ids, the permutation
  both ways and the sorted position of each cloud's point 0 (the encoder's
  sorted pipeline);
* ``smallest_k(d, k)``: the k smallest of each row of d (..., L) and their
  columns, k up to ``SMALLEST_K_MAX`` (the top-k assignment of points to
  nodes and the kNN of the nodes, ``ops.pairwise``);
* ``subset_select(keys, n)``: the first n indices of a stable argsort of
  each row of keys (B, L), L up to ``SUBSET_MAX_KEYS`` (the device
  pipeline's subsample, ``data.device_pipeline.apply_sample``); fastest
  for keys spread over [0, 1), as the subsample's uniform draws are.

Each returns exactly what the stable ``torch.sort`` / ``argsort`` it
replaces gives: ascending, -0.0 equal to +0.0, every NaN after +inf and
equal to every other NaN, equal values in index order.  The values
``smallest_k`` returns are the input's own bits.

Each is a registered operator (``sonet_torch::node_sort``,
``sonet_torch::smallest_k``, ``sonet_torch::subset_select``,
``torch.library.custom_op``): its CPU implementation is the plain version,
the ``torch.sort`` / ``argsort`` code its caller ran before it had the
kernel, so the CPU gives the same bits as that; its CUDA implementation
launches the kernels; its fake implementation gives the output shapes, so
``torch.export`` keeps it as one node of an exported program.  The entry
point of the same name takes the plain version only for tensors on the
CPU; for CUDA tensors the op launches the kernels or raises; any other
device raises.  It never falls back.  ``node_sort.launches``,
``smallest_k.launches`` and ``subset_select.launches`` count the CUDA
calls (in a CUDA graph, its capture): one launch of ``smallest_k_sort`` a
call, two (``counting_sort_count``, ``counting_sort_place``) a node sort,
three (those and ``subset_sort_rank``) a subset selection.  Above its size
limit a caller keeps the full sort: that is a rule by shape, in the
caller's docstring.
"""

from __future__ import annotations

import ctypes

import torch

from . import launcher, same_device

SMALLEST_K_MAX = 16                # smallest_k's largest k
NODE_SORT_MAX_NODES = 1024         # node_sort's largest M
SUBSET_MAX_KEYS = 65535 * 256      # subset_select's longest row (its grid)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_smallest_k = launcher("sorts", "sonet_smallest_k",
                       [_p, _p, _p, _ll, _i, _i, _i, _p])
_node_sort = launcher("sorts", "sonet_node_sort",
                      [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p])
_subset_select = launcher("sorts", "sonet_subset_select",
                          [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p])
# the tiles of a row and the subset sort's buckets, for the scratch
_tiles = launcher("sorts", "sonet_sort_tiles", [_i], query=True)
_buckets = launcher("sorts", "sonet_subset_buckets", [_i], query=True)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _contiguous(op: str, *tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op}: the input must be contiguous")


# ---------------------------------------------------------------------------
# node_sort
# ---------------------------------------------------------------------------

def node_sort_plain(ids: torch.Tensor, num_nodes: int):
    """(sorted ids (B, L) int32, perm (B, L) int64, inv_perm (B, L) int64,
    point0_idx (B,) int64): the stable sort of each cloud's ids, ``perm``
    taking a sorted position to its index and ``inv_perm`` back, and
    point 0's sorted position, found as the first slot of its node (the
    sort is stable and point 0 is its node's first point)."""
    sorted_ids, perm = torch.sort(ids, dim=1, stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm.scatter_(1, perm, torch.arange(
        perm.shape[1], device=perm.device).expand_as(perm))
    point0_idx = torch.searchsorted(sorted_ids, ids[:, :1].contiguous(),
                                    side="left")[:, 0]
    return sorted_ids, perm, inv_perm, point0_idx


def _check_node_sort(ids, num_nodes):
    if ids.dtype != torch.int32:
        raise TypeError(f"node_sort: ids dtype {ids.dtype}, want int32")
    if ids.dim() != 2 or ids.shape[1] < 1:
        raise ValueError(f"node_sort: ids {tuple(ids.shape)}; want (B, L), "
                         "L >= 1")
    if not 1 <= num_nodes <= NODE_SORT_MAX_NODES or ids.shape[0] >= 2 ** 31 \
            or ids.shape[1] > 65535 * 1024:
        raise ValueError(f"node_sort: ids {tuple(ids.shape)}, M={num_nodes} "
                         f"out of the kernel's range (M up to "
                         f"{NODE_SORT_MAX_NODES})")
    same_device("node_sort", ids=ids)


@torch.library.custom_op(
    "sonet_torch::node_sort", mutates_args=(), device_types="cpu",
    schema="(Tensor ids, int num_nodes) -> (Tensor, Tensor, Tensor, Tensor)")
def _node_sort_op(ids, num_nodes):
    return node_sort_plain(ids, num_nodes)


@_node_sort_op.register_fake
def _(ids, num_nodes):
    B, L = ids.shape
    return (ids.new_empty((B, L)), ids.new_empty((B, L), dtype=torch.int64),
            ids.new_empty((B, L), dtype=torch.int64),
            ids.new_empty((B,), dtype=torch.int64))


@_node_sort_op.register_kernel("cuda")
def _(ids, num_nodes):
    _check_node_sort(ids, num_nodes)
    _contiguous("node_sort", ids)
    B, L = ids.shape
    sorted_ids = torch.empty_like(ids)
    perm = torch.empty((B, L), dtype=torch.int64, device=ids.device)
    inv_perm = torch.empty_like(perm)
    point0_idx = torch.empty((B,), dtype=torch.int64, device=ids.device)
    counts = torch.empty((B, _tiles(L), num_nodes), dtype=torch.int32,
                         device=ids.device)
    _node_sort(ids.data_ptr(), sorted_ids.data_ptr(), perm.data_ptr(),
               inv_perm.data_ptr(), point0_idx.data_ptr(), counts.data_ptr(),
               B, L, num_nodes, ids.device.index, _stream(ids))
    node_sort.launches += 1
    return sorted_ids, perm, inv_perm, point0_idx


def node_sort(ids: torch.Tensor, num_nodes: int):
    """(sorted ids (B, L) int32, perm (B, L) int64, inv_perm (B, L) int64,
    point0_idx (B,) int64) of node ids ``ids`` (B, L) int32 in
    ``[0, num_nodes)``, 1 <= num_nodes <= ``NODE_SORT_MAX_NODES``, L >= 1:
    a stable sort of each cloud's ids, as ``node_sort_plain``.  On the CPU
    the plain version; on a CUDA device the counting-sort kernels, for
    which an id outside ``[0, num_nodes)`` gives no sort (it is placed with
    the nearest node)."""
    _check_node_sort(ids, int(num_nodes))
    return torch.ops.sonet_torch.node_sort(ids, int(num_nodes))


node_sort.launches = 0


# ---------------------------------------------------------------------------
# smallest_k
# ---------------------------------------------------------------------------

def smallest_k_plain(d: torch.Tensor, k: int):
    """(values (..., k), indices (..., k) int64): the first k columns of a
    stable ascending sort of each row of ``d``."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def _check_smallest_k(d, k):
    if d.dtype != torch.float32:
        raise TypeError(f"smallest_k: d dtype {d.dtype}, want float32")
    if d.dim() < 1 or not 1 <= k <= min(SMALLEST_K_MAX, d.shape[-1]):
        raise ValueError(f"smallest_k: d {tuple(d.shape)}, k={k}; want "
                         f"1 <= k <= min(L, {SMALLEST_K_MAX})")
    if d.shape[-1] >= 2 ** 31:
        raise ValueError(f"smallest_k: rows of {d.shape[-1]} out of the "
                         "kernel's range")
    same_device("smallest_k", d=d)


@torch.library.custom_op(
    "sonet_torch::smallest_k", mutates_args=(), device_types="cpu",
    schema="(Tensor d, int k) -> (Tensor, Tensor)")
def _smallest_k_op(d, k):
    return smallest_k_plain(d, k)


@_smallest_k_op.register_fake
def _(d, k):
    shape = (*d.shape[:-1], k)
    return d.new_empty(shape), d.new_empty(shape, dtype=torch.int64)


@_smallest_k_op.register_kernel("cuda")
def _(d, k):
    _check_smallest_k(d, k)
    _contiguous("smallest_k", d)
    shape = (*d.shape[:-1], k)
    vals = torch.empty(shape, dtype=d.dtype, device=d.device)
    idx = torch.empty(shape, dtype=torch.int64, device=d.device)
    L = d.shape[-1]
    _smallest_k(d.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                d.numel() // L, L, k, d.device.index, _stream(d))
    smallest_k.launches += 1
    return vals, idx


def _smallest_k_setup(ctx, inputs, output):
    ctx.shape = inputs[0].shape
    ctx.save_for_backward(output[1])
    ctx.mark_non_differentiable(output[1])


def _smallest_k_backward(ctx, g_vals, g_idx):
    # as torch.sort's: each value's cotangent back to its column
    (idx,) = ctx.saved_tensors
    return g_vals.new_zeros(ctx.shape).scatter_(-1, idx, g_vals), None


_smallest_k_op.register_autograd(_smallest_k_backward,
                                 setup_context=_smallest_k_setup)


def smallest_k(d: torch.Tensor, k: int):
    """(values (..., k) float32, indices (..., k) int64): the k smallest
    entries of each row of ``d`` (..., L) float32 and their columns,
    1 <= k <= min(L, ``SMALLEST_K_MAX``), in the order of a stable
    ascending sort, as ``smallest_k_plain``.  On the CPU the plain version;
    on a CUDA device the selection kernel.  The values carry ``d``'s
    gradient to their columns."""
    _check_smallest_k(d, int(k))
    return torch.ops.sonet_torch.smallest_k(d, int(k))


smallest_k.launches = 0


# ---------------------------------------------------------------------------
# subset_select
# ---------------------------------------------------------------------------

def subset_select_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64: the first n indices of a stable ascending argsort of
    each row of ``keys``."""
    return torch.argsort(keys, dim=1, stable=True)[:, :n].contiguous()


def _check_subset_select(keys, n):
    if keys.dtype != torch.float32:
        raise TypeError(f"subset_select: keys dtype {keys.dtype}, want "
                        "float32")
    if keys.dim() != 2 or not 1 <= keys.shape[1] <= SUBSET_MAX_KEYS \
            or not 0 <= n <= keys.shape[1] or keys.shape[0] >= 2 ** 31:
        raise ValueError(f"subset_select: keys {tuple(keys.shape)}, n={n}; "
                         f"want (B, L), 1 <= L <= {SUBSET_MAX_KEYS}, "
                         "0 <= n <= L")
    same_device("subset_select", keys=keys)


@torch.library.custom_op(
    "sonet_torch::subset_select", mutates_args=(), device_types="cpu",
    schema="(Tensor keys, int n) -> Tensor")
def _subset_select_op(keys, n):
    return subset_select_plain(keys, n)


@_subset_select_op.register_fake
def _(keys, n):
    return keys.new_empty((keys.shape[0], n), dtype=torch.int64)


@_subset_select_op.register_kernel("cuda")
def _(keys, n):
    _check_subset_select(keys, n)
    _contiguous("subset_select", keys)
    B, L = keys.shape
    out = torch.empty((B, n), dtype=torch.int64, device=keys.device)
    nb = _buckets(L)
    scratch = [torch.empty(shape, dtype=torch.int32, device=keys.device)
               for shape in ((B, _tiles(L), nb), (B, L), (B, L),
                             (B, nb + 1))]
    _subset_select(keys.data_ptr(), out.data_ptr(),
                   *(t.data_ptr() for t in scratch), B, L, n,
                   keys.device.index, _stream(keys))
    subset_select.launches += 1
    return out


def subset_select(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64: the first ``n`` indices of a stable ascending argsort
    of each row of ``keys`` (B, L) float32, 1 <= L <= ``SUBSET_MAX_KEYS``,
    0 <= n <= L, as ``subset_select_plain``.  On the CPU the plain version;
    on a CUDA device the kernels: a counting sort into buckets of the keys'
    values, then a rank within each bucket."""
    _check_subset_select(keys, int(n))
    return torch.ops.sonet_torch.subset_select(keys, int(n))


subset_select.launches = 0
