"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both.  The JAX
package's Pallas kernel runs in interpret mode, as tests/test_kernels.py
runs it.  The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import ops as jops
from sonet_tpu.ops.pallas.segment_argmax import (
    segment_argmax as j_segment_argmax,
    segment_max_pallas as j_segment_max_pallas)
from sonet_tpu.ops.pallas.segment_max_window import (
    segment_max_windowed as j_segment_max_windowed,
    windowed_vals as j_windowed_vals)
from sonet_tpu.ops.segment import route_max_grad as j_route_max_grad
from sonet_tpu.ops.segment_fast import segment_max_fast as j_segment_max_fast
from sonet_torch import ops as tops
from sonet_torch.ops.cuda import segment_argmax as tsam
from sonet_torch.ops.cuda import segment_max_window as tsmw

torch.set_num_threads(2)

# f32 distances: both sides compute |a|^2 + |b|^2 - 2ab in f32, with the
# three-term dot product summed in another order
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _seg_case(B=2, N=70, C=9, M=8, seed=0, sorted_ids=True, empty=(3,)):
    rs = np.random.RandomState(seed)
    data = rs.randn(B, N, C).astype(np.float32)
    ids = rs.randint(0, M, (B, N)).astype(np.int32)
    for e in empty:
        ids[ids == e] = (e + 1) % M
    if sorted_ids:
        ids = np.sort(ids, axis=1)
    return data, ids


class TestPairwise:
    def test_pairwise_sqdist(self):
        rs = np.random.RandomState(0)
        a = rs.randn(3, 40, 3).astype(np.float32)
        b = rs.randn(3, 17, 3).astype(np.float32)
        np.testing.assert_allclose(
            tops.pairwise_sqdist(_t(a), _t(b)).numpy(),
            np.asarray(jops.pairwise_sqdist(a, b)), **DIST_TOL)

    def test_pairwise_sqdist_clamped_at_zero(self):
        a = np.full((1, 4, 3), 1e3, np.float32)
        d = tops.pairwise_sqdist(_t(a), _t(a))
        assert float(d.min()) >= 0.0

    def test_knn_self_first_and_order(self):
        rs = np.random.RandomState(1)
        pts = rs.randn(2, 64, 3).astype(np.float32)
        got = tops.knn(_t(pts), 9).numpy()
        want = np.asarray(jops.knn(pts, 9))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[..., 0],
                                      np.tile(np.arange(64), (2, 1)))
        assert got.dtype == np.int32

    def test_knn_ties_go_to_lower_index(self):
        # a 4x4 grid: every interior node has four neighbours at the same
        # distance, so the order among them is decided by index alone
        g = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0),
                                 indexing="ij"), -1).reshape(1, 16, 2)
        pts = np.concatenate([g, np.zeros((1, 16, 1))], -1).astype(np.float32)
        got = tops.knn(_t(pts), 5).numpy()
        np.testing.assert_array_equal(got, np.asarray(jops.knn(pts, 5)))
        # node 5 = (1, 1): neighbours 1, 4, 6, 9 at distance 1, ascending
        np.testing.assert_array_equal(got[0, 5], [5, 1, 4, 6, 9])

    def test_knn_with_queries(self):
        rs = np.random.RandomState(2)
        pts = rs.randn(2, 30, 3).astype(np.float32)
        q = rs.randn(2, 11, 3).astype(np.float32)
        np.testing.assert_array_equal(
            tops.knn(_t(pts), 4, queries=_t(q)).numpy(),
            np.asarray(jops.knn(pts, 4, queries=q)))

    @pytest.mark.parametrize("k", [1, 3])
    def test_assign_topk(self, k):
        rs = np.random.RandomState(3)
        x = rs.randn(2, 50, 3).astype(np.float32)
        nodes = np.concatenate([rs.randn(2, 15, 3),
                                np.full((2, 1, 3), 50.0)], 1).astype(np.float32)
        got = tops.assign_topk(_t(x), _t(nodes), k)
        want = jops.assign_topk(x, nodes, k)
        np.testing.assert_array_equal(got.min_idx.numpy(),
                                      np.asarray(want.min_idx))
        np.testing.assert_array_equal(got.mask_row_max.numpy(),
                                      np.asarray(want.mask_row_max))
        np.testing.assert_allclose(got.sqdist.numpy(),
                                   np.asarray(want.sqdist), **DIST_TOL)
        assert not got.mask_row_max.numpy()[:, 15].any()  # far node empty

    def test_assign_topk_ties(self):
        # two nodes at the same place: the lower index wins the tie
        x = np.zeros((1, 5, 3), np.float32)
        nodes = np.ones((1, 4, 3), np.float32)
        got = tops.assign_topk(_t(x), _t(nodes), 2).min_idx.numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jops.assign_topk(x, nodes, 2).min_idx))
        np.testing.assert_array_equal(got[0], [0] * 5 + [1] * 5)

    def test_one_hot_f32_out_of_range(self):
        idx = np.array([[0, 2, 5, -1]], np.int32)
        np.testing.assert_array_equal(tops.one_hot_f32(_t(idx), 3).numpy(),
                                      np.asarray(jops.one_hot_f32(idx, 3)))


class TestGatherAndCounts:
    def test_knn_gather(self):
        rs = np.random.RandomState(4)
        data = rs.randn(2, 10, 5).astype(np.float32)
        idx = rs.randint(0, 10, (2, 7, 3)).astype(np.int32)
        np.testing.assert_array_equal(
            tops.knn_gather(_t(data), _t(idx)).numpy(),
            np.asarray(jops.knn_gather(data, idx)))

    def test_segment_counts(self):
        _, ids = _seg_case(sorted_ids=False)
        got = tops.segment_counts(_t(ids), 8)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.segment_counts(ids, 8)))
        assert got.dtype == torch.int32

    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_segment_max_scatter_forward(self, sorted_ids):
        data, ids = _seg_case(sorted_ids=sorted_ids)
        np.testing.assert_array_equal(
            tops.segment_max(_t(data), _t(ids), 8).numpy(),
            np.asarray(jops.segment_max(data, ids, 8)))


class TestWindowedVals:
    """The plain ``windowed_vals`` equals the JAX package's Pallas kernel
    (interpret mode) exactly: a max is exact in any order."""

    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_matches_pallas(self, sorted_ids):
        data, ids = _seg_case(sorted_ids=sorted_ids)
        want = j_windowed_vals(data, ids, 8, window=4, block_n=16,
                               block_c=8, interpret=True)
        got = tops.windowed_vals(_t(data), _t(ids), 8)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_ragged_n_and_empty_nodes(self):
        # N = 70 is not a multiple of block_n = 32; nodes 3 and 6 empty
        data, ids = _seg_case(N=70, C=12, sorted_ids=True, empty=(3, 6))
        want = np.asarray(j_windowed_vals(data, ids, 8, window=8,
                                          block_n=32, block_c=12,
                                          interpret=True))
        got = tops.windowed_vals(_t(data), _t(ids), 8).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, [3, 6]] == np.float32(-3e38)).all()

    def test_bf16_input(self):
        data, ids = _seg_case(N=96, C=16, seed=5)
        data_bf = jnp.asarray(data, jnp.bfloat16)
        want = j_windowed_vals(data_bf, ids, 8, window=8, block_n=32,
                               block_c=16, interpret=True)
        t_bf = _t(data).to(torch.bfloat16)
        got = tops.windowed_vals(t_bf, _t(ids), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_segment_max_windowed(self, dtype):
        data, ids = _seg_case(sorted_ids=False, seed=6)
        jd = jnp.asarray(data, dtype)
        want = j_segment_max_windowed(jd, ids, 8, window=4, block_n=16,
                                      block_c=8, interpret=True)
        td = _t(data).to(getattr(torch, dtype))
        got = tops.segment_max_windowed(td, _t(ids), 8)
        assert got.dtype == td.dtype
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want, np.float32))

    def test_out_of_range_ids_ignored(self):
        data, ids = _seg_case(seed=7)
        bad = ids.copy()
        bad[:, ::5] = 99
        keep = ids.copy()
        got = tops.windowed_vals(_t(data), _t(bad), 8).numpy()
        mask = bad != 99
        ref = np.full((2, 8, 9), np.float32(-3e38))
        for b in range(2):
            for n in np.nonzero(mask[b])[0]:
                ref[b, keep[b, n]] = np.maximum(ref[b, keep[b, n]],
                                                data[b, n])
        np.testing.assert_array_equal(got, ref)

    def test_cuda_path_never_falls_back(self):
        # a tensor that is not on the CPU must reach the kernel or raise;
        # the meta device stands in for a non-CPU tensor here
        data = torch.empty(1, 4, 2, device="meta")
        ids = torch.empty(1, 4, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tsmw.windowed_vals(data, ids, 3)
        assert tsmw.windowed_vals.launches == 0


def _adversarial_case(name):
    """Small inputs shaped like the cases the CUDA kernel is held to on
    the card (``chip_smoke.kernel1_cases``), as (data, ids, M); the JAX
    kernel runs them with chunks of 16 points."""
    rs = np.random.RandomState(11)
    if name == "one_node_a_cloud":       # the same id across a cloud boundary
        ids = np.repeat(np.array([[5], [5], [7]], np.int32), 50, axis=1)
        return rs.randn(3, 50, 12).astype(np.float32), ids, 8
    if name == "n_below_a_chunk":
        return (rs.randn(3, 7, 12).astype(np.float32),
                np.sort(rs.randint(0, 8, (3, 7)), axis=1).astype(np.int32), 8)
    if name == "runs_of_one_chunk":      # run, chunk and cloud edges meet
        ids = np.tile((np.arange(64) // 16).astype(np.int32), (2, 1))
        return rs.randn(2, 64, 12).astype(np.float32), ids, 4
    if name == "unsorted":
        return (rs.randn(2, 80, 12).astype(np.float32),
                rs.randint(0, 8, (2, 80)).astype(np.int32), 8)
    if name == "ids_past_m_sorted":
        return (rs.randn(2, 80, 12).astype(np.float32),
                np.sort(rs.randint(0, 12, (2, 80)), axis=1).astype(np.int32),
                8)
    if name == "ids_past_m_unsorted":
        return (rs.randn(2, 80, 12).astype(np.float32),
                rs.randint(0, 12, (2, 80)).astype(np.int32), 8)
    if name == "ragged_n":
        return (rs.randn(3, 37, 12).astype(np.float32),
                np.sort(rs.randint(0, 8, (3, 37)), axis=1).astype(np.int32), 8)
    assert name == "zeros_and_neg_inf"
    data = rs.randn(2, 64, 12).astype(np.float32)
    ids = np.sort(rs.randint(0, 8, (2, 64)), axis=1).astype(np.int32)
    data[ids == 1] = -np.inf               # a node of -inf alone: -3e38
    data[ids == 2] = -0.0
    data[ids == 3] = np.where(rs.randn(2, 64, 12) > 0, 0.0, -0.0)[ids == 3]
    data[:, ::5, ::3] = -np.inf
    return data, ids, 8


ADVERSARIAL = ["one_node_a_cloud", "n_below_a_chunk", "runs_of_one_chunk",
               "unsorted", "ids_past_m_sorted", "ids_past_m_unsorted",
               "ragged_n", "zeros_and_neg_inf"]


class TestWindowedValsAdversarial:
    """The inputs that are hard for the CUDA kernel's ring of tiles, at a
    small size: the plain version (what ``windowed_vals`` runs on the CPU)
    equals the JAX package's Pallas kernel (interpret mode) exactly."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", ADVERSARIAL)
    def test_matches_pallas(self, name, dtype):
        data, ids, M = _adversarial_case(name)
        want = np.asarray(j_windowed_vals(
            jnp.asarray(data, dtype), ids, M, window=8, block_n=16,
            block_c=12, interpret=True))
        got = tops.windowed_vals(_t(data).to(_tdt(dtype)), _t(ids), M).numpy()
        np.testing.assert_array_equal(got, want)     # -0.0 == 0.0
        assert (got >= np.float32(-3e38)).all()      # -inf never comes out
        if name == "zeros_and_neg_inf":
            assert (ids == 1).any()
            assert (got[:, 1] == np.float32(-3e38)).all()

    def test_negative_ids_ignored(self):
        data, ids, M = _adversarial_case("unsorted")
        bad = ids.copy()
        bad[:, ::3] = -2
        got = tops.windowed_vals(_t(data), _t(bad), M).numpy()
        ref = np.full((2, M, 12), np.float32(-3e38))
        for b in range(2):
            for n in np.nonzero(bad[b] >= 0)[0]:
                ref[b, bad[b, n]] = np.maximum(ref[b, bad[b, n]], data[b, n])
        np.testing.assert_array_equal(got, ref)


def _view_at(dtype, C, offset):
    """A contiguous (2, 5, C) tensor whose storage starts ``offset``
    elements past an aligned allocation."""
    flat = torch.zeros(2 * 5 * C + offset, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:].view(2, 5, C)


@pytest.mark.parametrize("dtype,C,offset,want", [
    (torch.bfloat16, 384, 0, "bulk"),       # the main path: 768-byte rows
    (torch.float32, 384, 0, "bulk"),        # 1536 bytes
    (torch.bfloat16, 128, 0, "bulk"),       # 256 bytes, the least
    (torch.float32, 512, 0, "bulk"),        # 2048 bytes, the most
    (torch.bfloat16, 136, 0, "bulk"),       # 272 bytes, a multiple of 16
    (torch.float32, 384, 4, "bulk"),        # a view 16 bytes in
    (torch.bfloat16, 33, 0, "direct"),      # odd C
    (torch.float32, 33, 0, "direct"),
    (torch.bfloat16, 132, 0, "direct"),     # 264 bytes, no multiple of 16
    (torch.bfloat16, 64, 0, "direct"),      # 128 bytes, under the least
    (torch.float32, 516, 0, "direct"),      # 2064 bytes, over the most
    (torch.bfloat16, 2048, 0, "direct"),    # 4096 bytes
    (torch.bfloat16, 384, 1, "direct"),     # a view 2 bytes in
    (torch.float32, 384, 1, "direct"),      # a view 4 bytes in
    (torch.bfloat16, 384, 4, "direct"),     # a view 8 bytes in
])
def test_kernel_path(dtype, C, offset, want):
    data = _view_at(dtype, C, offset)
    assert data.is_contiguous()
    assert tsmw.kernel_path(data) == want
    # the choice is by shape and alignment alone: not by the values, the
    # ids or the number of rows
    assert tsmw.kernel_path(data[:1, :1]) == want


class TestSegmentMaxFast:
    def test_matches_jax_sorted(self):
        data, ids = _seg_case(N=96, C=24, seed=1)
        want = j_segment_max_fast(data, ids, 8, block_n=32)
        got = tops.segment_max_fast(_t(data), _t(ids), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_empty_patch_through_point0_idx(self, dtype):
        rs = np.random.RandomState(2)
        B, N, C, M = 2, 32, 8, 6
        data = rs.randn(B, N, C).astype(np.float32)
        ids = np.sort(rs.choice([0, 1, 2, 4, 5], (B, N)), axis=1).astype(
            np.int32)                                     # node 3 empty
        p0 = rs.randint(0, N, B).astype(np.int32)
        jd = jnp.asarray(data, dtype)
        want = j_segment_max_fast(jd, ids, M, point0_idx=jnp.asarray(p0),
                                  block_n=16)
        td = _t(data).to(getattr(torch, dtype))
        got = tops.segment_max_fast(td, _t(ids), M, point0_idx=_t(p0))
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
        for b in range(B):
            np.testing.assert_array_equal(_np(got[b, 3]), _np(td[b, p0[b]]))

    def test_counts_passed_in(self):
        data, ids = _seg_case(seed=3)
        counts = tops.segment_counts(_t(ids), 8).float()
        np.testing.assert_array_equal(
            tops.segment_max_fast(_t(data), _t(ids), 8, counts=counts).numpy(),
            tops.segment_max(_t(data), _t(ids), 8).numpy())


# ---------------------------------------------------------------------------
# gradients: route_max_grad behind segment_max and segment_max_fast
# ---------------------------------------------------------------------------

# float32: the routing is exact (equality mask, rounded tie counts, exact
# gathers); only the empty nodes' cotangent is a sum over nodes, taken in
# another order.  bfloat16: both sides round the per-node ratio and the
# routed gradient to bf16 at the same places; the empty-node sum may
# round differently by one bf16 ulp (0.4-0.8%).
GRAD_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
            "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _tie_case(dtype, seed=0):
    """Sorted ids with node 3 empty, a planted exact tie in every cloud
    (a point's row copied onto the next point of the same node), a
    non-zero ``point0_idx`` and a cotangent, as numpy; data rounded to
    ``dtype``."""
    rs = np.random.RandomState(seed)
    B, N, C, M = 2, 48, 10, 8
    data = rs.randn(B, N, C).astype(np.float32)
    ids = rs.randint(0, M, (B, N)).astype(np.int32)
    ids[ids == 3] = 2
    ids = np.sort(ids, axis=1)
    for b in range(B):
        p = int(np.nonzero(ids[b] == 2)[0][0])
        data[b, p + 1] = data[b, p]                     # both in node 2
    data = np.asarray(jnp.asarray(data, dtype).astype(jnp.float32))
    p0 = rs.randint(1, N, B).astype(np.int32)
    g = rs.randn(B, M, C).astype(np.float32)
    return data, ids, p0, g


def _tdt(dtype):
    return getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_max_grad_matches_jax(dtype):
    data, ids, p0, g = _tie_case(dtype)
    jd = jnp.asarray(data, dtype)
    out = j_segment_max_fast(jd, ids, 8, point0_idx=jnp.asarray(p0),
                             block_n=16)
    counts = jops.segment_counts(ids, 8)
    want = j_route_max_grad(jd, jnp.asarray(ids), out, counts,
                            jnp.asarray(g), point0_idx=jnp.asarray(p0))
    got = tops.route_max_grad(
        _t(data).to(_tdt(dtype)), _t(ids),
        _t(np.asarray(out, np.float32)).to(_tdt(dtype)),
        _t(np.asarray(counts)), _t(g), point0_idx=_t(p0))
    assert got.dtype == _tdt(dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **GRAD_TOL[dtype])


def _torch_grad(fn, data, dtype, g):
    d = _t(data).to(_tdt(dtype)).requires_grad_()
    (fn(d).float() * _t(g)).sum().backward()
    return _np(d.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_gradient_matches_jax(dtype):
    data, ids, _, g = _tie_case(dtype, seed=1)
    want = jax.grad(lambda d: jnp.sum(
        jops.segment_max(d, jnp.asarray(ids), 8).astype(jnp.float32) * g))(
        jnp.asarray(data, dtype))
    got = _torch_grad(lambda d: tops.segment_max(d, _t(ids), 8), data,
                      dtype, g)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_fast_gradient_matches_jax(dtype):
    data, ids, p0, g = _tie_case(dtype, seed=2)
    want = jax.grad(lambda d: jnp.sum(j_segment_max_fast(
        d, jnp.asarray(ids), 8, point0_idx=jnp.asarray(p0),
        block_n=16).astype(jnp.float32) * g))(jnp.asarray(data, dtype))
    got = _torch_grad(lambda d: tops.segment_max_fast(
        d, _t(ids), 8, point0_idx=_t(p0)), data, dtype, g)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **GRAD_TOL[dtype])
    # the planted tie splits its cotangent; the empty node's goes to p0
    for b in range(2):
        p = int(np.nonzero(ids[b] == 2)[0][0])
        np.testing.assert_array_equal(got[b, p], got[b, p + 1])


def test_segment_max_fast_empty_node_gradient_goes_to_point0():
    data, ids, p0, g = _tie_case("float32", seed=3)
    counts = tops.segment_counts(_t(ids), 8).float()

    def grad_for(cot):
        d = _t(data).requires_grad_()
        out = tops.segment_max_fast(d, _t(ids), 8, counts=counts,
                                    point0_idx=_t(p0))
        assert out.grad_fn is not None
        (out * cot).sum().backward()
        return d.grad

    cot = _t(g)
    no_empty = cot.clone()
    no_empty[:, 3] = 0                           # node 3 is empty
    diff = grad_for(cot) - grad_for(no_empty)
    want = torch.zeros_like(diff)
    want[torch.arange(2), _t(p0).long()] = cot[:, 3]
    torch.testing.assert_close(diff, want)


# ---------------------------------------------------------------------------
# kernel 2: segment_argmax (plain version against the Pallas kernel)
# ---------------------------------------------------------------------------

def _argmax_case(B=2, N=70, C=9, M=8, seed=0, sorted_ids=True,
                 with_ties=False):
    """The cases of tests/test_kernels.py: node 3 empty, optional planted
    tie (point 1 a copy of point 0, in the same node)."""
    rs = np.random.RandomState(seed)
    data = rs.randn(B, N, C).astype(np.float32)
    ids = rs.randint(0, M, (B, N)).astype(np.int32)
    ids[ids == 3] = 2
    if with_ties:
        data[:, 1] = data[:, 0]
        ids[:, 1] = ids[:, 0]
    if sorted_ids:
        order = np.argsort(ids, axis=1, kind="stable")
        ids = np.take_along_axis(ids, order, 1)
        data = np.take_along_axis(data, order[..., None], 1)
    return data, ids


class TestSegmentArgmax:
    """The plain ``segment_argmax`` equals the JAX package's Pallas
    kernel (interpret mode, block_n=32, block_c=8) index for index."""

    @pytest.mark.parametrize("with_ties", [False, True])
    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_matches_pallas(self, sorted_ids, with_ties):
        data, ids = _argmax_case(sorted_ids=sorted_ids, with_ties=with_ties)
        want = j_segment_argmax(data, ids, 8, block_n=32, block_c=8)
        got = tsam.segment_argmax(_t(data), _t(ids), 8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[:, 3] == 0).all()           # the empty node

    def test_ties_first_wins_across_chunks(self):
        # equal maxima at positions 5 and 40 (chunks 0 and 1 of 32): the
        # lower position wins, and -0.0 ties with +0.0
        data = np.full((1, 64, 3), -1.0, np.float32)
        data[0, [5, 40], 0] = 2.5
        data[0, 40, 1], data[0, 7, 1] = -0.0, 0.0
        data[0, 20, 2], data[0, 50, 2] = 0.0, -0.0
        ids = np.zeros((1, 64), np.int32)
        want = np.asarray(j_segment_argmax(data, ids, 2, block_n=32,
                                           block_c=8))
        got = tsam.segment_argmax(_t(data), _t(ids), 2).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, 0], [5, 7, 20])

    def test_floor_values_out_of_range_ids_and_ragged_shapes(self):
        data, ids = _argmax_case(N=75, C=13, seed=4, sorted_ids=False)
        data[:, :, 4] = np.float32(-3e38)       # no value above -3e38
        data[:, ::2, 4] = -np.inf
        bad = ids.copy()
        bad[:, ::7] = 99                         # ignored ids
        want = j_segment_argmax(data, bad, 8, block_n=32, block_c=8)
        got = tsam.segment_argmax(_t(data), _t(bad), 8).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got[:, :, 4] == 0).all()

    @pytest.mark.parametrize("sorted_ids", [True, False])
    def test_value_form_matches_pallas_and_scatter(self, sorted_ids):
        data, ids = _argmax_case(sorted_ids=sorted_ids)
        want = j_segment_max_pallas(data, ids, 8, block_n=32, block_c=8)
        got = tops.segment_max_argmax(_t(data), _t(ids), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), tops.segment_max(_t(data), _t(ids), 8).numpy())

    def test_value_form_gradient_is_gather(self):
        # unsorted, so the planted tie sits at positions 0 and 1
        data, ids = _argmax_case(with_ties=True, sorted_ids=False)
        want = jax.grad(lambda d: jnp.sum(j_segment_max_pallas(
            d, ids, 8, block_n=32, block_c=8) ** 2))(data)
        d = _t(data).requires_grad_()
        (tops.segment_max_argmax(d, _t(ids), 8) ** 2).sum().backward()
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        # a tie sends everything to the first winner, unlike route_max_grad
        assert (d.grad.numpy()[:, 1] == 0).all()

    def test_cuda_path_never_falls_back(self):
        data = torch.empty(1, 4, 2, device="meta")
        ids = torch.empty(1, 4, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            tsam.segment_argmax(data, ids, 3)
        assert tsam.segment_argmax.launches == 0


# ---------------------------------------------------------------------------
# the encoder's global max
# ---------------------------------------------------------------------------

def test_encoder_global_max_routes_ties_to_first_node():
    from sonet_torch import config as tcfg
    from sonet_torch.models import build_model

    cfg = tcfg.tiny_test().replace(pooling="scatter")
    model = build_model(cfg, device="cpu", seed=0)
    B, M, F = 2, cfg.node_num, cfg.feature_num
    rs = np.random.RandomState(0)
    rows = rs.randn(B, M, F).astype(np.float32)
    top = rows.max(1) + 1.0
    rows[:, 2, : F // 2] = top[:, : F // 2]      # nodes 2 and 9 tie at the
    rows[:, 9, : F // 2] = top[:, : F // 2]      # max of the first half
    planted = torch.nn.Parameter(_t(rows))

    class Planted(torch.nn.Module):
        def forward(self, x, epoch=None):
            return planted

    model.encoder.final_pointnet = Planted()
    pc = _t(rs.randn(B, cfg.input_pc_num, 3).astype(np.float32))
    sn = _t(rs.randn(B, cfg.input_pc_num, 3).astype(np.float32))
    node = pc[:, :M] + 0.1
    _, enc = model(pc, sn, node)
    np.testing.assert_array_equal(enc.feature.detach().numpy(),
                                  rows.max(1))
    enc.feature.sum().backward()
    grad = planted.grad.numpy()
    first = rows.argmax(1)                       # numpy: the first maximum
    want = np.zeros_like(rows)
    np.put_along_axis(want, first[:, None, :], 1.0, axis=1)
    np.testing.assert_array_equal(grad, want)
    assert (grad[:, 2, : F // 2] == 1).all()
    assert (grad[:, 9, : F // 2] == 0).all()
