"""The port's self-organizing map against the JAX package's, on the CPU.

Both sides get the same clouds, made with numpy from a seed.

Tolerances, and why:
* potential-field nodes: 1e-6 (both are numpy, the same expressions);
* one ``batch_update``: 1e-5 (float32 sums over a node's points taken in
  another order);
* a whole ``fit``: 40 or 80 updates, each with an argmin over the nodes.
  One point that changes its winner moves a node's mean by about 1/16 of
  a point spacing and later winners follow, so rounding can be amplified.
  On clouds like these the two fits stay together (measured: at most
  1.8e-7 over eight fits of 300 to 2000 points, both schedules); the
  nodes are held at 1e-4, a thousandth of the spacing between
  neighbouring nodes, which still catches one flipped winner (about
  1e-3).  What the fit is for is held beside it: the quantization
  error (the mean distance of a point to its nearest node) within 1% of
  the JAX fit's, and below the initial nodes'.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import som as jsom
from sonet_tpu.som import som as jsom_mod
from sonet_torch import som as tsom
from sonet_torch.som import som as tsom_mod

torch.set_num_threads(2)

FIT_NODE_TOL = 1e-4
QE_RTOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere_clouds(B, N, seed, dim=3):
    """Points on unit spheres squeezed along random axes: surfaces, like
    real clouds, which the volume-filling initial nodes are far from."""
    rs = np.random.RandomState(seed)
    u = rs.randn(B, N, dim)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return (u * rs.uniform(0.4, 1.0, (B, 1, dim))).astype(np.float32)


def _quantization_error(x, nodes):
    d = np.linalg.norm(x[:, :, None, :] - nodes[:, None, :, :], axis=-1)
    return float(d.min(-1).mean())


# ---------------------------------------------------------------------------
# initial nodes and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_num,dim", [(64, 3), (25, 2), (16, 3)])
def test_potential_field_nodes_match_jax(node_num, dim):
    want = jsom.potential_field_nodes(node_num, dim)
    got = tsom.potential_field_nodes(node_num, dim)
    assert got.shape == (node_num, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # cached and shared, so read-only
    assert tsom.potential_field_nodes(node_num, dim) is got
    with pytest.raises(ValueError):
        got[0, 0] = 0.0


def test_potential_field_keeps_the_x_sort_for_a_non_square_count():
    want = jsom.potential_field_nodes(12, 3)
    got = tsom.potential_field_nodes(12, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.diff(got[:, 0]) >= 0)


def test_init_nodes_shapes_and_device():
    cfg = tsom.SOMConfig(rows=4, cols=4, dim=3)
    assert cfg.node_num == 16 and tsom.SOMConfig().node_num == 64
    one = tsom.init_nodes(cfg, device="cpu")
    assert one.shape == (16, 3) and one.dtype == torch.float32
    many = tsom.init_nodes(cfg, 5, device="cpu")
    assert many.shape == (5, 16, 3) and many.is_contiguous()
    np.testing.assert_array_equal(
        many.numpy(), np.asarray(jsom.init_nodes(jsom.SOMConfig(4, 4, 3), 5)))
    many[0, 0, 0] = 99.0                      # a fresh tensor each call
    assert float(tsom.init_nodes(cfg, device="cpu")[0, 0]) != 99.0


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsom.SOMConfig(4, 4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        tsom.fit(np.zeros((1, 10, 3), np.float32), cfg)     # default: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        tsom.init_nodes(cfg)


@pytest.mark.parametrize("schedule,n", [("prep", 40), ("online", 80)])
def test_schedule_matches_jax(schedule, n):
    want = jsom_mod._schedule(jsom.SOMConfig(schedule=schedule))
    got = tsom_mod._schedule(tsom.SOMConfig(schedule=schedule))
    for g, w in zip(got, want):
        assert g.shape == (n,) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    lr, sigma = got
    warm = n // 4
    assert np.all(lr[:warm] == 0.5) and np.all(sigma[:warm] == np.float32(0.4))
    # the last decayed iteration: 1 / (1 + 29/30) and 1 / (1 + 2 * 59/60)
    last = {"prep": 1 / (1 + 29 / 30), "online": 1 / (1 + 2 * 59 / 60)}
    np.testing.assert_allclose(lr[-1], 0.5 * last[schedule], rtol=1e-6)
    with pytest.raises(ValueError, match="schedule"):
        tsom_mod._schedule(tsom.SOMConfig(schedule="bogus"))


def test_grid_log_gaussian_matches_jax():
    for rows, cols in ((8, 8), (4, 4), (5, 5)):
        np.testing.assert_array_equal(
            tsom_mod._grid_log_gaussian(rows, cols, 0.4),
            jsom_mod._grid_log_gaussian(rows, cols, 0.4))


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,N,lr,sigma", [(4, 100, 0.3, 0.25),
                                             (8, 500, 0.5, 0.4),
                                             (8, 300, 0.26, 0.21)])
def test_batch_update_matches_jax(rows, N, lr, sigma):
    rs = np.random.RandomState(rows + N)
    x = rs.randn(3, N, 3).astype(np.float32)
    nodes = (0.5 * rs.randn(3, rows * rows, 3)).astype(np.float32)
    want = jsom.batch_update(jnp.asarray(nodes), jnp.asarray(x),
                             jnp.float32(lr), jnp.float32(sigma),
                             jsom.SOMConfig(rows, rows, 3))
    got = tsom.batch_update(_t(nodes), _t(x), lr, sigma,
                            tsom.SOMConfig(rows, rows, 3))
    assert got.dtype == torch.float32 and got.shape == nodes.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert np.abs(got.numpy() - nodes).max() > 1e-2          # it moved


def test_batch_update_in_two_dimensions_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.rand(2, 200, 2).astype(np.float32)
    nodes = rs.rand(2, 25, 2).astype(np.float32)
    want = jsom.batch_update(jnp.asarray(nodes), jnp.asarray(x),
                             jnp.float32(0.5), jnp.float32(0.4),
                             jsom.SOMConfig(5, 5, 2))
    got = tsom.batch_update(_t(nodes), _t(x), 0.5, 0.4,
                            tsom.SOMConfig(5, 5, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_empty_node_moves_only_by_its_neighbours_pull():
    """All points sit on node 0; the three empty nodes have no mean of
    their own and must not be pulled toward the origin: each moves along
    the line to the occupied node's mean, by its grid weight."""
    cfg = tsom.SOMConfig(rows=2, cols=2, dim=3)
    x = torch.ones(1, 10, 3)
    nodes = torch.tensor([[[1.0, 1, 1], [50, 50, 50], [-50, -50, -50],
                           [80, 80, 80]]])
    new = tsom.batch_update(nodes, x, 0.5, 0.4, cfg)
    want = jsom.batch_update(jnp.asarray(nodes.numpy()),
                             jnp.asarray(x.numpy()), 0.5, 0.4,
                             jsom.SOMConfig(2, 2, 3))
    np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(new[0, 1, 0]) < 50.0 and float(new[0, 2, 0]) > -50.0
    # delta_j = lr * w[0, j] * (mean_0 - node_j), mean_0 = 10 / (10 + 1e-5)
    w = np.exp(tsom_mod._grid_log_gaussian(2, 2, 0.4))[0]
    for j in (1, 2, 3):
        delta = 0.5 * w[j] * (1.0 - float(nodes[0, j, 0]))
        np.testing.assert_allclose(float(new[0, j, 0]),
                                   float(nodes[0, j, 0]) + delta, rtol=1e-4)
    # pulled to the origin, node 1 would have moved by lr * sum_i w[i, 1]
    # * (0 - 50) from its two empty neighbours as well: further than this
    assert float(new[0, 1, 0]) > 50.0 + 0.5 * w[1] * (1.0 - 50.0) - 1e-3


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------

def test_query_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 30, 3).astype(np.float32)
    nodes = rs.randn(2, 9, 3).astype(np.float32)
    want_idx, want_occ = jsom.query(jnp.asarray(nodes), jnp.asarray(x))
    idx, occ = tsom.query(_t(nodes), _t(x))
    assert idx.dtype == torch.int32 and occ.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    d = np.sum((x[:, :, None] - nodes[:, None]) ** 2, -1)
    np.testing.assert_array_equal(idx.numpy(), d.argmin(-1))
    assert not occ.numpy().all()              # 30 points leave a node empty


@pytest.mark.parametrize("k", [1, 3])
def test_query_topk_matches_jax(k):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 40, 3).astype(np.float32)
    nodes = rs.randn(2, 16, 3).astype(np.float32)
    want = jsom.query_topk(jnp.asarray(nodes), jnp.asarray(x), k)
    got = tsom.query_topk(_t(nodes), _t(x), k)
    np.testing.assert_array_equal(got.min_idx.numpy(),
                                  np.asarray(want.min_idx))
    np.testing.assert_array_equal(got.mask_row_max.numpy(),
                                  np.asarray(want.mask_row_max))
    np.testing.assert_allclose(got.sqdist.numpy(), np.asarray(want.sqdist),
                               rtol=1e-5, atol=1e-5)
    if k == 1:
        np.testing.assert_array_equal(got.min_idx.numpy(),
                                      tsom.query(_t(nodes), _t(x))[0].numpy())


# ---------------------------------------------------------------------------
# the whole fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["prep", "online"])
def fits(request):
    x = _sphere_clouds(4, 600, seed=1)
    jc = jsom.SOMConfig(8, 8, 3, schedule=request.param)
    tc = tsom.SOMConfig(8, 8, 3, schedule=request.param)
    want = np.asarray(jsom.fit(jnp.asarray(x), jc))
    got = tsom.fit(x, tc, device="cpu")
    return x, tc, want, got


def test_fit_nodes_match_jax(fits):
    x, cfg, want, got = fits
    assert got.shape == (4, 64, 3) and got.dtype == torch.float32
    assert got.device.type == "cpu" and not got.requires_grad
    err = float(np.abs(got.numpy() - want).max())
    assert err <= FIT_NODE_TOL, err


def test_fit_quantization_error_matches_jax_and_falls(fits):
    x, cfg, want, got = fits
    q_init = _quantization_error(
        x, tsom.init_nodes(cfg, 4, device="cpu").numpy())
    q_jax = _quantization_error(x, want)
    q = _quantization_error(x, got.numpy())
    assert abs(q - q_jax) <= QE_RTOL * q_jax, (q, q_jax)
    assert q < 0.8 * q_init, (q, q_init)
    # the nodes lie inside the clouds' bounds
    assert float(got.abs().max()) <= float(np.abs(x).max()) + 1e-6


def test_schedules_give_different_fits():
    x = _sphere_clouds(1, 200, seed=2)
    a = tsom.fit(x, tsom.SOMConfig(4, 4, 3, schedule="prep"), device="cpu")
    b = tsom.fit(x, tsom.SOMConfig(4, 4, 3, schedule="online"), device="cpu")
    assert not np.allclose(a.numpy(), b.numpy())


def test_fit_takes_tensors_arrays_and_initial_nodes():
    x = _sphere_clouds(2, 150, seed=5)
    cfg = tsom.SOMConfig(4, 4, 3)
    a = tsom.fit(x, cfg, device="cpu")
    b = tsom.fit(_t(x), cfg, device="cpu")
    c = tsom.fit(_t(x), cfg, init=tsom.init_nodes(cfg, 2, device="cpu"),
                 device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)          # repeats exactly
    init = 0.3 * torch.randn(2, 16, 3, generator=torch.Generator()
                             .manual_seed(0))
    kept = init.clone()
    d = tsom.fit(x, cfg, init=init, device="cpu")
    assert not torch.equal(d, a) and torch.equal(init, kept)
    want = jsom.fit(jnp.asarray(x), jsom.SOMConfig(4, 4, 3),
                    init=jnp.asarray(init.numpy()))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), atol=FIT_NODE_TOL)
    with pytest.raises(ValueError, match="must be"):
        tsom.fit(x[..., :2], cfg, device="cpu")


def test_fit_reaches_no_library_matmul(monkeypatch):
    """The fit is float32 whatever the matmul switches say because it
    calls no library product at all: with every one of them made to raise,
    it gives the same bits; and it leaves the switches as they were."""
    x = _sphere_clouds(2, 150, seed=7)
    cfg = tsom.SOMConfig(4, 4, 3)
    want = tsom.fit(x, cfg, device="cpu")
    idx, occ = tsom.query(want, _t(x))
    precision = torch.get_float32_matmul_precision()

    def refuse(*a, **k):
        raise AssertionError("a library product was called")

    for name in ("matmul", "bmm", "mm", "einsum", "baddbmm", "addmm"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("matmul", "bmm", "mm", "__matmul__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = tsom.fit(x, cfg, device="cpu")
    assert torch.equal(got, want)
    assert torch.equal(tsom.query(got, _t(x))[0], idx)
    assert torch.get_float32_matmul_precision() == precision
