"""The port over a (2, 2) (data, points) mesh of four CPU processes
(``sonet_torch.parallel`` over gloo), against ``sonet_tpu`` on the same
mesh of virtual devices and against the port's own one-process run.

One pool of four workers (this file run as a script, importing no JAX)
runs every case once and writes its results; the tests read them.  The
JAX side runs in the pytest process on ``tests/conftest.py``'s virtual
devices, its Pallas kernel in interpret mode.  Inputs come from numpy
seeds; the JAX parity run starts both packages from ``sonet_tpu``'s
initial weights, carried across by ``sonet_torch.convert``.  Float32,
``tiny_test``, dropout 0.

Tolerances, and why:
* pooling forward: ``==`` (a max picks one of its inputs); its gradient
  1e-6 (ties split the cotangent by the same exact counts).
* against ``sonet_tpu`` on (2, 2): losses rtol 1e-4, every state tensor
  and the eval outputs within 2e-4 of the tensor's largest entry (as
  ``tests/test_torch_train.py``; lr 1e-5 keeps Adam's noise-level sign
  flips below that).
* against one process: the same, and first-step gradients within 1e-3 of
  the tensor's largest entry plus 1e-6 (``tests/test_torch_train.py``);
  the segmenter's within 1e-2: its train-mode gradient is chaotic in the
  last bits of its inputs (noise of 1e-7 in the weights of one process
  moves the two named gradients by up to 9.7e-3 of their largest entry,
  by flipping nearly tied pooling winners and ReLUs), and the mesh's
  BatchNorm sums, added in another order, are such noise.  BatchNorm
  statistics 1e-5 relative (the same sums in another order).
  The autoencoder's eval after an update may move by ``sonet_tpu``'s 3e-2
  (near-tie Chamfer pairs flip, ``tests/test_sharding.py``).
"""

import os
import pickle
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, SHAPE = 4, (2, 2)
LR = 1e-5
POOL_B, POOL_N, POOL_C, POOL_M, POOL_P0 = 4, 32, 8, 6, 3
POINT_PARAM = "encoder.first_pointnet.PointLayer_0.Dense_0.weight"
NODE_PARAM = "encoder.final_pointnet.PointLayer_0.Dense_0.weight"
STEP_CASES = [("classify", "scatter"), ("classify", "sorted_window"),
              ("segment", "sorted_window"), ("autoencode", "scatter")]
BN_ROWS = [600, 8400]                                 # below / above 8192
GRAD_TOL = {"classify": 1e-3, "segment": 1e-2, "autoencode": 1e-3}


# ---------------------------------------------------------------------------
# inputs, from numpy seeds (both sides)
# ---------------------------------------------------------------------------

def pool_inputs():
    """(B, N, C) data, (B, N) ids with an empty node and exact ties across
    the two points halves, the (B, M, C) cotangent."""
    rs = np.random.RandomState(5)
    B, N, C, M = POOL_B, POOL_N, POOL_C, POOL_M
    ids = rs.randint(0, M - 1, (B, N)).astype(np.int32)   # node M-1 empty
    data = rs.randn(B, N, C).astype(np.float32)
    half = N // 2
    for j in range(0, half, 3):        # the same value at the same node
        ids[:, j + half] = ids[:, j]
        data[:, j + half] = data[:, j]
    data[:, 1] = data[:, 0]            # and a tie inside one half
    ids[:, 1] = ids[:, 0]
    g = rs.randn(B, M, C).astype(np.float32)
    return data, ids, g


def step_cfg(tcfg, task, pooling, **over):
    cfg = tcfg.tiny_test().replace(task=task, pooling=pooling, dropout=0.0,
                                   batch_size=4, lr=LR, **over)
    return cfg.replace(classes=50) if task == "segment" else cfg


def step_batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 3)).astype(np.float32)
    # one far node: empty, so the empty-node patch and its gradient run
    node = np.concatenate([node, np.full((B, 1, 3), 50.0, np.float32)], 1)
    b = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32), "node": node}
    if cfg.task == "segment":
        b["label"] = rs.randint(0, 16, B).astype(np.int64)
        b["seg"] = rs.randint(0, cfg.classes, (B, N)).astype(np.int64)
    else:
        b["label"] = rs.randint(0, cfg.classes, B).astype(np.int64)
    return b


def bn_input(n_rows):
    rs = np.random.RandomState(n_rows)
    C = 6
    return (rs.randn(2, n_rows // 2, C) * rs.uniform(0.5, 3.0, C)
            + 2.0 * rs.randn(C)).astype(np.float32)


# ---------------------------------------------------------------------------
# the workers (no JAX)
# ---------------------------------------------------------------------------

def _case_pool(mesh, out):
    import torch

    from sonet_torch.ops.segment import segment_counts
    from sonet_torch.ops.segment_fast import segment_max_fast
    from sonet_torch.parallel import collectives
    from sonet_torch.parallel.mesh import block
    data, ids, g = pool_inputs()
    x = torch.from_numpy(np.ascontiguousarray(
        block(data, ("data", "points"), mesh))).requires_grad_(True)
    i = torch.from_numpy(np.ascontiguousarray(
        block(ids, ("data", "points"), mesh)))
    p0 = torch.full((x.shape[0],), POOL_P0, dtype=torch.int32)
    with collectives.use_mesh(mesh):
        counts = collectives.all_reduce(segment_counts(i, POOL_M),
                                        ("points",))
        y = segment_max_fast(x, i, POOL_M, counts=counts, point0_idx=p0)
        y.backward(torch.from_numpy(np.ascontiguousarray(
            block(g, ("data",), mesh))))
    return {"out": y.detach().numpy(), "grad": x.grad.numpy()}


def _first_grads(model, names):
    params = dict(model.named_parameters())
    return {n: params[n].grad.clone().numpy() for n in names}


def _run_steps(cfg, batch, mesh, steps=2, init=None):
    """(losses, first-step gradients of the two named parameters, the
    final state, the eval outputs) of ``steps`` train steps and an eval
    step on ``batch`` (this rank's block under ``mesh``)."""
    import torch

    from sonet_torch import train as ttrain
    from sonet_torch.convert import load_jax_variables
    from sonet_torch.models import build_model
    from sonet_torch.parallel import fetch_global, shard_batch
    model = build_model(cfg, device="cpu")
    if init is not None:
        load_jax_variables(model, init)
    st = ttrain.init_state(cfg, device="cpu", model=model,
                           steps_per_epoch=2, mesh=mesh)
    tr, ev = ttrain.make_steps(cfg, 2, mesh=mesh)
    tb = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                     mesh)
    tb = {k: v.contiguous() for k, v in tb.items()}
    losses, grads = [], None
    for i in range(steps):
        _, m = tr(st, tb, torch.Generator().manual_seed(1))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _first_grads(st.model, (POINT_PARAM, NODE_PARAM))
    e = ev(st, tb)
    point_keys = {"score"} if cfg.task == "segment" else set()
    ev_np = fetch_global({k: v for k, v in e.items()}, mesh,
                         {k: ("data", "points") for k in point_keys})
    state = {k: v.numpy().copy() for k, v in st.model.state_dict().items()}
    return {"losses": losses, "grads": grads, "state": state, "eval": ev_np}


def _case_steps(task, pooling):
    def run(mesh, out):
        from sonet_torch import config as tcfg
        cfg = step_cfg(tcfg, task, pooling)
        b = step_batch(cfg)
        return {"one": _run_steps(cfg, b, None),
                "mesh": _run_steps(cfg, b, mesh)}
    return run


def _case_jax_parity(mesh, out):
    from sonet_torch import config as tcfg
    with open(os.path.join(out, "jax_init.pkl"), "rb") as f:
        init = pickle.load(f)
    cfg = step_cfg(tcfg, "classify", "sorted_window")
    return _run_steps(cfg, step_batch(cfg), mesh, init=init)


def _case_bn(n_rows):
    def run(mesh, out):
        import torch

        from sonet_torch.nn.layers import BatchNorm
        from sonet_torch.parallel import collectives
        from sonet_torch.parallel.mesh import block
        x = bn_input(n_rows)
        res = {}
        for point_level in (True, False):
            spec = ("data", "points") if point_level else ("data",)
            kw = dict(momentum=0.1, sharded_points=point_level)
            one, dist_bn = BatchNorm(6, **kw), BatchNorm(6, **kw)
            one.train()
            dist_bn.train()
            y1 = one(torch.from_numpy(x))
            with collectives.use_mesh(mesh):
                y2 = dist_bn(torch.from_numpy(np.ascontiguousarray(
                    block(x, spec, mesh))))
            res[point_level] = {
                "one": {"mean": one.running_mean.numpy(),
                        "var": one.running_var.numpy(),
                        "y": block(y1.detach().numpy(), spec, mesh)},
                "mesh": {"mean": dist_bn.running_mean.numpy(),
                         "var": dist_bn.running_var.numpy(),
                         "y": y2.detach().numpy()}}
        return res
    return run


def cases():
    out = [("pool", _case_pool), ("jax_parity", _case_jax_parity)]
    out += [(f"steps_{t}_{p}", _case_steps(t, p)) for t, p in STEP_CASES]
    out += [(f"bn_{n}", _case_bn(n)) for n in BN_ROWS]
    return out


def _worker(rank, world, port, out):
    import torch

    from sonet_torch.parallel import make_mesh, maybe_init_distributed
    torch.set_num_threads(1)
    maybe_init_distributed(f"127.0.0.1:{port},{world},{rank}", "cpu")
    mesh = make_mesh(SHAPE)
    for name, fn in cases():
        try:
            res = {"ok": fn(mesh, out)}
        except Exception:
            res = {"error": traceback.format_exc()}
        with open(os.path.join(out, f"{name}_r{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        if "error" in res:
            print(res["error"], flush=True)
            os._exit(1)      # the other ranks would wait in a collective


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, out, script, timeout=240):
    """Run ``world`` workers of ``script``; returns their logs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, script, "--worker", str(r), str(world), port, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0] + "\n[killed at the time limit]")
    return logs


def read(out, logs, name, rank=0):
    path = os.path.join(out, f"{name}_r{rank}.pkl")
    if not os.path.exists(path):
        pytest.fail(f"case {name} left no result on rank {rank}:\n"
                    + "\n---\n".join(logs))
    with open(path, "rb") as f:
        res = pickle.load(f)
    if "error" in res:
        pytest.fail(f"case {name} failed on rank {rank}:\n{res['error']}")
    return res["ok"]


def _jax_init():
    import jax

    from sonet_tpu import config as jcfg
    from sonet_tpu import models as jmodels
    from sonet_tpu.train import state as jstate
    from sonet_torch.convert import flatten
    jc = step_cfg(jcfg, "classify", "sorted_window")
    b = step_batch(jc)
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0),
                           (b["pc"], b["sn"], b["node"]), steps_per_epoch=2)
    init = {k: np.array(v) for k, v in flatten(
        {"params": js.params, "batch_stats": js.batch_stats}).items()}
    return jm, jc, js, init


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_pool"))
    jax_side = _jax_init()
    with open(os.path.join(out, "jax_init.pkl"), "wb") as f:
        pickle.dump(jax_side[3], f)
    logs = launch(WORLD, out, os.path.abspath(__file__))
    return out, logs, jax_side


def gather_blocks(out, logs, name, key, spec, getter=None):
    """The global array from every rank's block of ``key`` of a case."""
    D, P = SHAPE
    rows = []
    for d in range(D):
        cols = []
        for p in range(P if "points" in spec else 1):
            r = read(out, logs, name, d * P + p)
            cols.append(getter(r) if getter else r[key])
        rows.append(np.concatenate(cols, 1) if len(cols) > 1 else cols[0])
    return np.concatenate(rows, 0)


def _close(a, b, rel, what):
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(np.asarray(a, np.float64) - b).max())
    assert err <= rel * scale, (what, err, rel * scale)


# ---------------------------------------------------------------------------
# kernel 1's sharded pooling against sonet_tpu on the same mesh
# ---------------------------------------------------------------------------

def _jax_pool():
    import jax
    import jax.numpy as jnp

    from sonet_tpu.ops.segment import segment_counts
    from sonet_tpu.ops.segment_fast import segment_max_fast
    from sonet_tpu.parallel import make_mesh
    data, ids, g = pool_inputs()
    mesh = make_mesh(SHAPE)
    counts = segment_counts(jnp.asarray(ids), POOL_M)
    p0 = jnp.full((POOL_B,), POOL_P0, jnp.int32)

    def f(x):
        return segment_max_fast(x, jnp.asarray(ids), POOL_M, counts=counts,
                                point0_idx=p0, mesh=mesh)

    y, vjp = jax.vjp(f, jnp.asarray(data))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def test_sharded_pooling_matches_jax_on_the_same_mesh(pool):
    out, logs, _ = pool
    want_y, want_g = _jax_pool()
    got_y = gather_blocks(out, logs, "pool", "out", ("data",))
    got_g = gather_blocks(out, logs, "pool", "grad", ("data", "points"))
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-6)
    # the empty node took point 0's feature
    data, _, _ = pool_inputs()
    np.testing.assert_array_equal(got_y[:, POOL_M - 1], data[:, POOL_P0])


def test_sharded_pooling_is_replicated_along_points(pool):
    out, logs, _ = pool
    for d in range(SHAPE[0]):
        a = read(out, logs, "pool", d * 2)["out"]
        b = read(out, logs, "pool", d * 2 + 1)["out"]
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# two classify train steps and an eval step against sonet_tpu on (2, 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_run(pool):
    import jax
    import jax.numpy as jnp

    from sonet_tpu.parallel import make_mesh, replicate, shard_batch
    from sonet_tpu.train import loops as jloops
    from sonet_torch.convert import flatten
    jm, jc, js, _ = pool[2]
    jc = jc.replace(mesh_shape=SHAPE)
    b = step_batch(jc)
    mesh = make_mesh(SHAPE)
    js = replicate(js, mesh)
    tr, ev = jloops.make_classify_steps(jm, jc, 2)
    db = shard_batch({k: (v.astype(np.int32) if k == "label" else v)
                      for k, v in b.items()}, mesh)
    losses = []
    for _ in range(2):
        js, m = tr(js, db, jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    e = jax.tree.map(np.asarray, ev(js, db))
    final = {k: np.array(v) for k, v in flatten(
        {"params": js.params, "batch_stats": js.batch_stats}).items()}
    return losses, final, e


def test_classify_steps_match_jax_on_the_same_mesh(pool, jax_mesh_run):
    out, logs, _ = pool
    losses, _, _ = jax_mesh_run
    got = read(out, logs, "jax_parity")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for r in range(1, WORLD):   # every rank reports the same metrics
        assert read(out, logs, "jax_parity", r)["losses"] == got["losses"]


def test_classify_state_after_steps_matches_jax(pool, jax_mesh_run):
    import torch

    from sonet_torch import config as tcfg
    from sonet_torch.convert import to_jax_variables
    from sonet_torch.models import build_model
    out, logs, _ = pool
    _, final, _ = jax_mesh_run
    model = build_model(step_cfg(tcfg, "classify", "sorted_window"),
                        device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           read(out, logs, "jax_parity")["state"].items()})
    got = to_jax_variables(model)
    assert set(got) == set(final)
    for k, want in final.items():
        _close(got[k], want, 2e-4, k)


def test_classify_eval_matches_jax(pool, jax_mesh_run):
    out, logs, _ = pool
    _, _, want = jax_mesh_run
    got = read(out, logs, "jax_parity")["eval"]
    scale = max(1.0, float(np.abs(want["score"]).max()))
    assert np.abs(got["score"] - want["score"]).max() <= 2e-4 * scale
    for k in ("loss_i", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2e-4 * scale)
    np.testing.assert_array_equal(got["correct_i"], want["correct_i"])


# ---------------------------------------------------------------------------
# the port on (2, 2) against its own one-process run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task,pooling", STEP_CASES)
def test_steps_match_one_process(pool, task, pooling):
    out, logs, _ = pool
    r = read(out, logs, f"steps_{task}_{pooling}")
    one, mesh = r["one"], r["mesh"]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-4)
    for k, want in one["state"].items():
        _close(mesh["state"][k], want, 2e-4, k)
    ev_tol = 3e-2 if task == "autoencode" else 2e-4
    for k, want in one["eval"].items():
        if k.endswith("_i") or np.ndim(want) == 0:
            if want.dtype == bool:
                np.testing.assert_array_equal(mesh["eval"][k], want)
            else:
                np.testing.assert_allclose(mesh["eval"][k], want,
                                           rtol=ev_tol, atol=ev_tol * 1e-2)


@pytest.mark.parametrize("task,pooling", STEP_CASES)
@pytest.mark.parametrize("name", [POINT_PARAM, NODE_PARAM])
def test_gradients_by_name_match_one_process(pool, task, pooling, name):
    """A point-level parameter's gradient is summed over the points ranks,
    a node-level one's is not (it is whole on each): both equal one
    process's."""
    out, logs, _ = pool
    r = read(out, logs, f"steps_{task}_{pooling}")
    want, got = r["one"]["grads"][name], r["mesh"]["grads"][name]
    tol = GRAD_TOL[task] * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol
    assert float(np.abs(want).max()) > 1e-4


@pytest.mark.parametrize("task,pooling", STEP_CASES)
def test_state_is_replicated(pool, task, pooling):
    out, logs, _ = pool
    name = f"steps_{task}_{pooling}"
    ref = read(out, logs, name)["mesh"]["state"]
    for r in range(1, WORLD):
        st = read(out, logs, name, r)["mesh"]["state"]
        for k, v in ref.items():
            np.testing.assert_array_equal(st[k], v, err_msg=k)


@pytest.mark.parametrize("n_rows", BN_ROWS)
@pytest.mark.parametrize("point_level", [True, False])
def test_batchnorm_statistics_are_global(pool, n_rows, point_level):
    out, logs, _ = pool
    for r in range(WORLD):
        res = read(out, logs, f"bn_{n_rows}", r)[point_level]
        for k in ("mean", "var"):
            np.testing.assert_allclose(res["mesh"][k], res["one"][k],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["mesh"]["y"], res["one"]["y"],
                                   rtol=1e-5, atol=1e-5)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
