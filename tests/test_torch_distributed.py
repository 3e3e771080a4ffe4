"""The port over two CPU processes (``sonet_torch.parallel`` over gloo):
the (2, 1) and (1, 2) meshes' steps, the multi-process ``Trainer``,
``infer``, ``retrieve``, ``prep som`` and the serving engine, against the
port's own one-process run (which the other tests hold to
``sonet_tpu``); and the spec, mesh, backend, device and capture rules.

One pool of two workers (this file run as a script, importing no JAX)
runs every case once and writes its results; the one-process runs they
are held to run in the pytest process.  ``tiny_test``, float32, dropout
0, lr 1e-5.

Tolerances, and why:
* steps: as ``tests/test_torch_mesh.py`` (losses rtol 1e-4, state and
  eval within 2e-4 of the largest entry, first-step gradients 1e-3 of
  the largest entry plus 1e-6, the segmenter's 1e-2; on (2, 1) its two
  named gradients differ from one process's by 3.1e-3 and 5.7e-3 of
  their largest entry, the very gaps that 1e-7 of noise in the weights
  of one process opens).
* a Trainer epoch (16 steps): Adam turns noise-level gradient
  differences into steps of +-lr, so a parameter may move up to about
  2 lr a step apart; what is held is that at most 0.2% of the entries
  differ by more than lr and none by more than 2 lr a step, the running
  statistics within 1e-3 of max(1, largest entry), and the eval metrics
  within 1e-3 relative.
* infer, the engine, retrieval: the eval forward, 1e-4 of the largest
  entry; the same predictions and rankings.
* ``prep som``: the same nodes (each cloud's fit is its own).
"""

import glob
import os
import pickle
import sys
import traceback

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mesh import (GRAD_TOL, NODE_PARAM, POINT_PARAM,  # noqa: E402
                             REPO, _close, _run_steps, launch, read,
                             step_batch, step_cfg)

WORLD = 2
LR = 1e-5
STEPS = 16                       # a tiny_test synthetic epoch
MESHES = [(2, 1), (1, 2)]
TASKS = ["classify", "segment", "autoencode"]
TRAINERS = [("host", "replicated"), ("device", "replicated"),
            ("device", "sharded"), ("device", "chunked")]
# the tiny synthetic split (about 110 KB) in chunks under this budget
CHUNK_BUDGET_GB = 5e-5


def placement(place):
    """Config fields of a placement: "chunked" is the replicated one
    streamed in chunks."""
    if place == "chunked":
        return dict(dataset_placement="replicated",
                    device_budget_gb=CHUNK_BUDGET_GB)
    return dict(dataset_placement=place)


def trainer_cfg(tcfg, out, name, **over):
    return tcfg.tiny_test().replace(dropout=0.0, lr=LR, epochs=1,
                                    checkpoints_dir=out, name=name, **over)


def cloud_tree(root):
    rng = np.random.default_rng(2)
    for i in range(4):
        d = os.path.join(root, f"cls{i % 2}")
        os.makedirs(d, exist_ok=True)
        pc = rng.standard_normal((150 + 10 * i, 6)).astype(np.float32)
        np.save(os.path.join(d, f"s{i}.npy"), pc)


def engine_inputs(cfg):
    rs = np.random.RandomState(3)
    B, N, M = 6, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 3).astype(np.float32)
    return {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
            "node": pc[:, :M].copy()}


# ---------------------------------------------------------------------------
# the workers (no JAX)
# ---------------------------------------------------------------------------

def _case_steps(shape, task):
    def run(out, rank):
        from sonet_torch import config as tcfg
        from sonet_torch.parallel import make_mesh
        cfg = step_cfg(tcfg, task, "sorted_window")
        b = step_batch(cfg)
        mesh = make_mesh(shape)
        return {"one": _run_steps(cfg, b, None),
                "mesh": _run_steps(cfg, b, mesh)}
    return run


def _case_rules(out, rank):
    import torch

    from sonet_torch.parallel import make_mesh, replicate, shard_batch
    from sonet_torch.train import graphs
    mesh = make_mesh((2, 1))
    src = {"w": torch.full((3,), float(rank + 1)), "n": 7}
    copy = replicate(src, mesh)
    src["w"].add_(100.0)                  # the source changes: not the copy
    batch = {"pc": np.arange(2 * 4 * 3).reshape(2, 4, 3),
             "label": np.arange(2), "valid": 2}
    mesh12 = make_mesh((1, 2))
    try:
        graphs.check_capturable(mesh)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    # a card's step over a gloo mesh runs eagerly, one over no mesh does not
    eager = [graphs.StepGraph(lambda x: x, torch.device("cuda"),
                              mesh=m).eager for m in (mesh, None)]
    eager += [graphs.EpochGraph(lambda d, i: {}, torch.device("cuda"),
                                mesh=m).eager for m in (mesh, None)]
    return {"copy": copy["w"].numpy(), "n": copy["n"],
            "block21": shard_batch(batch, mesh),
            "block12": shard_batch(batch, mesh12),
            "refused": refused, "eager": eager}


def _case_point_dropout(out, rank):
    import torch

    from sonet_torch.parallel import collectives, make_mesh
    from sonet_torch.parallel.mesh import block
    from sonet_torch.train.loops import random_point_dropout
    rs = np.random.RandomState(9)
    pc, sn = (torch.from_numpy(rs.randn(2, 40, 3).astype(np.float32))
              for _ in range(2))
    one = random_point_dropout(pc, sn, torch.Generator().manual_seed(3), 0.5)
    mesh = make_mesh((1, 2))
    with collectives.use_mesh(mesh):
        got = random_point_dropout(
            *(block(t, ("data", "points"), mesh).contiguous()
              for t in (pc, sn)),
            torch.Generator().manual_seed(3), 0.5)
    return {"one": [block(t, ("data", "points"), mesh).numpy()
                    for t in one],
            "mesh": [t.numpy() for t in got]}


def _trainer_case(pipe, place):
    def run(out, rank):
        from sonet_torch import config as tcfg
        from sonet_torch.parallel import distributed
        from sonet_torch.train.trainer import Trainer
        cfg = trainer_cfg(tcfg, out, f"{pipe}_{place}", input_pipeline=pipe,
                          distributed="auto", **placement(place))
        # each rank its own directory: rank 1's must stay unwritten
        t = Trainer(cfg, quiet=True, resume=False, device="cpu",
                    out_dir=os.path.join(out, f"{pipe}_{place}_r{rank}"))
        metrics = t.fit(1)
        res = {"metrics": metrics, "step": t.state.step,
               "mesh_shape": t.cfg.mesh_shape,
               "state": {k: v.numpy().copy()
                         for k, v in t.model.state_dict().items()},
               "multiprocess": t.multiprocess,
               "backend": distributed.uses_gloo(t.mesh)}
        if place == "sharded":
            res["local_items"] = t.device_train.local_items
        if place == "chunked":
            res["chunks"] = t.device_train.num_chunks
        return res
    return run


def _case_stop(out, rank):
    from sonet_torch import config as tcfg
    from sonet_torch.train.trainer import Trainer
    cfg = trainer_cfg(tcfg, out, "stop")
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    calls = [0]
    inner = t.train_graph

    class Stopper:                     # rank 1 alone asks to stop
        def __call__(self, **batch):
            calls[0] += 1
            if rank == 1 and calls[0] == 3:
                t.request_stop()
            return inner(**batch)

    t.train_graph = Stopper()
    t.fit(3)
    stopped = t.state.step
    t2 = Trainer(cfg, quiet=True, resume=True, device="cpu")
    return {"stopped": stopped, "resumed": t2.state.step,
            "calls": calls[0],
            "state": {k: v.numpy().copy()
                      for k, v in t2.model.state_dict().items()}}


def _case_infer(out, rank):
    from sonet_torch.tasks import infer
    run = os.path.join(out, "host_replicated_r0")
    return infer.main(["--run", run, "--out", os.path.join(out, "infer2"),
                       "--device", "cpu", "--mesh_shape", "2",
                       "--distributed", "auto"])


def _case_retrieve(out, rank):
    from sonet_torch.tasks import retrieve
    ckpt = sorted(glob.glob(os.path.join(out, "host_replicated_r0", "ckpt",
                                         "*.pt")))[-1]
    return retrieve.main(["--device", "cpu", "--preset", "tiny_test",
                          "--task", "retrieve", "--dropout", "0.0",
                          "--checkpoint", ckpt, "--output_dir",
                          os.path.join(out, "rank2"),
                          "--distributed", "auto"])


def _case_som(out, rank):
    from sonet_torch.data import prep
    prep.main(["som", "--root", os.path.join(out, "som2"), "--device",
               "cpu", "--som_sample", "64", "--batch", "4", "--rows", "3",
               "--mesh_shape", "2", "--distributed", "auto"])
    return True


def _case_engine(shape):
    def run(out, rank):
        from sonet_torch import config as tcfg
        from sonet_torch.serving import ServingEngine
        run_dir = os.path.join(out, "host_replicated_r0")
        eng = ServingEngine.from_run(run_dir, device="cpu", mesh_shape=shape)
        return {"out": eng.predict(engine_inputs(tcfg.tiny_test())),
                "mesh_shape": eng.manifest["mesh_shape"]}
    return run


def _case_serve_follow(out, rank):
    from sonet_torch import config as tcfg
    from sonet_torch.serving import ServingEngine
    from sonet_torch.tasks import serve
    eng = ServingEngine.from_run(os.path.join(out, "host_replicated_r0"),
                                 device="cpu", mesh_shape=(2, 1))
    if rank != 0:
        serve._follow(eng)             # until process 0 stops it
        return {"followed": True}
    serve._lead(eng)
    got = eng.predict(engine_inputs(tcfg.tiny_test()))
    serve._broadcast_dispatch(serve._STOP, None, eng)
    return {"out": got, "dispatches": eng.dispatches}


def _case_remat(out, rank):
    """The classifier's steps over (1, 2) with and without ``remat``: the
    recomputation issues the first PointNet's global BatchNorm all-reduces
    a second time, on every rank alike."""
    from sonet_torch import config as tcfg
    from sonet_torch.parallel import make_mesh
    cfg = step_cfg(tcfg, "classify", "sorted_window")
    b = step_batch(cfg)
    mesh = make_mesh((1, 2))
    return {"plain": _run_steps(cfg, b, mesh),
            "remat": _run_steps(cfg.replace(remat=True), b, mesh)}


def _case_indivisible(out, rank):
    """A batch that the world's (2, 1) data-parallel mesh does not divide:
    the Trainer and ``from_run`` exit with "--mesh_shape: ..." before any
    dataset is built or any state restored."""
    from sonet_torch import config as tcfg
    from sonet_torch import serving
    from sonet_torch.train import trainer as ttrainer
    built = []
    real = ttrainer.build_dataset
    ttrainer.build_dataset = lambda *a, **k: built.append(a) or real(*a, **k)
    said = {}
    try:
        for what, call in (
                ("trainer", lambda: ttrainer.Trainer(
                    trainer_cfg(tcfg, out, "indivisible", batch_size=3),
                    quiet=True, device="cpu")),
                ("from_run", lambda: serving.ServingEngine.from_run(
                    os.path.join(out, "host_replicated_r0"), device="cpu",
                    batch_size=3))):
            try:
                call()
                said[what] = None
            except SystemExit as e:
                said[what] = str(e)
    finally:
        ttrainer.build_dataset = real
    return {"said": said, "built": len(built)}


def cases():
    out = [(f"steps_{s[0]}{s[1]}_{t}", _case_steps(s, t))
           for s in MESHES for t in TASKS]
    out += [("rules", _case_rules), ("point_dropout", _case_point_dropout)]
    out += [(f"trainer_{p}_{q}", _trainer_case(p, q)) for p, q in TRAINERS]
    out += [("stop", _case_stop), ("infer", _case_infer),
            ("retrieve", _case_retrieve), ("som", _case_som),
            ("engine_12", _case_engine((1, 2))),
            ("engine_21", _case_engine((2, 1))),
            ("serve_follow", _case_serve_follow),
            ("remat_12", _case_remat), ("indivisible", _case_indivisible)]
    return out


def _worker(rank, world, port, out):
    import torch

    from sonet_torch.parallel import maybe_init_distributed
    torch.set_num_threads(1)
    # torchrun's environment, for the cases that pass --distributed auto
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    maybe_init_distributed("auto", "cpu")
    for name, fn in cases():
        try:
            res = {"ok": fn(out, rank)}
        except BaseException:
            res = {"error": traceback.format_exc()}
        with open(os.path.join(out, f"{name}_r{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        if "error" in res:
            print(res["error"], flush=True)
            os._exit(1)


# ---------------------------------------------------------------------------
# the pool, and the one-process runs it is held to
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_pool"))
    for name in ("som1", "som2"):
        cloud_tree(os.path.join(out, name))
    logs = launch(WORLD, out, os.path.abspath(__file__), timeout=300)
    return out, logs


def _one_trainer(out, pipe, place, monkeypatch=None):
    import torch

    from sonet_torch import config as tcfg
    from sonet_torch.train.trainer import Trainer
    torch.manual_seed(0)
    over = placement(place) if place == "chunked" else {}
    cfg = trainer_cfg(tcfg, out, f"one_{pipe}_{place}", input_pipeline=pipe,
                      **over)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    if place == "sharded":
        # the epoch the two shards compose: each shard's rows side by side
        def composed(data, shuffle, epoch):
            if not shuffle:
                return Trainer._device_epoch_index(t, data, shuffle, epoch)
            T, B, dp = data.size, cfg.batch_size, WORLD
            counts = np.array([T // dp + (s < T % dp) for s in range(dp)])
            offs = np.concatenate([[0], np.cumsum(counts)])
            perm = np.random.default_rng(cfg.seed + 777).permutation(T)
            rng = np.random.default_rng(cfg.seed + 1000 + epoch)
            b = B // dp
            S = int(counts.min()) // b
            parts = []
            for s in range(dp):
                ids = perm[offs[s]:offs[s + 1]]
                parts.append(ids[rng.permutation(int(counts[s]))[:S * b]
                                 .reshape(S, b)])
            return np.concatenate(parts, 1).astype(np.int64), [B] * S
        t._device_epoch_index = composed
    metrics = t.fit(1)
    return {"metrics": metrics, "step": t.state.step,
            "state": {k: v.numpy().copy()
                      for k, v in t.model.state_dict().items()}}


def _epoch_close(got, want):
    assert got["step"] == want["step"] == STEPS
    params = [k for k in want["state"] if "running" not in k
              and "num_batches" not in k]
    d = np.concatenate([np.abs(got["state"][k] - want["state"][k]).ravel()
                        for k in params])
    assert (d > LR).mean() <= 2e-3, (d > LR).mean()
    assert d.max() <= 2 * LR * STEPS, d.max()
    for k in want["state"]:
        if "running" in k:
            _close(got["state"][k], want["state"][k], 1e-3, k)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-3)


# ---------------------------------------------------------------------------
# the (2, 1) and (1, 2) steps against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("shape", MESHES)
def test_steps_match_one_process(pool, shape, task):
    out, logs = pool
    r = read(out, logs, f"steps_{shape[0]}{shape[1]}_{task}")
    one, mesh = r["one"], r["mesh"]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-4)
    for k, want in one["state"].items():
        _close(mesh["state"][k], want, 2e-4, k)
    ev_tol = 3e-2 if task == "autoencode" else 2e-4
    for k, want in one["eval"].items():
        if (k.endswith("_i") or np.ndim(want) == 0) and want.dtype != bool:
            np.testing.assert_allclose(mesh["eval"][k], want, rtol=ev_tol,
                                       atol=ev_tol * 1e-2)
    for name in (POINT_PARAM, NODE_PARAM):
        want, got = one["grads"][name], mesh["grads"][name]
        assert (float(np.abs(got - want).max())
                <= GRAD_TOL[task] * float(np.abs(want).max()) + 1e-6), name


def test_remat_steps_over_1x2_equal_the_plain_ones(pool):
    out, logs = pool
    for rank in range(WORLD):
        r = read(out, logs, "remat_12", rank)
        plain, remat = r["plain"], r["remat"]
        assert remat["losses"] == plain["losses"]
        for part in ("grads", "state"):
            assert set(remat[part]) == set(plain[part])
            for k, want in plain[part].items():
                np.testing.assert_array_equal(remat[part][k], want,
                                              err_msg=k)
        for k, want in plain["eval"].items():
            np.testing.assert_array_equal(remat["eval"][k], want, err_msg=k)


def test_an_indivisible_batch_exits_before_anything_is_built(pool):
    out, logs = pool
    for rank in range(WORLD):
        r = read(out, logs, "indivisible", rank)
        assert r["built"] == 0
        for what in ("trainer", "from_run"):
            assert r["said"][what] == ("--mesh_shape: batch_size 3 must "
                                       "divide over the data axis (2)"), what


# ---------------------------------------------------------------------------
# replicate, shard_batch, the capture rule
# ---------------------------------------------------------------------------

def test_replicate_is_rank0s_and_alias_safe(pool):
    out, logs = pool
    for r in range(WORLD):
        got = read(out, logs, "rules", r)
        np.testing.assert_array_equal(got["copy"], np.ones(3, np.float32))
        assert got["n"] == 7


def test_shard_batch_blocks(pool):
    out, logs = pool
    pc = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    for r in range(WORLD):
        got = read(out, logs, "rules", r)
        np.testing.assert_array_equal(got["block21"]["pc"], pc[r:r + 1])
        np.testing.assert_array_equal(got["block21"]["label"], [r])
        np.testing.assert_array_equal(got["block12"]["pc"],
                                      pc[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["block12"]["label"], [0, 1])
        assert got["block21"]["valid"] == 2


def test_point_dropout_over_a_points_axis_draws_as_one_process(pool):
    out, logs = pool
    for r in range(WORLD):
        got = read(out, logs, "point_dropout", r)
        for a, b in zip(got["mesh"], got["one"]):
            np.testing.assert_array_equal(a, b)


def test_gloo_capture_is_refused_by_name_and_steps_run_eagerly(pool):
    out, logs = pool
    got = read(out, logs, "rules")
    assert "gloo" in got["refused"] and "captur" in got["refused"]
    assert got["eager"] == [True, False, True, False]


# ---------------------------------------------------------------------------
# the two-process Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipe,place", TRAINERS)
def test_trainer_epoch_matches_one_process(pool, tmp_path, pipe, place):
    out, logs = pool
    got = read(out, logs, f"trainer_{pipe}_{place}")
    assert got["mesh_shape"] == (2, 1) and got["multiprocess"]
    _epoch_close(got, _one_trainer(str(tmp_path), pipe, place))
    if place == "sharded":
        items = [read(out, logs, f"trainer_{pipe}_{place}", r)["local_items"]
                 for r in range(WORLD)]
        assert not set(items[0]) & set(items[1])
        assert len(items[0]) + len(items[1]) == 64
    if place == "chunked":
        assert got["chunks"] > 1


@pytest.mark.parametrize("pipe,place", TRAINERS)
def test_only_rank0_writes_the_run(pool, pipe, place):
    out, _ = pool
    r0 = os.path.join(out, f"{pipe}_{place}_r0")
    assert os.path.exists(os.path.join(r0, "config.json"))
    assert glob.glob(os.path.join(r0, "ckpt", "step_*.pt"))
    assert glob.glob(os.path.join(r0, "*_metrics.jsonl"))
    assert not os.path.exists(os.path.join(out, f"{pipe}_{place}_r1"))


def test_a_stop_on_rank1_stops_both_with_a_checkpoint(pool):
    out, logs = pool
    a, b = (read(out, logs, "stop", r) for r in range(WORLD))
    assert a["stopped"] == b["stopped"] == a["calls"] == b["calls"] == 3
    assert a["resumed"] == b["resumed"] == 3
    ckpts = sorted(os.listdir(os.path.join(out, "stop", "ckpt")))
    assert ckpts[-1] == "step_00000003.pt"
    for k, v in a["state"].items():
        np.testing.assert_array_equal(b["state"][k], v)


def test_a_run_saved_on_2x1_resumes_in_one_process(pool):
    from sonet_torch import config as tcfg
    from sonet_torch.train.trainer import Trainer
    out, logs = pool
    want = read(out, logs, "stop")
    t = Trainer(trainer_cfg(tcfg, out, "stop"), quiet=True, device="cpu")
    assert t.mesh is None and t.state.step == want["resumed"]
    for k, v in t.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want["state"][k])


# ---------------------------------------------------------------------------
# the entry points over two ranks against one process
# ---------------------------------------------------------------------------

def test_infer_over_two_ranks_matches_one_process(pool, tmp_path):
    from sonet_torch.tasks import infer
    out, logs = pool
    got = read(out, logs, "infer")
    other = read(out, logs, "infer", 1)                # every rank's summary
    assert {k: v for k, v in other.items() if k != "clouds_per_sec"} == {
        k: v for k, v in got.items() if k != "clouds_per_sec"}
    want = infer.main(["--run", os.path.join(out, "host_replicated_r0"),
                       "--out", str(tmp_path), "--device", "cpu"])
    for k in ("items", "checkpoint"):
        assert got[k] == want[k]
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    a = np.genfromtxt(os.path.join(out, "infer2", "predictions.csv"),
                      delimiter=",", skip_header=1)
    b = np.genfromtxt(tmp_path / "predictions.csv", delimiter=",",
                      skip_header=1)
    np.testing.assert_array_equal(a, b)


def test_retrieve_over_two_ranks_matches_one_process(pool, tmp_path):
    from sonet_torch.tasks import retrieve
    out, logs = pool
    got = read(out, logs, "retrieve")
    ckpt = sorted(glob.glob(os.path.join(out, "host_replicated_r0", "ckpt",
                                         "*.pt")))[-1]
    want = retrieve.main(["--device", "cpu", "--preset", "tiny_test",
                          "--task", "retrieve", "--dropout", "0.0",
                          "--checkpoint", ckpt, "--output_dir",
                          str(tmp_path)])
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6)
    names = sorted(f for f in os.listdir(tmp_path) if f != "gallery")
    assert names == sorted(f for f in os.listdir(os.path.join(out, "rank2"))
                           if f != "gallery")
    for n in names:       # the same ranking, distances to 1e-5
        a = np.loadtxt(tmp_path / n, ndmin=2)
        b = np.loadtxt(os.path.join(out, "rank2", n), ndmin=2)
        np.testing.assert_array_equal(b[:, 0], a[:, 0], err_msg=n)
        np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_prep_som_over_two_ranks_writes_one_process_nodes(pool):
    from sonet_torch.data import prep
    out, logs = pool
    assert read(out, logs, "som")
    prep.main(["som", "--root", os.path.join(out, "som1"), "--device", "cpu",
               "--som_sample", "64", "--batch", "4", "--rows", "3"])
    a = sorted(glob.glob(os.path.join(out, "som1", "3x3_som_nodes", "*",
                                      "*.npy")))
    b = sorted(glob.glob(os.path.join(out, "som2", "3x3_som_nodes", "*",
                                      "*.npy")))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.load(y), np.load(x), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name,shape", [("engine_12", [1, 2]),
                                        ("engine_21", [2, 1])])
def test_engine_predict_over_a_mesh_matches_one_process(pool, name, shape):
    from sonet_torch import config as tcfg
    from sonet_torch.serving import ServingEngine
    out, logs = pool
    eng = ServingEngine.from_run(os.path.join(out, "host_replicated_r0"),
                                 device="cpu")
    want = eng.predict(engine_inputs(tcfg.tiny_test()))
    for r in range(WORLD):
        got = read(out, logs, name, r)
        assert got["mesh_shape"] == shape
        _close(got["out"], want, 1e-4, name)
        np.testing.assert_array_equal(got["out"].argmax(-1),
                                      want.argmax(-1))


def test_served_dispatches_reach_every_rank(pool):
    from sonet_torch import config as tcfg
    from sonet_torch.serving import ServingEngine
    out, logs = pool
    got = read(out, logs, "serve_follow")
    assert read(out, logs, "serve_follow", 1) == {"followed": True}
    assert got["dispatches"] == 2                  # 6 items at batch 4
    eng = ServingEngine.from_run(os.path.join(out, "host_replicated_r0"),
                                 device="cpu")
    _close(got["out"], eng.predict(engine_inputs(tcfg.tiny_test())), 1e-4,
           "served")


# ---------------------------------------------------------------------------
# the rules, in this process
# ---------------------------------------------------------------------------

def test_spec_parsing():
    from sonet_torch.parallel import parse_distributed_spec
    assert parse_distributed_spec("") is None
    assert parse_distributed_spec(None) is None
    assert parse_distributed_spec("auto") == {}
    assert parse_distributed_spec(" AUTO ") == {}
    assert parse_distributed_spec("10.0.0.1:29500,4,2") == {
        "init_method": "tcp://10.0.0.1:29500", "world_size": 4, "rank": 2}


@pytest.mark.parametrize("bad", ["localhost", "h:1,2", "h:1,2,3,4", "h:1,a,0",
                                 "h:1,2,2", "h:1,0,0", "h:1,2,-1"])
def test_spec_junk_is_refused(bad):
    from sonet_torch.parallel import parse_distributed_spec
    with pytest.raises(ValueError):
        parse_distributed_spec(bad)


def test_parse_mesh_shape():
    from sonet_torch.parallel import (check_mesh_divisible,
                                      normalize_mesh_shape, parse_mesh_shape)
    assert parse_mesh_shape("4,2") == (4, 2)
    assert parse_mesh_shape("4x2") == (4, 2)
    assert parse_mesh_shape("8") == (8, 1)
    assert parse_mesh_shape(" 2 , 2 ") == (2, 2)
    assert normalize_mesh_shape((4,)) == (4, 1)
    with pytest.raises(ValueError):
        normalize_mesh_shape((1, 2, 3))
    check_mesh_divisible((4, 2), 8, 64)
    with pytest.raises(ValueError, match="data axis"):
        check_mesh_divisible((3, 1), 8, 64)
    with pytest.raises(ValueError, match="points axis"):
        check_mesh_divisible((1, 3), 8, 64)


@pytest.mark.parametrize("bad", [",", "x", "", "a,b", "0", "-1", "2,0",
                                 "2,2,2"])
def test_mesh_shape_junk_is_refused(bad):
    from sonet_torch.parallel import parse_mesh_shape
    with pytest.raises(ValueError):
        parse_mesh_shape(bad)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl"),
                                            ("cuda:0", "gloo")])
def test_backend_rule(device, backend):
    from sonet_torch.parallel.distributed import backend_for
    assert backend_for(device) == backend


def test_device_rule(monkeypatch):
    import torch

    from sonet_torch.parallel.distributed import rank_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert rank_device("cuda", 1) == torch.device("cuda", 1)
    assert rank_device("cuda:0", 1) == torch.device("cuda", 0)  # shared
    assert rank_device("cpu", 1) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2.*--device cuda:0"):
        rank_device("cuda", 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK.*not set.*cuda:N"):
        rank_device("cuda", None)


def test_a_spec_without_local_rank_needs_a_named_card(monkeypatch):
    # HOST:PORT,NPROC,PID launched by hand: the PID is the global rank, so
    # a rank on a second host must not take it for a card index
    import torch
    import torch.distributed as dist

    from sonet_torch.parallel import maybe_init_distributed
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(dist, "init_process_group", lambda **k: pytest.fail(
        "the group came up without a card for the rank"))
    with pytest.raises(RuntimeError, match="LOCAL_RANK.*not set"):
        maybe_init_distributed("127.0.0.1:29500,4,3", "cuda")


def test_no_group_means_no_mesh():
    from sonet_torch import config as tcfg
    from sonet_torch.parallel.mesh import mesh_for_config, setup_mesh
    cfg = tcfg.tiny_test()
    assert mesh_for_config(cfg, "cpu") is None
    got, mesh, dev = setup_mesh(cfg, "cpu")
    assert mesh is None and got == cfg and dev.type == "cpu"
    with pytest.raises(ValueError, match="one process per device"):
        setup_mesh(cfg.replace(mesh_shape=(1, 2)), "cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
