"""The port's serving artifacts (``sonet_torch.serving.export_run``,
``load_exported``, ``ServingEngine.from_artifact``, ``sonet-torch
export`` and ``serve --artifact``) on the CPU, against the JAX package's
jitted serve function.

A port run is written from the JAX package's initial variables of a
float32 ``tiny_test`` model (classify, and its segment and autoencode
variants), with random BatchNorm statistics, carried across by
``sonet_torch.convert``.  Tolerances: an artifact against the JAX
package's ``jax.jit(build_serve_fn(...))`` within 1e-5 of the largest
output (``tests/test_export.py``'s tolerance: float32 summed in another
order by XLA and by PyTorch); against the port's own in-process forward
at the same batch within 1e-6 (the same ATen operators on the same rows).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu import serving as jserving
from sonet_torch import cli as tcli
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.models import build_model
from sonet_torch.serving import (ARTIFACT_MANIFEST, ServingEngine,
                                 build_serve_fn, export_run, input_signature,
                                 load_exported)
from sonet_torch.tasks import serve as tserve

torch.set_num_threads(2)

JAX_TOL = 1e-5
SAME_TOL = 1e-6
B = 4
TASKS = {"classify": {},
         "segment": dict(task="segment", classes=50),
         "autoencode": dict(task="autoencode")}


def _inputs(cfg, n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for name, shape, dtype in input_signature(cfg, n):
        if name == "label":
            out.append(rs.randint(0, 16, shape).astype(dtype))
        else:
            out.append(rs.randn(*shape).astype(dtype))
    return tuple(out)


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture(scope="module", params=list(TASKS))
def run(request, tmp_path_factory):
    """(task, port run dir, port config, inputs at B+1, the JAX package's
    jitted serve output on the first B of them)."""
    task = request.param
    root = tmp_path_factory.mktemp(f"export_{task}")
    over = dict(TASKS[task], compute_dtype="float32", batch_size=B,
                checkpoints_dir=str(root), name="run", seed=3)
    jc, tc = jcfg.tiny_test().replace(**over), tcfg.tiny_test().replace(**over)
    x = _inputs(tc, B + 1)
    xb = tuple(a[:B] for a in x)
    jm = jmodels.build_model(jc)
    # the init jitted: the autoencoder's eager init alone takes 20 s
    variables = jax.jit(lambda r: jm.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *xb,
        train=False))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(2)
    flat = flatten(variables)
    for k, v in flat.items():          # BatchNorm statistics off 0 and 1
        if k.endswith("/mean"):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    state = ttrain.init_state(tc, device="cpu", model=model)
    run_dir = root / "run"
    run_dir.mkdir()
    tc.save(str(run_dir / "config.json"))
    ttrain.save_checkpoint(str(run_dir / "ckpt"), state, 5)

    stats = {}
    for k, v in flat.items():
        coll, *path, leaf = k.split("/")
        if coll == "batch_stats":
            d = stats
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    serve = jserving.build_serve_fn(jm, jc, params, stats)
    want = np.asarray(jax.jit(serve)(*xb))
    return task, str(run_dir), tc, x, want


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """``artifact(run_dir, **export_run kwargs)``: (the directory, the
    manifest) of that export, written once for the module."""
    made = {}

    def get(run_dir, **kw):
        key = (run_dir, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in made:
            out = str(tmp_path_factory.mktemp("artifact"))
            made[key] = out, export_run(run_dir, out_dir=out, device="cpu",
                                        **kw)
        return made[key]

    return get


# the portable symbolic form, shared by the tests that read it
PORTABLE = dict(platforms=["cpu", "cuda"], poly_batch=True)


def _forward(run_dir, arrays):
    """The port's in-process eval forward of the run at ``len(arrays[0])``
    items, on the portable (scatter) path."""
    from sonet_torch.serving import _restore_run
    cfg, model, _, _ = _restore_run(run_dir, device="cpu", pooling="scatter")
    serve = build_serve_fn(model, cfg)
    return serve(*(torch.from_numpy(a) for a in arrays)).float().numpy()


def test_fixed_export_matches_jax_and_the_forward(run, tmp_path):
    task, run_dir, cfg, x, want = run
    manifest = export_run(run_dir, out_dir=str(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "model.pt2"]
    with open(tmp_path / ARTIFACT_MANIFEST) as f:
        assert json.load(f) == manifest
    # the JAX package's manifest keys, torch's version for jax's, and
    # what loading the program requires
    assert set(manifest) == {
        "task", "inputs", "poly_batch", "output", "platforms", "pooling",
        "requires", "classes", "checkpoint", "torch_version", "blob_bytes"}
    assert (manifest["platforms"], manifest["pooling"],
            manifest["requires"]) == (["cpu"], "scatter", [])
    assert manifest["output"] == jserving._OUTPUT_DOC[task]
    assert manifest["inputs"] == [
        {"name": n, "shape": list(s), "dtype": d}
        for n, s, d in jserving.input_signature(
            jcfg.tiny_test().replace(**TASKS[task], batch_size=B))]
    fn, m = load_exported(str(tmp_path), device="cpu")
    got = fn(*(a[:B] for a in x))
    assert got.dtype == np.float32
    _close(got, want, JAX_TOL)
    _close(got, _forward(run_dir, [a[:B] for a in x]), SAME_TOL)
    eng = ServingEngine.from_artifact(str(tmp_path), device="cpu")
    assert eng.batch_size == B and eng.graph is None
    # 5 items: a full dispatch, then the last item padded to a batch
    last = fn(*(np.repeat(a[B:], B, 0) for a in x))[:1]
    _close(eng.predict(dict(zip(eng.input_names, x))),
           np.concatenate([got, last]), SAME_TOL)


def test_symbolic_export_at_each_batch(run, artifact):
    check_poly_export(run, *artifact(run[1], **PORTABLE), bucketed=False)


@pytest.mark.parametrize("run", ["classify"], indirect=True)
def test_bucketed_export_at_each_batch(run, artifact):
    check_poly_export(run, *artifact(run[1], platforms=["cpu"],
                                     poly_batch=True, bucketed=True),
                      bucketed=True)


def check_poly_export(run, out, manifest, bucketed):
    task, run_dir, cfg, x, want = run
    assert manifest["poly_batch"] and manifest["pooling"] == "scatter"
    assert all(i["shape"][0] is None for i in manifest["inputs"])
    if bucketed:
        assert manifest["buckets"] == [1, 2, 4]
        assert sorted(os.listdir(out)) == [
            "manifest.json", "model_b1.pt2", "model_b2.pt2", "model_b4.pt2"]
    else:
        assert "buckets" not in manifest
        assert sorted(os.listdir(out)) == ["manifest.json", "model.pt2"]
    fn, _ = load_exported(out, device="cpu")
    _close(fn(*(a[:B] for a in x)), want, JAX_TOL)
    for n in (1, 3, B):
        # a bucketed artifact runs 3 items in its 4-bucket, padded
        pad = 4 if bucketed and n == 3 else n
        ref = _forward(run_dir, [np.concatenate(
            [a[:n], np.repeat(a[n - 1:n], pad - n, 0)]) for a in x])[:n]
        _close(fn(*(a[:n] for a in x)), ref, SAME_TOL)
    # above the largest bucket: chunked
    got = fn(*x)
    assert got.shape[0] == B + 1
    eng = ServingEngine.from_artifact(out, device="cpu")
    assert eng.batch_size is None
    eng.warmup()
    out = eng.predict(dict(zip(eng.input_names, (a[:3] for a in x))))
    assert out.shape[0] == 3 and eng.stats()["items"] == 3


@pytest.mark.parametrize("run", ["classify"], indirect=True)
@pytest.mark.parametrize("case", ["arity", "shape", "inconsistent", "empty"])
def test_load_exported_rejects_bad_inputs(run, artifact, case):
    task, run_dir, cfg, x, _ = run
    fn, _ = load_exported(artifact(run_dir, **PORTABLE)[0], device="cpu")
    bad, match = {
        "arity": ((x[0],), "expected 3 inputs"),
        "shape": ((x[0][:, :-1], x[1], x[2]), "expected shape"),
        "inconsistent": ((x[0][:2], x[1][:3], x[2][:2]),
                         "inconsistent batch"),
        "empty": (tuple(a[:0] for a in x), "empty request batch"),
    }[case]
    with pytest.raises(ValueError, match=match):
        fn(*bad)


@pytest.mark.parametrize("run", ["classify"], indirect=True)
def test_kernel_export_holds_the_operator(run, tmp_path):
    """A cuda-only export keeps kernel 1 as ``sonet_torch::windowed_vals``
    (traced here on the CPU through the operator's fake implementation),
    and says that loading it requires the operator's module."""
    task, run_dir, *_ = run
    manifest = export_run(run_dir, out_dir=str(tmp_path), device="cpu",
                          platforms=["cuda"])
    assert manifest["pooling"] == "sorted_window"
    assert manifest["requires"] == ["sonet_torch.ops.cuda.segment_max_window"]
    program = torch.export.load(str(tmp_path / "model.pt2"))
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"]
    assert ops.count("sonet_torch.windowed_vals.default") == 1  # the pooling
    with pytest.raises(ValueError, match="exported for"):
        load_exported(str(tmp_path), device="cpu")


@pytest.mark.parametrize("run", ["classify"], indirect=True)
def test_portable_artifact_loads_without_the_package(run, artifact,
                                                     tmp_path):
    task, run_dir, cfg, x, want = run
    out, _ = artifact(run_dir, **PORTABLE)
    np.savez(tmp_path / "x.npz", *(a[:3] for a in x))
    code = (
        "import sys, numpy as np, torch\n"
        "z = np.load(sys.argv[1] + '/x.npz')\n"
        "prog = torch.export.load(sys.argv[2] + '/model.pt2').module()\n"
        "with torch.no_grad():\n"
        "    out = prog(*(torch.from_numpy(z[k]) for k in sorted(z.files)))\n"
        "np.save(sys.argv[1] + '/out.npy', out.numpy())\n"
        "assert not [m for m in sys.modules if m.startswith('sonet')]\n")
    # run from the artifact's directory: the repo is not on sys.path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path), out],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = np.load(tmp_path / "out.npy")
    _close(got, _forward(run_dir, [a[:3] for a in x]), SAME_TOL)


@pytest.mark.parametrize("run", ["classify"], indirect=True)
def test_export_command_and_serving_the_artifact(run, tmp_path, capsys):
    task, run_dir, cfg, x, want = run
    out = str(tmp_path / "art")
    assert tcli.main(["export", "--run", run_dir, "--out", out, "--device",
                      "cpu", "--check"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["check"] == {"output_shape": [B, cfg.classes],
                                "finite": True}
    engine = ServingEngine.from_artifact(out, device="cpu")
    engine.warmup()
    assert engine.manifest["source"] == "artifact"
    srv = tserve.make_server(engine, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({n: a[:1].tolist() for n, a in
                           zip(engine.input_names, x)}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/predict",
            data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        tserve.drain_server(srv, engine)
        t.join(10)
    assert not t.is_alive()
    got = np.asarray(answer["output"], np.float32)
    _close(got, engine.predict({n: a[:1] for n, a in
                                zip(engine.input_names, x)}), JAX_TOL)
    _close(got, want[:1], JAX_TOL)
