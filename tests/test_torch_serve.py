"""The port's request micro-batcher and HTTP daemon (``sonet_torch.serving``
``start_microbatch`` / ``stop_microbatch``, ``sonet_torch.tasks.serve``)
on the CPU: the twins of ``tests/test_serve.py``'s micro-batcher and HTTP
checks, run on a port engine serving a float32 ``tiny_test`` run.

Served rows are held within 1e-5 of the engine's direct ``predict`` of the
same clouds (the same float32 forward over another number of rows, which
may change the blocking and so the order of the sums).
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sonet_tpu import serving as jserving
from sonet_tpu.tasks import serve as jserve
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.serving import ServingEngine
from sonet_torch.tasks import serve as tserve

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run: config.json and a checkpoint of seeded weights."""
    root = tmp_path_factory.mktemp("serve_run")
    cfg = tcfg.tiny_test().replace(compute_dtype="float32",
                                   checkpoints_dir=str(root), name="run")
    run = root / "run"
    run.mkdir()
    cfg.save(str(run / "config.json"))
    state = ttrain.init_state(cfg, device="cpu", seed=3)
    ttrain.save_checkpoint(str(run / "ckpt"), state, 1)
    return str(run)


@pytest.fixture(scope="module")
def engine(run_dir):
    eng = ServingEngine.from_run(run_dir, device="cpu")
    eng.warmup()
    return eng


def _inputs(engine, B, seed=0):
    rng = np.random.RandomState(seed)
    return {i["name"]: rng.randn(B, *i["shape"][1:]).astype(i["dtype"])
            for i in engine.manifest["inputs"]}


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------

class TestMicroBatch:
    def test_coalesces_and_matches(self, run_dir, engine):
        """Concurrent B'=1 requests share dispatches; every caller gets
        exactly its own rows, those of a direct predict."""
        eng = ServingEngine.from_run(run_dir, device="cpu")
        eng.warmup()
        B = eng.batch_size
        full = _inputs(eng, 2 * B, seed=41)
        want = engine.predict(full)
        eng.start_microbatch(window_ms=200.0)  # generous: threads line up
        try:
            results = [None] * (2 * B)

            def one(i):
                results[i] = eng.predict(
                    {k: v[i:i + 1] for k, v in full.items()})
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(2 * B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for i in range(2 * B):
                assert results[i] is not None, i
                np.testing.assert_allclose(results[i], want[i:i + 1], **TOL)
            s = eng.stats()
            assert s["requests"] == 2 * B and s["items"] == 2 * B
            assert s["microbatch"]
            assert s["dispatches"] < 2 * B
            assert s["coalesced_requests"] >= 2
        finally:
            eng.stop_microbatch()
        assert not eng.stats()["microbatch"]
        # after stop, requests dispatch directly again
        out = eng.predict({k: v[:1] for k, v in full.items()})
        np.testing.assert_allclose(out, want[:1], **TOL)

    def test_single_request_within_the_window(self, run_dir, engine):
        """A lone small request returns after the window with its rows;
        a full-batch request bypasses the batcher."""
        eng = ServingEngine.from_run(run_dir, device="cpu")
        B = eng.batch_size
        full = _inputs(eng, B, seed=43)
        want = engine.predict(full)
        eng.start_microbatch(window_ms=1.0)
        eng.start_microbatch(window_ms=1.0)      # a second start is a no-op
        try:
            out = eng.predict({k: v[:2] for k, v in full.items()})
            np.testing.assert_allclose(out, want[:2], **TOL)
            d_before = eng.stats()["dispatches"]
            out = eng.predict(full)  # B_req == B: direct path
            np.testing.assert_allclose(out, want, **TOL)
            assert eng.stats()["dispatches"] == d_before + 1
            assert eng.stats()["coalesced_requests"] == 0
        finally:
            eng.stop_microbatch()
        eng.stop_microbatch()                    # and so is a second stop

    def test_a_closed_batcher_dispatches_directly(self, run_dir, engine):
        eng = ServingEngine.from_run(run_dir, device="cpu")
        eng.start_microbatch(window_ms=50.0)
        batcher = eng._batcher
        eng.stop_microbatch()
        x = _inputs(eng, 1, seed=44)
        out = batcher.submit([x[n] for n in eng.input_names], 1)
        np.testing.assert_allclose(out, engine.predict(x), **TOL)

    def test_errors_reach_every_caller(self, run_dir):
        eng = ServingEngine.from_run(run_dir, device="cpu")
        calls = []

        def broken(*arrays):
            calls.append(arrays[0].shape[0])
            raise RuntimeError("card lost")
        eng._fn = broken
        eng.start_microbatch(window_ms=200.0)
        errors = []

        def one(seed):
            try:
                eng.predict(_inputs(eng, 1, seed=seed))
            except RuntimeError as e:
                errors.append(str(e))
        try:
            threads = [threading.Thread(target=one, args=(s,))
                       for s in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            eng.stop_microbatch()
        assert errors == ["card lost"] * 3 and len(calls) < 3

    def test_warmup_restores_every_counter(self, run_dir):
        eng = ServingEngine.from_run(run_dir, device="cpu")
        eng.coalesced = 5
        before = eng.stats()
        eng.warmup()
        assert eng.stats() == before

    def test_stats_keys_are_the_jax_packages(self, engine):
        manifest = {"task": "classify", "inputs": [
            {"name": "x", "shape": [4, 2], "dtype": "float32"}]}
        jeng = jserving.ServingEngine(lambda x: x, manifest)
        assert list(engine.stats()) == list(jeng.stats())
        jeng.start_microbatch(1.0)
        engine.start_microbatch(1.0)
        try:
            assert list(engine.stats()) == list(jeng.stats())
            assert engine.stats()["microbatch"] is jeng.stats()["microbatch"]
        finally:
            engine.stop_microbatch()
            jeng.stop_microbatch()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(url, body, content_type="application/json"):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


class TestHTTPServer:
    @pytest.fixture(scope="class")
    def server(self, engine):
        srv = tserve.make_server(engine, port=0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}"
        tserve.drain_server(srv, engine)

    def test_healthz_and_manifest(self, server, engine):
        with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
            assert r.headers["Server"].startswith("sonet-torch-serve/")
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["task"] == "classify"
        assert set(health) == {"status"} | set(engine.stats())
        with urllib.request.urlopen(server + "/v1/manifest", timeout=30) as r:
            man = json.loads(r.read())
        assert man == engine.manifest and man["device"] == "cpu"

    def test_predict_json(self, server, engine):
        x = _inputs(engine, 2, seed=11)
        body = json.dumps({k: v.tolist() for k, v in x.items()}).encode()
        status, raw, _ = _post(server + "/v1/predict", body)
        assert status == 200
        resp = json.loads(raw)
        assert set(resp) == {"output", "shape", "dtype", "items", "ms"}
        want = engine.predict(x)
        np.testing.assert_allclose(np.array(resp["output"]), want, **TOL)
        assert resp["shape"] == list(want.shape) and resp["items"] == 2
        assert resp["dtype"] == "float32"
        # the body may also wrap the arrays in {"inputs": ...}
        status, raw, _ = _post(server + "/v1/predict", json.dumps(
            {"inputs": {k: v.tolist() for k, v in x.items()}}).encode())
        np.testing.assert_allclose(np.array(json.loads(raw)["output"]), want,
                                   **TOL)

    def test_predict_npz_roundtrip(self, server, engine):
        x = _inputs(engine, 3, seed=12)
        buf = io.BytesIO()
        np.savez(buf, **x)
        status, raw, ctype = _post(server + "/v1/predict?format=npz",
                                   buf.getvalue(),
                                   content_type="application/x-npz")
        assert status == 200 and ctype == "application/x-npz"
        with np.load(io.BytesIO(raw)) as z:
            got = z["output"]
        np.testing.assert_allclose(got, engine.predict(x), **TOL)

    def test_concurrent_requests(self, server, engine):
        """Parallel clients: each response carries its own rows."""
        def one(seed, results):
            x = _inputs(engine, 2, seed=seed)
            body = json.dumps({k: v.tolist() for k, v in x.items()}).encode()
            status, raw, _ = _post(server + "/v1/predict", body)
            results[seed] = (status, np.array(json.loads(raw)["output"]),
                             engine.predict(x))

        results = {}
        threads = [threading.Thread(target=one, args=(s, results))
                   for s in (21, 22, 23, 24, 25, 26)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 6
        for status, got, want in results.values():
            assert status == 200
            np.testing.assert_allclose(got, want, **TOL)

    def test_concurrent_single_clouds_through_the_batcher(self, run_dir,
                                                          engine):
        eng = ServingEngine.from_run(run_dir, device="cpu")
        eng.start_microbatch(window_ms=200.0)
        srv = tserve.make_server(eng, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/predict"
        full = _inputs(eng, 8, seed=31)
        want = engine.predict(full)
        got = [None] * 8

        def one(i):
            body = json.dumps({k: v[i:i + 1].tolist()
                               for k, v in full.items()}).encode()
            got[i] = np.array(json.loads(_post(url, body)[1])["output"])
        try:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for i in range(8):
                np.testing.assert_allclose(got[i], want[i:i + 1], **TOL)
            s = eng.stats()
            assert s["coalesced_requests"] > 0 and s["dispatches"] < 8
        finally:
            assert tserve.drain_server(srv, eng) is True
        assert not eng.stats()["microbatch"]     # the drain stopped it

    def test_oversized_body_rejected(self, engine):
        """Bodies over the size cap get a 413 without being read."""
        srv = tserve.make_server(engine, port=0, max_request_mb=0.001)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/v1/predict"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, b"x" * 4096)
            assert ei.value.code == 413
            assert "exceeds" in json.loads(ei.value.read())["error"]
        finally:
            srv.shutdown()
            srv.server_close()

    def test_drain_completes_inflight_and_refuses_new(self):
        """The in-flight request completes with 200 while healthz flips to
        503 and new predicts are refused; then the listener is closed."""
        release = threading.Event()
        entered = threading.Event()

        class SlowStub:
            manifest = {"task": "classify", "inputs": [
                {"name": "x", "shape": [1, 2], "dtype": "float32"}]}
            stopped_microbatch = False

            def predict(self, inputs):
                entered.set()
                assert release.wait(timeout=60)
                return np.asarray(inputs["x"], np.float32) + 1.0

            def stats(self):
                return {"task": "classify"}

            def stop_microbatch(self):
                self.stopped_microbatch = True

        stub = SlowStub()
        srv = tserve.make_server(stub, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        body = json.dumps({"x": [[1.0, 2.0]]}).encode()
        inflight = {}

        def slow_request():
            try:
                inflight["status"], raw, _ = _post(url + "/v1/predict", body)
                inflight["out"] = json.loads(raw)["output"]
            except Exception as e:  # pragma: no cover - failure detail
                inflight["error"] = e

        t = threading.Thread(target=slow_request)
        t.start()
        assert entered.wait(timeout=30)  # request is now in flight
        drain_result = {}
        d = threading.Thread(target=lambda: drain_result.update(
            clean=tserve.drain_server(srv, stub, timeout_s=60)))
        d.start()
        assert srv.draining.wait(timeout=30)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/healthz", timeout=30)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/v1/predict", body)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        release.set()
        t.join(timeout=60)
        d.join(timeout=60)
        assert inflight.get("status") == 200, inflight
        assert inflight["out"] == [[2.0, 3.0]]
        assert drain_result["clean"] is True
        assert stub.stopped_microbatch
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(url + "/healthz", timeout=5)

    def test_drain_idempotent_and_timeout(self):
        """drain_server returns False when in-flight work outlasts the
        timeout, and a second call is a no-op returning True."""
        release = threading.Event()
        entered = threading.Event()

        class Stub:
            manifest = {"task": "classify", "inputs": [
                {"name": "x", "shape": [1, 2], "dtype": "float32"}]}

            def predict(self, inputs):
                entered.set()
                release.wait(timeout=60)
                return np.asarray(inputs["x"], np.float32)

            def stats(self):
                return {}

        stub = Stub()
        srv = tserve.make_server(stub, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        body = json.dumps({"x": [[0.0, 0.0]]}).encode()
        t = threading.Thread(target=lambda: _post(url + "/v1/predict", body))
        t.start()
        assert entered.wait(timeout=30)
        assert tserve.drain_server(srv, stub, timeout_s=0.2) is False
        assert tserve.drain_server(srv, stub, timeout_s=0.2) is True
        release.set()
        t.join(timeout=60)

    @pytest.mark.parametrize("case", ["names", "json", "object", "shape",
                                      "npz", "path_post", "path_get"])
    def test_errors(self, server, engine, case):
        """Bad inputs are 400 with the engine's message (as the JAX
        package's daemon answers them); unknown paths 404."""
        x = _inputs(engine, 1)
        bodies = {
            "names": json.dumps({"bogus": [[0.0]]}).encode(),
            "json": b"{not json",
            "object": b"[1,2]",
            "shape": json.dumps({**{k: v.tolist() for k, v in x.items()},
                                 "pc": x["pc"][:, :-1].tolist()}).encode(),
            "npz": b"not an npz",
        }
        if case == "path_get":
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(server + "/nope", timeout=30)
            assert ei.value.code == 404
            return
        path = "/v1/nope" if case == "path_post" else "/v1/predict"
        ctype = ("application/x-npz" if case == "npz"
                 else "application/json")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server + path, bodies.get(case, b"{}"), ctype)
        assert ei.value.code == (404 if case == "path_post" else 400)
        err = json.loads(ei.value.read())["error"]
        if case == "names":
            assert "missing inputs" in err
        if case == "shape":
            assert "expected shape" in err


def test_a_burst_of_connections_is_answered():
    """64 clients at once all get their answer: the stdlib server's listen
    backlog of 5 resets some of them (the JAX package's daemon does)."""
    class Stub:
        manifest = {"task": "classify", "inputs": [
            {"name": "x", "shape": [1, 2], "dtype": "float32"}]}

        def predict(self, inputs):
            return np.asarray(inputs["x"], np.float32) + 1.0

        def stats(self):
            return {}

    srv = tserve.make_server(Stub(), port=0)
    assert srv.request_queue_size >= 64
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/predict"
    got = {}

    def one(i):
        try:
            status, raw, _ = _post(url, json.dumps({"x": [[i, 0]]}).encode())
            got[i] = (status, json.loads(raw)["output"])
        except OSError as e:
            got[i] = e
    threads = [threading.Thread(target=one, args=(i,)) for i in range(64)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        tserve.drain_server(srv, Stub())
    assert got == {i: (200, [[i + 1.0, 1.0]]) for i in range(64)}


def test_the_jax_daemon_answers_the_same_codes_on_a_stub():
    """The same stub through both packages' servers: the same codes and
    bodies for health, manifest, predict, a bad body and an unknown path."""
    class Stub:
        manifest = {"task": "classify", "inputs": [
            {"name": "x", "shape": [1, 2], "dtype": "float32"}]}

        def predict(self, inputs):
            x = np.asarray(inputs["x"], np.float32)
            if x.ndim != 2:
                raise ValueError("x must be (B, 2)")
            return x * 2.0

        def stats(self):
            return {"task": "classify", "requests": 0}

    answers = []
    for mod in (tserve, jserve):
        srv = mod.make_server(Stub(), port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        got = []
        for path, body in (("/healthz", None), ("/v1/manifest", None),
                           ("/v1/predict", b'{"x": [[1, 2]]}'),
                           ("/v1/predict", b'{"x": [1, 2]}'),
                           ("/v1/other", b"{}"), ("/other", None)):
            try:
                if body is None:
                    r = urllib.request.urlopen(url + path, timeout=30)
                    code, raw = r.status, r.read()
                else:
                    code, raw, _ = _post(url + path, body)
            except urllib.error.HTTPError as e:
                code, raw = e.code, e.read()
            payload = json.loads(raw)
            payload.pop("ms", None)
            got.append((code, payload))
        mod.drain_server(srv, Stub())
        answers.append(got)
    assert answers[0] == answers[1]
    assert [c for c, _ in answers[0]] == [200, 200, 200, 400, 404, 404]


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,item", [
    (["--mesh_shape", "2"], "item 12"),
    (["--mesh_shape", "4,2"], "item 12"),
])
def test_unported_flags_raise(run_dir, flags, item):
    argv = ["--device", "cpu", "--port", "0", "--run", run_dir] + flags
    with pytest.raises(NotImplementedError, match=item):
        tserve.main(argv)


@pytest.mark.parametrize("flags", [["--batch_size", "2"],
                                   ["--checkpoint", "x.pt"],
                                   ["--mesh_shape", "2"]])
def test_artifact_refuses_run_flags(flags):
    # as the JAX daemon does: an artifact is fixed at export time
    with pytest.raises(SystemExit, match="only apply to --run"):
        tserve.main(["--device", "cpu", "--port", "0", "--artifact",
                     "export"] + flags)


def test_serve_defaults_to_cuda(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--run", run_dir, "--port", "0"])


def test_the_command_serves_and_drains_on_sigterm(run_dir):
    """``sonet-torch serve`` as a process: it prints where it listens,
    answers, and on SIGTERM drains and exits 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sonet_torch.cli", "serve", "--run", run_dir,
         "--device", "cpu", "--port", "0", "--microbatch_ms", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    try:
        first = json.loads(proc.stdout.readline())
        assert first["task"] == "classify" and first["device"] == "cpu"
        url = f"http://127.0.0.1:{first['port']}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["microbatch"] is True
        x = np.zeros((1, 64, 3), np.float32)
        body = json.dumps({"pc": x.tolist(), "sn": x.tolist(),
                           "node": x[:, :16].tolist()}).encode()
        assert _post(url + "/v1/predict", body)[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert last["drained"] is True and last["requests"] == 1
    assert "drain requested" in out
