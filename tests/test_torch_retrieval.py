"""The port's retrieval (``sonet_torch.retrieval``) against the JAX
package's, on the CPU: ranking, metrics, rank files, score extraction
through the port's ``eval_step`` and the gallery.

Scores on a grid of 1/8 with small entries make every product and sum of
the distance exact in float32, whatever the summation order, so both
packages compute the same distances to the bit and planted duplicate
rows are true ties: that is where candidate lists, ties and rank files
are held equal.  On random scores the two BLAS libraries round |a|^2 and
a.b differently; candidate lists still agree, and distances agree within
1e-5 except a query's distance to itself, which is 0 only up to that
rounding (``rank_all``'s docstring).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu import retrieval as jretrieval
from sonet_tpu.train import loops as jloops
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import retrieval as tretrieval
from sonet_torch import train as ttrain
from sonet_torch.convert import flatten, load_jax_variables

torch.set_num_threads(2)

DIST_TOL = 1e-5
SCORE_TOL = 1e-4


def _grid_scores(seed, T=40, C=5, duplicates=6):
    """Scores k/8 in [-2, 2], with ``duplicates`` rows copied exactly."""
    rs = np.random.RandomState(seed)
    s = rs.randint(-16, 17, (T, C)).astype(np.float32) / 8
    src = rs.choice(T, duplicates, replace=False)
    dst = rs.choice(np.setdiff1d(np.arange(T), src), duplicates,
                    replace=False)
    s[dst] = s[src]
    return s


def _assert_same_ranking(got, want, skip_self=False):
    assert len(got) == len(want)
    for q, ((gi, gd), (wi, wd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi)
        assert gi.dtype.kind == "i" and gd.dtype == np.float32
        keep = gi != q if skip_self else slice(None)
        np.testing.assert_allclose(gd[keep], wd[keep], rtol=0, atol=DIST_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_rank_all_matches_jax_with_ties(seed):
    s = _grid_scores(seed)
    got, want = tretrieval.rank_all(s), jretrieval.rank_all(s)
    _assert_same_ranking(got, want)
    # the planted duplicates are real ties, broken toward the lower index
    ties = sum(int((np.diff(d) == 0).sum()) for _, d in got)
    assert ties > 0
    for ids, d in got:
        for a in range(len(d) - 1):
            if d[a] == d[a + 1]:
                assert ids[a] < ids[a + 1]


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_rank_all_matches_jax_on_random_scores(scale):
    s = (np.random.RandomState(1).randn(60, 55) * scale).astype(np.float32)
    got, want = tretrieval.rank_all(s), jretrieval.rank_all(s)
    _assert_same_ranking(got, want, skip_self=True)
    for q, (ids, d) in enumerate(got):
        assert ids[0] == q                     # a query finds itself first


def test_rank_all_top_and_tensor_input():
    s = _grid_scores(4, T=50)
    for top in (1, 7):
        got = tretrieval.rank_all(torch.from_numpy(s), top=top)
        _assert_same_ranking(got, jretrieval.rank_all(s, top=top))
        assert all(len(ids) <= top for ids, _ in got)


def test_metrics_and_rank_files_match_jax(tmp_path):
    s = _grid_scores(5, T=48, C=4)
    labels = np.random.RandomState(6).randint(0, 4, 48)
    ids = np.arange(1000, 1048)
    got, want = tretrieval.rank_all(s), jretrieval.rank_all(s)
    for ks in ((1, 5, 10), (1, 2)):
        assert (tretrieval.retrieval_metrics(got, labels, ks=ks)
                == jretrieval.retrieval_metrics(want, labels, ks=ks))
    tretrieval.write_rank_files(got, ids, str(tmp_path / "t"))
    jretrieval.write_rank_files(want, ids, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert len(names) == 48 and names[0] == "001000"
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n


def test_retrieval_gallery(tmp_path):
    class DS:
        def __getitem__(self, i):
            rs = np.random.RandomState(i)
            return {"pc": rs.randn(30, 3).astype(np.float32)}

    results = tretrieval.rank_all(_grid_scores(0, T=6, C=3, duplicates=1))
    path = tretrieval.write_retrieval_gallery(
        results, np.arange(100, 106), DS(), str(tmp_path), num_queries=2,
        top=2)
    content = open(path).read()
    assert "retrieval results" in content and "query 100" in content
    assert os.path.getsize(tmp_path / "q0_query.png") > 500


# ---------------------------------------------------------------------------
# extract_scores through the port's eval_step, on carried weights
# ---------------------------------------------------------------------------

def _batches(cfg, n_batches=3):
    out = []
    for i in range(n_batches):
        rs = np.random.RandomState(10 + i)
        B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
        pc = rs.randn(B, N, 3).astype(np.float32)
        out.append({
            "pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
            "node": (pc[:, :M] + 0.05 * rs.randn(B, M, 3)).astype(np.float32),
            "label": rs.randint(0, cfg.classes, B).astype(np.int64),
            "id": np.arange(i * B, (i + 1) * B) + 500,
            "valid": np.int32(B if i < n_batches - 1 else B - 1)})
    return out


@pytest.mark.parametrize("som_k", [4, 0])
def test_extract_scores_matches_jax(som_k):
    over = dict(task="retrieve", dataset="shrec", classes=3, dropout=0.0,
                som_k=som_k)
    jc, tc = jcfg.tiny_test().replace(**over), tcfg.tiny_test().replace(**over)
    batches = _batches(jc)
    b0 = batches[0]
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0),
                           (b0["pc"], b0["sn"], b0["node"]))
    _, j_eval = jloops.make_steps(jm, jc, 1)
    want = jretrieval.extract_scores(
        j_eval, js, [dict(b) for b in batches],
        lambda b: {k: jnp.asarray(v) for k, v in b.items()})

    ts = ttrain.init_state(tc, device="cpu")
    load_jax_variables(ts.model, flatten(
        {"params": js.params, "batch_stats": js.batch_stats}))
    _, t_eval = ttrain.make_steps(tc, 1)
    got = tretrieval.extract_scores(
        t_eval, ts, [dict(b) for b in batches],
        lambda b: {k: torch.from_numpy(v) for k, v in b.items()},
        scan_chunk=2)
    scores, labels, ids = got
    assert scores.shape == (11, 3) and scores.dtype == np.float32
    scale = max(1.0, float(np.abs(want[0]).max()))
    assert np.abs(scores - want[0]).max() <= SCORE_TOL * scale
    np.testing.assert_array_equal(labels, want[1])
    np.testing.assert_array_equal(ids, want[2])
    assert ids[-1] == 500 + 10


def test_extract_scores_without_ids_numbers_the_items():
    cfg = tcfg.tiny_test()
    batches = [{k: v for k, v in b.items() if k != "id"}
               for b in _batches(cfg, 2)]
    _, t_eval = ttrain.make_steps(cfg, 1)
    state = ttrain.init_state(cfg, device="cpu")
    _, _, ids = tretrieval.extract_scores(
        t_eval, state, batches,
        lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_array_equal(ids, np.arange(7))
