"""``sonet-torch infer`` against ``sonet infer`` for the autoencoder, on
the CPU: the cases of ``tests/test_torch_infer.py`` on an autoencoder run
(a file of their own, each under a minute in one process)."""

import pytest

import test_torch_infer as infer_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return infer_cases.make_runs("autoencode", tmp_path_factory)


def test_infer_matches_jax(runs, tmp_path):
    infer_cases.check_infer_matches_jax(runs, tmp_path)


def test_scan_chunk_gives_the_same_rows(runs, tmp_path):
    infer_cases.check_scan_chunk(runs, tmp_path)
