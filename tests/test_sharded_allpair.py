"""Sharded BASE all-pair preprocessing == single-device path.

The backward-search sweep and the full BASE preprocessing+query pipeline
run on the virtual 8-device (data, graph) CPU mesh and must reproduce the
single-device results: identical reverse-push reserves (to reassociation
noise) and identical persisted store rows.
"""

import numpy as np
import pytest

from ppr_tpu.models.backward_search import BackwardSearch
from ppr_tpu.models.base_allpair import BaseAllPair
from ppr_tpu.parallel.sharded import make_mesh
from ppr_tpu.parallel.sharded_allpair import (
    ShardedBackwardSearch,
    sharded_base_allpair,
)

ALPHA = 0.15


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, data=4, graph=2)


def _assert_bws_match(graph, mesh, targets, rmax):
    single = BackwardSearch(graph, ALPHA, rmax=rmax)
    sharded = ShardedBackwardSearch(graph, ALPHA, rmax=rmax, mesh=mesh)
    want = single.whole_graph(targets)
    got_res = sharded.whole_graph(targets)
    assert got_res.shape == want.shape
    np.testing.assert_allclose(got_res, want, atol=5e-6, rtol=1e-4)


def test_sharded_backward_search_got(got, mesh):
    _assert_bws_match(got.graph, mesh, np.arange(24), rmax=1e-3)


def test_sharded_backward_search_tight_rmax(got, mesh):
    # tighter rmax -> more sweeps -> exercises the pmax'd loop control
    _assert_bws_match(got.graph, mesh, np.array([0, 3, 17, 50, 101]),
                      rmax=1e-5)


def test_sharded_backward_search_synth(mesh):
    from ppr_tpu.graph.io import synthetic_powerlaw

    ds = synthetic_powerlaw(1024, 6, seed=11)
    _assert_bws_match(ds.graph, mesh, np.arange(0, 1024, 37), rmax=1e-4)


def test_sharded_backward_search_odd_batch(got, mesh):
    # batch not divisible by the data axis: padding rows must be dropped
    _assert_bws_match(got.graph, mesh, np.array([5, 9, 33]), rmax=1e-3)


def test_sharded_base_allpair_store_rows(got, mesh, tmp_path, monkeypatch):
    """Full preprocessing on the mesh writes the same store rows (ids,
    order, values) as the single-device sweep, and the file-read query
    paths agree."""
    monkeypatch.chdir(tmp_path)
    threshold, k = 1e-3, 5

    single = BaseAllPair(got, ALPHA, target_batch=128)
    single.prep_dirname = "single_store"
    single.preprocessing(threshold, k, progress=False)

    sharded = sharded_base_allpair(got, ALPHA, mesh=mesh, target_batch=128)
    sharded.prep_dirname = "sharded_store"
    sharded.preprocessing(threshold, k, progress=False)

    probe = np.array([0, 3, 14, 50, 101, got.graph.n - 1])
    want = single.compute_whole_graph_batch(probe)
    got_rows = sharded.compute_whole_graph_batch(probe)
    np.testing.assert_allclose(got_rows, want, atol=5e-6, rtol=1e-4)
    for a, b in zip(sharded._last_order, single._last_order):
        np.testing.assert_array_equal(a, b)

def test_sharded_backward_search_weighted(mesh):
    from ppr_tpu.graph.io import synthetic_weighted

    ds = synthetic_weighted(512, 6, seed=13)
    _assert_bws_match(ds.graph, mesh, np.arange(0, 512, 29), rmax=1e-4)
