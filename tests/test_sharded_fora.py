"""End-to-end sharded FORA top-k == single-device engine.

Runs the full annealed FORA top-k query path on the virtual 8-device CPU
mesh and asserts the results match the single-device engine: same top-k id
sets (tie-expanded) and near-identical dense scores (they differ only by
float reassociation across edge chunks / mesh collectives).
"""

import numpy as np
import pytest

from ppr_tpu.models import AlgoConf
from ppr_tpu.ops.topk import topk_ids_with_ties
from ppr_tpu.parallel.sharded import make_mesh
from ppr_tpu.parallel.sharded_fora import ShardedForaTopk

EPS = 0.5
K = 10


def _single_device_engine(ds, k=K):
    conf = AlgoConf(0.15, seed=7)
    fora = conf.set_conf_fora_topk(ds, k)
    fora.push = "none"          # the annealed propagation path (deterministic)
    fora.completion = "spmv"
    return fora


def _assert_topk_match(ds, mesh, sources, k=K, eps=EPS):
    single = _single_device_engine(ds, k)
    sharded = ShardedForaTopk(ds, alpha=0.15, k=k, mesh=mesh)

    dense_single = single.compute_topk_batch(sources, k, eps)
    dense_sharded = sharded.compute_topk_batch(sources, k, eps)

    assert dense_sharded.shape == dense_single.shape
    # scores agree to float-reassociation noise
    np.testing.assert_allclose(dense_sharded, dense_single,
                               atol=5e-6, rtol=1e-4)
    # top-k id sets (tie-expanded, with a tolerance far below any true
    # score gap) are identical per row
    for i in range(len(sources)):
        ids_single = set(
            topk_ids_with_ties(dense_single[i], k, tol=1e-6).tolist()
        )
        ids_sharded = set(
            topk_ids_with_ties(dense_sharded[i], k, tol=1e-6).tolist()
        )
        assert ids_sharded == ids_single, f"row {i} (source {sources[i]})"
    return single, sharded


def test_sharded_topk_matches_single_device_got(got):
    mesh = make_mesh(8)                       # (data=4, graph=2)
    rng = np.random.default_rng(0)
    sources = rng.integers(0, got.graph.n, size=8).astype(np.int32)
    _assert_topk_match(got, mesh, sources)


def test_sharded_topk_matches_single_device_synthetic():
    from ppr_tpu.graph.io import synthetic_powerlaw

    ds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)      # the other mesh shape
    rng = np.random.default_rng(1)
    sources = rng.integers(0, ds.graph.n, size=6).astype(np.int32)
    single, sharded = _assert_topk_match(ds, mesh, sources)

    # serving path: device-selected (vals, ids) consistent with the dense
    # result and with the single-device serving call
    vals, ids = sharded.compute_topk_ids_batch(sources, K, EPS)
    vals1, ids1 = single.compute_topk_ids_batch(sources, K, EPS)
    assert vals.shape[0] == len(sources)
    for i in range(len(sources)):
        assert set(ids[i][:K].tolist()) == set(ids1[i][:K].tolist())
        np.testing.assert_allclose(vals[i][:K], vals1[i][:K],
                                   atol=5e-6, rtol=1e-4)


def test_sharded_topk_dangling_source():
    """A dangling source short-circuits to pi(s, s) = 1 on the mesh too
    (Fora_Topk.java:128-132)."""
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset

    # node 3 dangling; nodes 0-2 form a cycle with an edge into 3
    src = np.array([0, 1, 2, 0])
    dst = np.array([1, 2, 0, 3])
    g = build_graph(src, dst, n=4, dense_threshold=0)
    ds = Dataset(graph=g, names=list("abcd"), name="tiny4")
    mesh = make_mesh(4, data=2, graph=2)
    sharded = ShardedForaTopk(ds, alpha=0.15, k=2, mesh=mesh)
    sources = np.array([3, 0], np.int32)
    dense = sharded.compute_topk_batch(sources, 2, EPS)
    assert dense[0, 3] == pytest.approx(1.0)
    assert dense[0].sum() == pytest.approx(1.0)
    # non-dangling row conserves mass up to the eps*delta truncation
    assert dense[1].sum() == pytest.approx(1.0, abs=EPS * 0.5 * 0.5)


def test_sharded_topk_weighted_matches_single_device():
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset

    rng = np.random.default_rng(2)
    n, m = 1024, 6144
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    w = rng.uniform(0.1, 4.0, size=m)
    g = build_graph(src, dst, n=n, weights=w, dense_threshold=0)
    ds = Dataset(graph=g, names=[str(i) for i in range(n)], name="wshard")
    mesh = make_mesh(8)
    sources = rng.integers(0, n, size=4).astype(np.int32)
    _assert_topk_match(ds, mesh, sources)
