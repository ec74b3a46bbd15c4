"""The small-graph dense-operator paths (PowerMethod, Neo4jMethod): XLA's
dense matmul loop at ``Precision.HIGHEST`` against float64 numpy, on graphs
with dangling nodes and self loops."""

import numpy as np
import pytest

from conftest import exact_ppr_dangling_to_source
from ppr_tpu.graph.csr import build_graph
from ppr_tpu.graph.io import Dataset

ALPHA = 0.15


def _dataset(src, dst, n, **kw):
    g = build_graph(np.asarray(src), np.asarray(dst), n=n, **kw)
    return Dataset(graph=g, names=[str(i) for i in range(n)], name="t")


def _tiny():
    #   0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 0, 4 (dangling), 5 -> 5 (self loop)
    return [0, 0, 1, 2, 3, 5], [1, 2, 2, 0, 0, 5], 6


def _random(n=300, m=1500, seed=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    loops = rng.choice(n, 20, replace=False)          # explicit self loops
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])
    dangling = rng.choice(n, 15, replace=False)       # out-degree 0
    keep = ~np.isin(src, dangling)
    return src[keep], dst[keep], n


GRAPHS = {"tiny": _tiny, "random300": _random}


@pytest.mark.parametrize("batch", [1, 12])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_power_method_dense_matches_float64(graph, batch):
    from ppr_tpu.models import AlgoConf

    src, dst, n = GRAPHS[graph]()
    ds = _dataset(src, dst, n)
    g = ds.graph
    assert g.has_dense
    assert (np.asarray(g.out_deg)[:n] == 0).any()      # dangling present
    assert (np.asarray(src) == np.asarray(dst)).any()  # self loop present
    sources = np.arange(batch) * 7 % n
    out = AlgoConf(ALPHA).set_conf_power_method(ds) \
        .compute_whole_graph_batch(sources)
    assert out.shape == (batch, g.n_pad)
    for row, s in zip(out, sources):
        want = exact_ppr_dangling_to_source(src, dst, n, int(s), ALPHA,
                                            iters=100)
        np.testing.assert_allclose(row[:n], want, atol=2e-5)
        assert not row[n:].any()                       # padding stays zero


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_neo4j_method_dense_matches_sparse(graph):
    from ppr_tpu.models import AlgoConf

    src, dst, n = GRAPHS[graph]()
    dense = _dataset(src, dst, n)
    sparse = _dataset(src, dst, n, dense_threshold=0)
    assert dense.graph.has_dense and not sparse.graph.has_dense
    sources = np.arange(9) * 5 % n
    conf = AlgoConf(ALPHA)
    a = conf.set_conf_neo4j_method(dense).compute_whole_graph_batch(
        sources, 30)
    b = conf.set_conf_neo4j_method(sparse).compute_whole_graph_batch(
        sources, 30)
    np.testing.assert_allclose(a, b, atol=2e-6)
    np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-5)
