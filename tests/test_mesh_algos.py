"""Mesh-backed protocol algorithms == single-device engines: every
algorithm the harness runs — including
the preprocessing sweeps — must be selectable on a device mesh and agree
with the single-device implementations.
"""

import numpy as np
import pytest

from ppr_tpu.models import AlgoConf, AlgoType
from ppr_tpu.parallel.sharded import make_mesh
from ppr_tpu.parallel.mesh_algos import (
    MeshForaWholeGraph,
    MeshForwardPush,
    MeshMonteCarlo,
    MeshNeo4jMethod,
    mesh_algo_obj,
)


@pytest.fixture(scope="module")
def ds():
    from ppr_tpu.graph.io import synthetic_powerlaw

    return synthetic_powerlaw(1024, 6, seed=13, dense_threshold=0)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)          # (data=4, graph=2)


def _sources(ds, k=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ds.graph.n, size=k).astype(np.int32)


def test_mesh_forward_push_matches_single(ds, mesh):
    conf = AlgoConf(0.15, seed=3)
    single = conf.new_algo_obj(AlgoType.FWDPUSH, ds, 10)
    sharded = MeshForwardPush(ds, 0.15, mesh=mesh)
    sources = _sources(ds)
    rmax = 1e-5
    a = single.compute_whole_graph_batch(sources, rmax)
    b = sharded.compute_whole_graph_batch(sources, rmax)
    np.testing.assert_allclose(b, a, atol=5e-6, rtol=1e-4)


def test_mesh_neo4j_matches_single(ds, mesh):
    conf = AlgoConf(0.15, seed=3)
    single = conf.new_algo_obj(AlgoType.NEO4J_METHOD, ds, 10)
    sharded = MeshNeo4jMethod(ds, 0.15, mesh=mesh)
    sources = _sources(ds, seed=1)
    for iters in (1, 20):        # traced count: one program, two params
        a = single.compute_whole_graph_batch(sources, iters)
        b = sharded.compute_whole_graph_batch(sources, iters)
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=1e-4)


def test_mesh_fora_whole_graph_oracle(ds, mesh):
    """Both engines complete the residual to eps*delta; their results agree
    with the exact oracle within that truncation (the push-round counts are
    wall-clock-adaptive, so engine-vs-engine equality is not defined)."""
    from tests.test_node_sharded_fora import _exact_rows

    sharded = MeshForaWholeGraph(ds, 0.15, mesh=mesh)
    sources = _sources(ds, k=4, seed=2)
    eps = 0.5
    out = sharded.compute_whole_graph_batch(sources, eps)
    exact = _exact_rows(ds, sources)
    assert np.abs(out - exact).max() <= eps / ds.graph.n + 1e-5
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=eps / ds.graph.n)


def test_mesh_monte_carlo_statistical(ds, mesh):
    from tests.test_node_sharded_fora import _exact_rows

    mc = MeshMonteCarlo(ds, 0.15, mesh=mesh, seed=5)
    sources = _sources(ds, k=4, seed=3)
    out = mc.compute_whole_graph_batch(sources, 1.0)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    exact = _exact_rows(ds, sources)
    # eps=1.0 at n=1024 -> ~23k walks/source; MC noise ~ 1e-2
    assert np.abs(out - exact).max() < 0.05


def test_mesh_algo_obj_covers_all_types(ds, mesh):
    for t in (AlgoType.BASE_WHOLE_GRAPH, AlgoType.FORA_TOPK,
              AlgoType.FORA_WHOLE_GRAPH, AlgoType.FWDPUSH,
              AlgoType.NEO4J_METHOD, AlgoType.MC):
        algo = mesh_algo_obj(t, ds, 0.15, 10, mesh=mesh)
        assert algo is not None


def test_harness_runs_on_mesh(tmp_path):
    """The protocol harness with a mesh: preprocessing (Test 3 semantics)
    through the sharded engines end to end, rows written, store resumable."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.harness import PerfHarness, TestType

    ds = synthetic_powerlaw(512, 4, seed=21, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)
    h = PerfHarness(ds, out_dir=str(tmp_path), progress=False, mesh=mesh)
    import os

    cwd = os.getcwd()
    os.chdir(tmp_path)           # prep stores are cwd-relative
    try:
        res = h.algo_perf_test(AlgoType.FWDPUSH, 6, -1, 1e-4, -1.0, True,
                               TestType.WHOLE_GRAPH)
        assert res.prep_ms is not None and res.prep_bytes > 0
        assert res.avg_max_err < 0.05
        res2 = h.algo_perf_test(AlgoType.BASE_WHOLE_GRAPH, 6, 10, -1, 1e-3,
                                False, TestType.TOPK)
        assert res2.avg_precision is not None
    finally:
        os.chdir(cwd)
    out = tmp_path / f"{ds.name}_AlgoPerfResults.txt"
    assert out.exists() and len(out.read_text().strip().splitlines()) >= 2


def test_mesh_monte_carlo_weighted_statistical(mesh):
    """Weighted MC on the mesh uses the alias-table law: statistical
    agreement with the weighted exact oracle (uniform sampling would
    diverge visibly on a strongly skewed weight distribution)."""
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset

    rng = np.random.default_rng(9)
    n, m = 512, 4096
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    w = rng.uniform(0.05, 8.0, size=m)
    g = build_graph(src, dst, n=n, weights=w, dense_threshold=0)
    ds = Dataset(graph=g, names=[str(i) for i in range(n)], name="wmc")

    # weighted exact oracle (dense numpy, dangling-to-source)
    P = np.zeros((n, n))
    np.add.at(P, (src, dst), w)
    row = P.sum(axis=1)
    dangling = row == 0
    P[~dangling] /= row[~dangling][:, None]
    sources = np.array([3, 50, 200], np.int32)
    exact = np.zeros((3, g.n_pad))
    for i, s in enumerate(sources):
        p = np.zeros(n); r = np.zeros(n); r[s] = 1.0
        for _ in range(200):
            p += 0.15 * r
            rem = 0.85 * r
            dm = rem[dangling].sum()
            r = rem @ P
            r[s] += dm
        exact[i, :n] = p

    mc = MeshMonteCarlo(ds, 0.15, mesh=mesh, seed=4)
    out = mc.compute_whole_graph_batch(sources, 0.5)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    assert np.abs(out - exact).max() < 0.05
