"""Node-sharded end-to-end FORA top-k == single-device engine.

Runs the full annealed FORA top-k query path with O(n/S)-memory node-sharded
state on the virtual 8-device CPU mesh and asserts it matches both the
single-device engine and the edge-sharded ShardedForaTopk: same tie-expanded
top-k id sets, near-identical dense scores (float reassociation only), and —
the point of the engine — per-device reserve shards of shape
[B/data, n_pad/S], never [B, n_pad].
"""

import numpy as np
import pytest

from ppr_tpu.models import AlgoConf
from ppr_tpu.ops.topk import topk_ids_with_ties
from ppr_tpu.parallel.sharded import make_mesh
from ppr_tpu.parallel.sharded_fora import ShardedForaTopk
from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

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
    node_sharded = NodeShardedForaTopk(ds, alpha=0.15, k=k, mesh=mesh)

    dense_single = single.compute_topk_batch(sources, k, eps)
    dense_ns = node_sharded.compute_topk_batch(sources, k, eps)

    assert dense_ns.shape == dense_single.shape
    np.testing.assert_allclose(dense_ns, dense_single, atol=5e-6, rtol=1e-4)
    for i in range(len(sources)):
        ids_single = set(
            topk_ids_with_ties(dense_single[i], k, tol=1e-6).tolist()
        )
        ids_ns = set(topk_ids_with_ties(dense_ns[i], k, tol=1e-6).tolist())
        assert ids_ns == ids_single, f"row {i} (source {sources[i]})"
    return single, node_sharded


def test_node_sharded_topk_matches_single_device_got(got):
    mesh = make_mesh(8)                       # (data=4, graph=2)
    rng = np.random.default_rng(0)
    sources = rng.integers(0, got.graph.n, size=8).astype(np.int32)
    _assert_topk_match(got, mesh, sources)


def test_node_sharded_topk_matches_engines_synthetic():
    from ppr_tpu.graph.io import synthetic_powerlaw

    ds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)      # the other mesh shape
    rng = np.random.default_rng(1)
    sources = rng.integers(0, ds.graph.n, size=6).astype(np.int32)
    single, node_sharded = _assert_topk_match(ds, mesh, sources)

    # also equal to the edge-sharded engine on the same mesh
    edge_sharded = ShardedForaTopk(ds, alpha=0.15, k=K, mesh=mesh)
    dense_edge = edge_sharded.compute_topk_batch(sources, K, EPS)
    dense_ns = node_sharded.compute_topk_batch(sources, K, EPS)
    np.testing.assert_allclose(dense_ns, dense_edge, atol=5e-6, rtol=1e-4)

    # serving path: device-selected (vals, ids) consistent with the
    # single-device serving call
    vals, ids = node_sharded.compute_topk_ids_batch(sources, K, EPS)
    vals1, ids1 = single.compute_topk_ids_batch(sources, K, EPS)
    assert vals.shape[0] == len(sources)
    for i in range(len(sources)):
        assert set(ids[i][:K].tolist()) == set(ids1[i][:K].tolist())
        np.testing.assert_allclose(vals[i][:K], vals1[i][:K],
                                   atol=5e-6, rtol=1e-4)


def test_node_sharded_state_is_o_n_over_s():
    """The engine's whole point: per-device reserve shards are
    [B/data, n_pad/S] — the node dimension is PARTITIONED, not replicated
    (contrast ShardedForaTopk's P(None, 'data') full-width state)."""
    from ppr_tpu.graph.io import synthetic_powerlaw

    ds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)
    eng = NodeShardedForaTopk(ds, alpha=0.15, k=K, mesh=mesh)
    sources, _ = eng._pad_batch(np.arange(8, dtype=np.int32))
    vals, ids, p_local, iters = eng._run(sources, K, 4 * K, EPS * 0.5)

    n_pad = ds.graph.n_pad
    assert p_local.shape == (len(sources), n_pad)
    expect = eng.final_state_shard_shape(len(sources))
    assert expect == (len(sources) // 2, n_pad // 4)
    for shard in p_local.addressable_shards:
        assert shard.data.shape == expect
    # block/edge arrays are node-sharded too: each device holds 1/S of the
    # (dst-shard, src-shard) block table rows
    _, arrays = eng._program(K, 4 * K)
    for shard in arrays["src"].addressable_shards:
        assert shard.data.shape[0] == 1          # one dst-shard row


def test_node_sharded_topk_dangling_source():
    """A dangling source short-circuits to pi(s, s) = 1 on the node-sharded
    mesh too (Fora_Topk.java:128-132)."""
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset

    src = np.array([0, 1, 2, 0])
    dst = np.array([1, 2, 0, 3])
    g = build_graph(src, dst, n=4, dense_threshold=0)
    ds = Dataset(graph=g, names=list("abcd"), name="tiny4")
    mesh = make_mesh(4, data=2, graph=2)
    eng = NodeShardedForaTopk(ds, alpha=0.15, k=2, mesh=mesh)
    sources = np.array([3, 0], np.int32)
    dense = eng.compute_topk_batch(sources, 2, EPS)
    assert dense[0, 3] == pytest.approx(1.0)
    assert dense[0].sum() == pytest.approx(1.0)
    assert dense[1].sum() == pytest.approx(1.0, abs=EPS * 0.5 * 0.5)


def test_node_sharded_topk_weighted_matches_single_device():
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


def _exact_rows(ds, sources, alpha=0.15):
    from tests.conftest import exact_ppr_dangling_to_source

    g = ds.graph
    src = np.asarray(g.edge_src)[: g.m]
    dst = np.asarray(g.edge_dst)[: g.m]
    rows = np.zeros((len(sources), g.n_pad))
    for i, s in enumerate(sources):
        rows[i, : g.n] = exact_ppr_dangling_to_source(
            src, dst, g.n, int(s), alpha
        )[: g.n]
    return rows


def test_node_sharded_whole_graph_spmv_vs_oracle():
    """SpMV-completion whole-graph FORA on the ring partition: per-node
    error bounded by the eps*delta residual truncation."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaWholeGraph

    ds = synthetic_powerlaw(512, 6, seed=9, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)
    eng = NodeShardedForaWholeGraph(ds, alpha=0.15, mesh=mesh,
                                    completion="spmv")
    rng = np.random.default_rng(4)
    sources = rng.integers(0, ds.graph.n, size=5).astype(np.int32)
    eps = 0.5
    out = eng.compute_whole_graph_batch(sources, eps)
    exact = _exact_rows(ds, sources)
    # truncation leaves <= eps*delta residue; each node's error is below it
    assert np.abs(out - exact).max() <= eps / ds.graph.n + 1e-5
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=eps / ds.graph.n)


def test_node_sharded_whole_graph_walks_completion():
    """Walks-mode completion (rotating-adjacency ring walks,
    Fora_Whole_Graph.java:119-140): statistical agreement with the oracle
    and exact mass conservation up to sampling noise."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaWholeGraph

    ds = synthetic_powerlaw(256, 5, seed=11, dense_threshold=0)
    mesh = make_mesh(8, data=2, graph=4)
    eng = NodeShardedForaWholeGraph(ds, alpha=0.15, mesh=mesh,
                                    completion="walks", seed=3)
    sources = np.array([1, 7, 20, 33], np.int32)
    out = eng.compute_whole_graph_batch(sources, 0.5)
    exact = _exact_rows(ds, sources)
    assert out.shape == (len(sources), ds.graph.n_pad)
    # every walk deposits its weight exactly once -> rows sum to ~1
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    # eps=0.5 at n=256 gives ~2.5e4 walks/unit residue: MC noise ~ 1e-2
    assert np.abs(out - exact).max() < 0.03


def test_node_sharded_whole_graph_dangling_source():
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaWholeGraph

    src = np.array([0, 1, 2, 0])
    dst = np.array([1, 2, 0, 3])
    g = build_graph(src, dst, n=4, dense_threshold=0)
    ds = Dataset(graph=g, names=list("abcd"), name="tiny4")
    mesh = make_mesh(4, data=2, graph=2)
    eng = NodeShardedForaWholeGraph(ds, alpha=0.15, mesh=mesh,
                                    completion="walks")
    out = eng.compute_whole_graph_batch(np.array([3], np.int32), 0.5)
    assert out[0, 3] == pytest.approx(1.0)
    assert out[0].sum() == pytest.approx(1.0)


def test_node_sharded_topk_single_graph_shard():
    """graph=1 degenerates to data-parallel (no ring hops) and must still
    match — guards the S==1 rotation short-circuit."""
    from ppr_tpu.graph.io import synthetic_powerlaw

    ds = synthetic_powerlaw(512, 6, seed=9, dense_threshold=0)
    mesh = make_mesh(4, data=4, graph=1)
    rng = np.random.default_rng(3)
    sources = rng.integers(0, ds.graph.n, size=4).astype(np.int32)
    _assert_topk_match(ds, mesh, sources)
