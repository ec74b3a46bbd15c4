import jax.numpy as jnp
import numpy as np


def test_service_topk(got):
    from ppr_tpu.service import PPRService
    from ppr_tpu.models import AlgoConf

    svc = PPRService.from_dataset(got, alpha=0.15, k=10, seed=5)
    hits = svc.top_k([3, 14], k=10)
    assert len(hits) == 2
    for row in hits:
        assert len(row) >= 1
        scores = [h.score for h in row]
        assert scores == sorted(scores, reverse=True)
        assert all(isinstance(h.name, str) for h in row)

    # agreement with the oracle top-1
    pm = AlgoConf(0.15).set_conf_power_method(got)
    oracle = pm.compute_whole_graph_batch(np.asarray([3, 14]))
    for row, orc in zip(hits, oracle):
        assert row[0].node == int(np.argmax(orc))


def test_service_whole_graph(got):
    from ppr_tpu.service import PPRService

    svc = PPRService.from_dataset(got)
    dense = svc.whole_graph([7])
    assert dense.shape == (1, got.n)
    np.testing.assert_allclose(dense.sum(), 1.0, atol=0.02)


def test_service_hub_split_and_calibrate(got):
    from ppr_tpu.service import PPRService

    svc = PPRService.from_dataset(got, hub_split=16, calibrate=True)
    assert svc._topk_algo.hub_split is not None
    assert svc._topk_algo.hub_split.hub_matrix.dtype == jnp.bfloat16
    # calibration installed measured (positive) constants on both algos
    for algo in (svc._topk_algo, svc._wg_algo):
        assert algo.avg_rand_walk_time_ns > 0
        assert algo.spmv_ns_per_edge > 0

    plain = PPRService.from_dataset(got)
    a = svc.top_k([3, 14], k=10)
    b = plain.top_k([3, 14], k=10)
    assert [h.node for h in a[0]] == [h.node for h in b[0]]
    assert [h.node for h in a[1]] == [h.node for h in b[1]]


def test_service_topk_tie_window_fallback():
    """A tie set larger than the device selection window must fall back to
    the dense path and return the full tie expansion (reference semantics,
    Forward_Push.java:413-429)."""
    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset
    from ppr_tpu.service import PPRService

    n = 61
    src = np.zeros(60, np.int64)
    dst = np.arange(1, 61)
    g = build_graph(src, dst, n=n)
    ds = Dataset(name="star", graph=g, names=[f"n{i}" for i in range(n)])
    svc = PPRService.from_dataset(ds)
    row = svc.top_k([0], k=10)[0]
    # source + all 60 tied leaves
    assert len(row) == 61
    leaves = {h.node for h in row if h.node != 0}
    assert leaves == set(range(1, 61))


def test_fora_topk_ids_batch_matches_dense(got):
    from ppr_tpu.models import AlgoConf
    from ppr_tpu.ops.topk import (
        topk_ids_with_ties, topk_ids_with_ties_from_pairs,
    )

    sources = np.arange(0, got.n, 11)
    fora = AlgoConf(0.15, seed=5).set_conf_fora_topk(got, 10)
    fora.completion = "spmv"
    dense = fora.compute_topk_batch(sources, 10, 0.5)
    vals, ids = fora.compute_topk_ids_batch(sources, 10, 0.5)
    for i in range(len(sources)):
        a = set(topk_ids_with_ties(dense[i], 10).tolist())
        b = set(topk_ids_with_ties_from_pairs(vals[i], ids[i], 10).tolist())
        assert a == b


def test_service_on_mesh_matches_single(got):
    """PPRService(mesh=...) serves FORA top-k from the sharded engine and
    returns the same hits as the single-device service."""
    from ppr_tpu.parallel.sharded import make_mesh
    from ppr_tpu.service import PPRService

    single = PPRService.from_dataset(got, alpha=0.15, k=10, seed=3)
    meshed = PPRService.from_dataset(got, alpha=0.15, k=10, seed=3,
                                     mesh=make_mesh(8, data=4, graph=2))
    sources = [3, 14, 50, 7, 101]
    want = single.top_k(sources, k=10)
    got_rows = meshed.top_k(sources, k=10)
    for w_row, g_row in zip(want, got_rows):
        assert {h.node for h in g_row} == {h.node for h in w_row}


def test_service_precomputed_store(got, tmp_path, monkeypatch):
    """precomputed=(threshold, k) serves every query from an existing BASE
    all-pair store — no device work — and a fresh service in a new
    'process' (fresh objects) can attach the same store."""
    import pytest

    from ppr_tpu.models.base_allpair import BaseAllPair
    from ppr_tpu.service import PPRService

    monkeypatch.chdir(tmp_path)
    threshold = 1e-3
    BaseAllPair(got, 0.15, target_batch=128).preprocessing(
        threshold, -1, progress=False)

    svc = PPRService.from_dataset(got, alpha=0.15, k=10,
                                  precomputed=(threshold, -1))
    hits = svc.top_k([3, 14], k=10)
    assert hits and hits[0][0].node is not None
    dense = svc.whole_graph([3])
    assert dense.shape[1] == got.graph.n
    # served scores are exactly the stored reverse-push reserves
    top = hits[0][0]
    assert dense[0][top.node] == top.score

    with pytest.raises(FileNotFoundError):
        PPRService.from_dataset(got, precomputed=(0.12345, -1))


def test_service_precomputed_guards(got, tmp_path, monkeypatch):
    """precomputed= refuses silently-ignored options and alpha mismatches."""
    import pytest

    from ppr_tpu.models.base_allpair import BaseAllPair
    from ppr_tpu.parallel.sharded import make_mesh
    from ppr_tpu.service import PPRService

    monkeypatch.chdir(tmp_path)
    BaseAllPair(got, 0.15, target_batch=128).preprocessing(
        1e-3, -1, progress=False)

    with pytest.raises(ValueError, match="hub_split"):
        PPRService.from_dataset(got, precomputed=(1e-3, -1), hub_split=16)
    with pytest.raises(ValueError, match="mesh"):
        PPRService.from_dataset(got, precomputed=(1e-3, -1),
                                mesh=make_mesh(8))
    # a store preprocessed under alpha=0.15 must not serve alpha=0.3
    with pytest.raises(ValueError, match="alpha"):
        PPRService.from_dataset(got, alpha=0.3, precomputed=(1e-3, -1))
    # matching alpha still works
    svc = PPRService.from_dataset(got, alpha=0.15, precomputed=(1e-3, -1))
    assert svc.top_k([3], k=10)


def test_service_hub_split_weighted_raises():
    """hub_split on a weighted graph raises loudly instead of silently
    serving the slow path."""
    import pytest

    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.graph.io import Dataset
    from ppr_tpu.service import PPRService

    rng = np.random.default_rng(0)
    n, m = 64, 256
    g = build_graph(rng.integers(0, n, m), rng.integers(0, n, m), n=n,
                    weights=rng.uniform(0.5, 2.0, m), dense_threshold=0)
    ds = Dataset(graph=g, names=[str(i) for i in range(n)], name="w")
    with pytest.raises(ValueError, match="hub_split"):
        PPRService.from_dataset(ds, hub_split=8)


def test_service_node_sharded_mesh_engine(got):
    """mesh_engine='node' serves through the O(n/S) ring engine and agrees
    with the single-device service."""
    from ppr_tpu.parallel.sharded import make_mesh
    from ppr_tpu.service import PPRService

    mesh = make_mesh(8)
    svc_node = PPRService.from_dataset(got, mesh=mesh, mesh_engine="node")
    svc_single = PPRService.from_dataset(got)
    for src in (3, 14):
        a = {h.node for h in svc_node.top_k([src])[0]}
        b = {h.node for h in svc_single.top_k([src])[0]}
        assert a == b
