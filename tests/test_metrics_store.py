import numpy as np

from ppr_tpu.ops.topk import kth_ppr, topk_ids_with_ties
from ppr_tpu.utils.metrics import max_abs_err, ndcg_at_k, precision_at_k
from ppr_tpu.utils.store import PPRStore


def test_topk_ties_expand():
    v = np.array([0.5, 0.3, 0.3, 0.3, 0.1, 0.0])
    ids = topk_ids_with_ties(v, 2)
    # kth (2nd) largest = 0.3 -> all three 0.3s included
    assert set(ids) == {0, 1, 2, 3}
    assert ids[0] == 0  # sorted descending


def test_topk_small_support_returns_all():
    v = np.array([0.0, 0.2, 0.0, 0.1])
    ids = topk_ids_with_ties(v, 10)
    assert list(ids) == [1, 3]


def test_kth_ppr_null_semantics():
    # Algo_Util.java:39-53: k out of range -> null
    assert kth_ppr(np.array([0.1, 0.2]), 3) is None
    assert kth_ppr(np.array([0.1, 0.2]), 0) is None
    assert kth_ppr(np.array([0.3, 0.1, 0.2]), 2) == 0.2


def test_precision_denominator_is_gnd_size():
    # Gen_Util.java:278: denominator = |gnd set| (4 here), not k
    algo = np.array([1, 2, 3])
    gnd = np.array([1, 2, 9, 8])
    assert precision_at_k(algo, gnd) == 2 / 4


def test_ndcg_perfect_is_one():
    vals = np.zeros(10)
    vals[[3, 5, 7]] = [0.5, 0.3, 0.2]
    gnd = np.array([3, 5, 7])
    assert abs(ndcg_at_k(gnd, gnd, vals) - 1.0) < 1e-12
    worse = ndcg_at_k(np.array([7, 5, 3]), gnd, vals)
    assert worse < 1.0


def test_ndcg_missing_nodes_zero_gain():
    vals = np.zeros(10)
    vals[[1, 2]] = [0.6, 0.4]
    gnd = np.array([1, 2])
    none_right = ndcg_at_k(np.array([8, 9]), gnd, vals)
    assert none_right == 0.0


def test_max_err_only_over_gnd_support():
    gnd = np.array([0.5, 0.0, 0.2])
    algo = np.array([0.4, 0.9, 0.2])  # big error at idx 1 is outside support
    assert abs(max_abs_err(algo, gnd) - 0.1) < 1e-12


def test_store_roundtrip_and_resume(tmp_path):
    store = PPRStore(str(tmp_path / "s"), n=16)
    store.reset()
    rows = np.zeros((3, 16), np.float32)
    rows[0, [2, 5]] = [0.5, 0.25]
    rows[2, 7] = 1.0
    store.write_batch(0, np.array([0, 1, 2]), rows)
    assert store.has_batch(0)
    # resume: a second reset before finalize keeps the shard
    store2 = PPRStore(str(tmp_path / "s"), n=16)
    store2.reset()
    assert store2.has_batch(0)
    store2.finalize()
    got = store2.read_row(0)
    np.testing.assert_allclose(got, rows[0])
    np.testing.assert_allclose(store2.read_row(1), 0.0)
    assert store2.size_bytes() > 0
    # reset after finalize clears
    store3 = PPRStore(str(tmp_path / "s"), n=16)
    store3.reset()
    assert not store3.has_batch(0)
    store3.delete()


def test_store_ordered_rows(tmp_path):
    store = PPRStore(str(tmp_path / "o"), n=8)
    store.reset()
    ids = [np.array([5, 1, 3]), np.array([], np.int32)]
    vals = [np.array([0.5, 0.3, 0.2]), np.array([], np.float32)]
    store.write_batch_ordered(0, np.array([0, 1]), ids, vals)
    store.finalize()
    rid, rval = store.read_row_ordered(0)
    assert list(rid) == [5, 1, 3]  # insertion order preserved
    np.testing.assert_allclose(rval, vals[0])


def test_store_manifest_ranges_skip_shard_scan(tmp_path):
    """A finalized manifest carries source->shard ranges; attaching a store
    resolves reads via bisect with ZERO up-front shard loads."""
    from ppr_tpu.utils.store import PPRStore

    n = 32
    store = PPRStore(str(tmp_path / "s"), n=n)
    store.reset()
    for start in (0, 8, 16, 24):
        sources = np.arange(start, start + 8)
        rows = np.zeros((8, n), np.float32)
        rows[np.arange(8), sources] = 1.0
        store.write_batch(start, sources, rows)
    store.finalize(alpha=0.15)

    fresh = PPRStore(str(tmp_path / "s"), n=n)
    # the legacy full scan must never run when ranges are present
    fresh._build_index = None
    row = fresh.read_row(19)
    assert row[19] == 1.0 and row.sum() == 1.0
    assert fresh._ranges and len(fresh._ranges) == 4
