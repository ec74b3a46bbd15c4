"""End-to-end accuracy tests: every algorithm vs the power-method oracle on
GOT at the reference operating point (alpha=0.15, eps=0.5, k=10 —
PPR.java:177-184), using the reference's own metrics (Gen_Util.java:259-326).
"""

import numpy as np
import pytest

from ppr_tpu.models import AlgoConf
from ppr_tpu.ops.topk import topk_ids_with_ties
from ppr_tpu.utils.metrics import max_abs_err, ndcg_at_k, precision_at_k

ALPHA = 0.15
K = 10


@pytest.fixture(scope="module")
def oracle(got):
    pm = AlgoConf(ALPHA).set_conf_power_method(got)
    sources = np.arange(0, got.n, 5)
    return sources, pm.compute_whole_graph_batch(sources)


def _mean_topk_metrics(scores, sources, oracle_rows, k=K):
    precs, ndcgs = [], []
    for row, s in enumerate(sources):
        gnd_ids = topk_ids_with_ties(oracle_rows[row], k)
        algo_ids = topk_ids_with_ties(scores[row], k)
        precs.append(precision_at_k(algo_ids, gnd_ids))
        ndcgs.append(ndcg_at_k(algo_ids, gnd_ids, oracle_rows[row]))
    return float(np.mean(precs)), float(np.mean(ndcgs))


def test_monte_carlo_accuracy(got, oracle):
    sources, oracle_rows = oracle
    mc = AlgoConf(ALPHA, seed=1).set_conf_mc(got)
    scores = mc.compute_whole_graph_batch(sources, 0.5)
    err = np.mean([
        max_abs_err(scores[i], oracle_rows[i]) for i in range(len(sources))
    ])
    assert err < 0.05
    prec, ndcg = _mean_topk_metrics(scores, sources, oracle_rows)
    assert prec > 0.85
    assert ndcg > 0.95


def test_forward_push_accuracy(got, oracle):
    sources, oracle_rows = oracle
    fp = AlgoConf(ALPHA).set_conf_fwdpush(got)
    scores = fp.compute_whole_graph_batch(sources, 1e-6)
    err = max(
        max_abs_err(scores[i], oracle_rows[i]) for i in range(len(sources))
    )
    assert err < 1e-3
    prec, _ = _mean_topk_metrics(scores, sources, oracle_rows)
    assert prec > 0.95


@pytest.mark.parametrize("completion", ["walks", "spmv", "auto"])
def test_fora_whole_graph_accuracy(got, oracle, completion):
    sources, oracle_rows = oracle
    fora = AlgoConf(ALPHA, seed=2).set_conf_fora_whole_graph(got)
    fora.completion = completion
    scores = fora.compute_whole_graph_batch(sources, 0.5)
    err = np.mean([
        max_abs_err(scores[i], oracle_rows[i]) for i in range(len(sources))
    ])
    assert err < 0.03
    prec, ndcg = _mean_topk_metrics(scores, sources, oracle_rows)
    assert prec > 0.9
    assert ndcg > 0.97


@pytest.mark.parametrize("completion", ["walks", "spmv"])
def test_fora_topk_recall(got, oracle, completion):
    sources, oracle_rows = oracle
    fora = AlgoConf(ALPHA, seed=3).set_conf_fora_topk(got, K)
    fora.completion = completion
    scores = fora.compute_topk_batch(sources, K, 0.5)
    prec, ndcg = _mean_topk_metrics(scores, sources, oracle_rows)
    # BASELINE.json north star: recall@10 parity with FORA on GOT
    assert prec > 0.9
    assert ndcg > 0.97


def test_neo4j_method_convergence(got, oracle):
    sources, oracle_rows = oracle
    nm = AlgoConf(ALPHA).set_conf_neo4j_method(got)
    few = nm.compute_whole_graph_batch(sources, 5)
    many = nm.compute_whole_graph_batch(sources, 200)
    # more iterations must improve top-k agreement with the oracle
    prec_few, _ = _mean_topk_metrics(few, sources, oracle_rows)
    prec_many, _ = _mean_topk_metrics(many, sources, oracle_rows)
    assert prec_many >= prec_few - 0.05
    assert prec_many > 0.6
    np.testing.assert_allclose(many.sum(axis=-1), 1.0, atol=1e-4)


def test_base_allpair_roundtrip(got, oracle, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sources, oracle_rows = oracle
    base = AlgoConf(ALPHA).set_conf_base_whole_graph(got)
    base.preprocessing(1e-4, -1, progress=False)
    assert base.get_prep_size() > 0

    scores = base.compute_whole_graph_batch(sources)
    # BASE stores only entries >= threshold of the mass-dies backward model;
    # still the big entries must agree with the oracle coarsely
    prec, _ = _mean_topk_metrics(scores, sources, oracle_rows)
    assert prec > 0.5

    # top-k preprocessing mode: stored order is descending
    base2 = AlgoConf(ALPHA).set_conf_base_whole_graph(got)
    base2.preprocessing(1e-4, K, progress=False)
    base2.compute_topk_ppr(int(sources[0]), K)
    ids = base2.get_topk_node_ids(K)
    vals = base2.get_whole_graph_dense()[ids]
    assert np.all(np.diff(vals) <= 1e-12)
    base2.delete_prep_dir()
    base.delete_prep_dir()


def test_preprocessing_roundtrip_forward_push(got, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fp = AlgoConf(ALPHA).set_conf_fwdpush(got)
    fp.preprocessing(-1.0, 1e-5, progress=False)
    direct = fp.compute_whole_graph_batch(np.asarray([17]), 1e-5)[0]
    fp.read_preprocessed_ppr(17)
    stored = fp.get_whole_graph_dense()
    np.testing.assert_allclose(stored, direct, atol=1e-6)
    assert fp.get_prep_size() > 0
    fp.delete_prep_dir()


def test_fora_topk_early_exit_set_exact():
    """The serving fast exit (set-stability certificate) returns exactly the
    fully-annealed run's top-k id set, in fewer or equal sweeps."""
    import jax.numpy as jnp

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf
    from ppr_tpu.models.fora import annealed_topk_propagate
    from ppr_tpu.ops.push import forward_push_init

    ds = synthetic_powerlaw(4096, 8, seed=17, dense_threshold=0)
    g = ds.graph
    k, eps_param = 10, 0.5
    rng = np.random.default_rng(5)
    sources = rng.integers(0, g.n, size=8).astype(np.int32)

    def run(early):
        conf = AlgoConf(0.15, seed=7)
        fora = conf.set_conf_fora_topk(ds, k)
        fora.push, fora.completion = "none", "spmv"
        fora.early_exit = early
        return fora.compute_topk_batch(sources, k, eps_param)

    full = run(False)
    fast = run(True)
    from ppr_tpu.ops.topk import topk_ids_with_ties

    for i in range(len(sources)):
        want = set(topk_ids_with_ties(full[i], k, tol=0.0)[:k].tolist())
        got = set(topk_ids_with_ties(fast[i], k, tol=0.0)[:k].tolist())
        assert got == want, f"row {i}"
        # fast values are lower bounds of the converged values
        assert np.all(fast[i] <= full[i] + 1e-6)

    # the certificate actually fires earlier (sweep counts drop)
    eps = jnp.float32(eps_param * 0.5)
    p, r, onehot = forward_push_init(g, jnp.asarray(sources))
    p = jnp.zeros_like(p)
    _, _, it_full = annealed_topk_propagate(
        g, p, r, onehot, eps, 1.0 / k, 1.0 / g.n, k, 0.15)
    _, _, it_fast = annealed_topk_propagate(
        g, p, r, onehot, eps, 1.0 / k, 1.0 / g.n, k, 0.15, early_exit=True)
    assert int(it_fast) <= int(it_full)


def test_prep_completion_prices_transfer():
    """In preprocessing mode the FORA auto completion prices the per-row
    device->host compaction transfer: exact spmv completion's ~dense rows
    lose to walk completion's sparse support at amazon-like scale (the
    measured 17 s vs 0.5 s per-batch regression this encodes)."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf, AlgoType

    ds = synthetic_powerlaw(65536, 2, seed=1, dense_threshold=0)
    fora = AlgoConf(0.15).new_algo_obj(AlgoType.FORA_WHOLE_GRAPH, ds, 10)
    # amazon-like operating point: loose eps -> tiny omega, n >> omega*rsum
    omega, rsum, target, batch = 7000.0, 0.85, 1.9e-3, 128
    # a device with a slow d2h link and batch-amortized sweep costs
    fora.d2h_bytes_per_s = 22e6
    fora.avg_rand_walk_time_ns = 2000.0
    fora.spmv_ns_per_edge = 12.0
    fora.spmv_batch_amortized = True
    assert fora._use_spmv(omega, rsum, target, batch)      # query mode: spmv
    fora._in_preprocessing = True
    assert not fora._use_spmv(omega, rsum, target, batch)  # prep mode: walks
