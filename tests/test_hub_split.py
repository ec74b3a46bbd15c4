import jax.numpy as jnp
import numpy as np
import pytest

from ppr_tpu.graph.csr import build_graph
from ppr_tpu.ops.hub_split import build_hub_split, push_out_hybrid
from ppr_tpu.ops.spmv import push_out


@pytest.fixture(scope="module")
def skewed():
    # heavily skewed in-degrees: most edges land on a few hubs
    rng = np.random.default_rng(8)
    n, m = 400, 5000
    src = rng.integers(0, n, m)
    w = 1.0 / (np.arange(n) + 1.0)
    dst = rng.choice(n, size=m, p=w / w.sum())
    return build_graph(src, dst, n=n, dense_threshold=0)


@pytest.mark.parametrize("num_hubs", [1, 16, 64, 400])
def test_hybrid_matches_reference_backend(skewed, num_hubs):
    g = skewed
    hs = build_hub_split(g, num_hubs)
    rng = np.random.default_rng(9)
    a = np.zeros((3, g.n_pad), np.float32)
    a[:, : g.n] = rng.random((3, g.n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo"))
    hyb = np.asarray(push_out_hybrid(g, hs, jnp.asarray(a)))
    np.testing.assert_allclose(hyb, ref, atol=1e-4)
    # 1D path
    hyb1 = np.asarray(push_out_hybrid(g, hs, jnp.asarray(a[0])))
    np.testing.assert_allclose(hyb1, ref[0], atol=1e-4)


@pytest.mark.parametrize("num_hubs", [16, 400])
def test_hybrid_transposed_matches(skewed, num_hubs):
    from ppr_tpu.ops.hub_split import push_out_hybrid_t

    g = skewed
    hs = build_hub_split(g, num_hubs)
    rng = np.random.default_rng(10)
    a = np.zeros((3, g.n_pad), np.float32)
    a[:, : g.n] = rng.random((3, g.n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo"))
    hyb_t = np.asarray(push_out_hybrid_t(g, hs, jnp.asarray(a.T)))
    np.testing.assert_allclose(hyb_t.T, ref, atol=1e-4)


def test_hybrid_bf16_hub_matrix(skewed):
    from ppr_tpu.ops.hub_split import push_out_hybrid_t

    g = skewed
    hs = build_hub_split(g, 64, dtype=jnp.bfloat16)
    assert hs.hub_matrix.dtype == jnp.bfloat16
    rng = np.random.default_rng(11)
    a = np.zeros((2, g.n_pad), np.float32)
    a[:, : g.n] = rng.random((2, g.n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo"))
    hyb = np.asarray(push_out_hybrid(g, hs, jnp.asarray(a)))
    hyb_t = np.asarray(push_out_hybrid_t(g, hs, jnp.asarray(a.T))).T
    # bf16 operand cast: ~2^-9 relative on the hub columns
    np.testing.assert_allclose(hyb, ref, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(hyb_t, ref, rtol=5e-3, atol=5e-3)
    assert hyb.dtype == np.float32


def test_push_out_t_matches(skewed):
    from ppr_tpu.ops.spmv import push_out_t

    g = skewed
    rng = np.random.default_rng(12)
    a = np.zeros((4, g.n_pad), np.float32)
    a[:, : g.n] = rng.random((4, g.n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo"))
    out_t = np.asarray(push_out_t(g, jnp.asarray(a.T)))
    np.testing.assert_allclose(out_t.T, ref, atol=1e-4)


def test_push_out_t_dense_backend(got):
    from ppr_tpu.ops.spmv import push_out_t

    g = got.graph
    assert g.has_dense
    rng = np.random.default_rng(14)
    a = np.zeros((3, g.n_pad), np.float32)
    a[:, : g.n] = rng.random((3, g.n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo"))
    out_t = np.asarray(push_out_t(g, jnp.asarray(a.T)))
    np.testing.assert_allclose(out_t.T, ref, atol=1e-4)


def test_push_out_t_weighted():
    from ppr_tpu.ops.spmv import push_out_t

    rng = np.random.default_rng(13)
    n, m = 120, 900
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.random(m) + 0.05
    g = build_graph(src, dst, n=n, weights=w, dense_threshold=0)
    a = np.zeros((2, g.n_pad), np.float32)
    a[:, :n] = rng.random((2, n))
    ref = np.asarray(push_out(g, jnp.asarray(a), backend="coo_sorted"))
    out_t = np.asarray(push_out_t(g, jnp.asarray(a.T)))
    np.testing.assert_allclose(out_t.T, ref, atol=1e-4)


def test_auto_num_hubs(skewed):
    from ppr_tpu.ops.hub_split import auto_num_hubs

    h32 = auto_num_hubs(skewed)
    h16 = auto_num_hubs(skewed, jnp.bfloat16)
    assert h32 >= 128 and h16 >= 128
    assert h16 >= h32  # cheaper columns admit more hubs
    assert h32 % 128 == 0
    # "auto" accepted end to end
    hs = build_hub_split(skewed, "auto", dtype=jnp.bfloat16)
    assert hs.num_hubs >= 128


def test_hub_split_edge_partition(skewed):
    g = skewed
    hs = build_hub_split(g, 32)
    # hub + tail edges account for every real edge exactly once
    hub_edges = float(
        np.asarray(hs.hub_matrix).sum()
        * 1.0  # matrix entries are 1/d multiplicities; recount explicitly
    )
    dst = np.asarray(g.edge_dst_bydst)[: g.m]
    is_hub = np.isin(dst, np.asarray(hs.hub_ids))
    assert hs.m_tail == int((~is_hub).sum())
    # the hubs really are the highest in-degree nodes
    in_deg = np.asarray(g.in_deg)[: g.n]
    assert in_deg[np.asarray(hs.hub_ids)].min() >= np.partition(
        in_deg, -32
    )[-32]


def test_fora_topk_with_hub_split_matches(got):
    from ppr_tpu.models import AlgoConf

    base = AlgoConf(0.15, seed=3).set_conf_fora_topk(got, 10)
    base.completion = "spmv"
    ref = base.compute_topk_batch(np.arange(0, got.n, 7), 10, 0.5)

    hub = AlgoConf(0.15, seed=3).set_conf_fora_topk(got, 10)
    hub.completion = "spmv"
    hub.enable_hub_split(16)
    out = hub.compute_topk_batch(np.arange(0, got.n, 7), 10, 0.5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_hybrid_chunked_tail_matches_unchunked(got):
    """num_chunks>1 bounds the tail gather intermediate (the out-of-memory
    guard for wide batches at n=1M); slicing the dst-sorted tail preserves
    the sorted segment-sum result exactly."""
    import jax.numpy as jnp
    import numpy as np

    from ppr_tpu.ops.hub_split import build_hub_split, push_out_hybrid_t

    g = got.graph
    hs = build_hub_split(g, 16)
    rng = np.random.default_rng(0)
    a_t = jnp.asarray(rng.random((g.n_pad, 4)), jnp.float32)
    base = np.asarray(push_out_hybrid_t(g, hs, a_t))
    for nc in (2, 3, 8):
        out = np.asarray(push_out_hybrid_t(g, hs, a_t, num_chunks=nc))
        np.testing.assert_allclose(out, base, rtol=1e-6, atol=1e-7)
