"""bf16 ring payloads (graph-axis communication).

The node-sharded engines' per-sweep link traffic is the circulating
[B_local, n_local] residue chunk — the linear term of the comm model
(parallel/comm_model.py). ``ring_dtype="bf16"`` casts the chunk to
bfloat16 for each ppermute hop and widens back to f32 on arrival, halving
wire bytes; each transported value is rounded at most S-1 times at 2^-8
relative. These tests bound the error against the f32 ring on the virtual
8-device mesh and pin that the top-k id sets survive unchanged.
"""

import numpy as np
import pytest

ALPHA = 0.15


@pytest.fixture(scope="module")
def mesh8():
    from ppr_tpu.parallel.sharded import make_mesh

    return make_mesh(8, data=2, graph=4)


def test_bf16_ring_propagate_bounded_error(got, mesh8):
    from ppr_tpu.parallel.node_sharded import (
        make_node_sharded_propagate_ring,
    )

    g = got.graph
    sources = np.array([3, 11, 42, 64])
    out = {}
    for dt in ("f32", "bf16"):
        prepare, run = make_node_sharded_propagate_ring(
            mesh8, g, ALPHA, ring_dtype=dt
        )
        p, r, onehot = prepare(sources)
        p, r = run(p, r, onehot, 60)
        out[dt] = np.asarray(p)
    # rows are probability masses (sum ~1); the bf16 wire rounding must
    # stay within a few ULPs of bf16 per entry after 60 sweeps
    err = np.abs(out["bf16"] - out["f32"]).max()
    assert err < 5e-3
    # and mass conservation still holds for the bf16 ring
    np.testing.assert_allclose(out["bf16"].sum(-1), out["f32"].sum(-1),
                               atol=1e-2)


def test_bf16_ring_rejects_unknown_dtype(got, mesh8):
    from ppr_tpu.parallel.node_sharded import (
        make_node_sharded_propagate_ring,
    )

    with pytest.raises(ValueError, match="ring_dtype"):
        make_node_sharded_propagate_ring(mesh8, got.graph, ALPHA,
                                         ring_dtype="fp8")


def test_bf16_annealed_topk_ids_match_f32(got, mesh8):
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44])
    f32 = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8)
    b16 = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8,
                              ring_dtype="bf16")
    v32, i32 = f32.compute_topk_ids_batch(sources, 10, 0.5)
    v16, i16 = b16.compute_topk_ids_batch(sources, 10, 0.5)
    # id SETS are what serving returns (reference tie semantics); the bf16
    # rounding sits orders of magnitude below the (1+eps')*delta decision
    # thresholds, though near-ties may swap adjacent ranks. Only the
    # positive-support prefix is an answer (slots past the support are
    # index-ordered zero filler).
    for row in range(len(sources)):
        sup = min(10, int((v32[row] > 0).sum()), int((v16[row] > 0).sum()))
        assert sup >= 1
        assert set(i16[row][:sup].tolist()) == set(i32[row][:sup].tolist())
        np.testing.assert_allclose(np.sort(v16[row][:sup]),
                                   np.sort(v32[row][:sup]),
                                   rtol=5e-3, atol=5e-4)


def test_comm_model_prices_bf16(got):
    from ppr_tpu.parallel.comm_model import (
        predict_sweep,
        four_card_prediction,
        ring_bytes_per_sweep,
    )

    g = got.graph
    assert ring_bytes_per_sweep(g.n_pad, 64, 8, payload_bytes=2) * 2 == \
        ring_bytes_per_sweep(g.n_pad, 64, 8, payload_bytes=4)
    p32 = predict_sweep(g, engine="node_sharded", s_graph=8, batch=64)
    p16 = predict_sweep(g, engine="node_sharded", s_graph=8, batch=64,
                        payload_bytes=2)
    assert p16.comm_bytes * 2 == p32.comm_bytes
    assert p16.efficiency > p32.efficiency
    # the overlapped bound is at least the serial efficiency, capped at 1
    assert 1.0 >= p16.efficiency_overlap >= p16.efficiency
    out = four_card_prediction(g, batch=512)
    assert out["node_sharded_bf16_ring"]["efficiency"] > \
        out["node_sharded"]["efficiency"]
