"""Frontier-compacted ring exchange (graph-axis communication).

The node-sharded sweep's link traffic is the circulating [B_l, n_local]
residue chunk. ``frontier_blocks=C`` compacts each hop's payload to the C
column blocks carrying the most residue mass (``[B_l, C*blk]`` values +
``[C]`` ids); unselected residue defers in place — exact, since push
order is free in forward-push semantics (Forward_Push.java:60-88) and the
stopping rule reads the full residue sum. These tests pin: full capacity
== dense ring arithmetic, low capacity converges to the same answer, and
the comm model prices the compaction.
"""

import numpy as np
import pytest

ALPHA = 0.15


@pytest.fixture(scope="module")
def mesh8():
    from ppr_tpu.parallel.sharded import make_mesh

    return make_mesh(8, data=2, graph=4)


def test_frontier_full_capacity_equals_dense(got, mesh8):
    """With C = num_blocks every block is selected every sweep: the masked
    push multiplies by 1.0 and the compaction is a permutation-free
    reshape, so the arithmetic is identical to the dense ring."""
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44])
    dense = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8)
    full = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8,
                               frontier_blocks=16, num_blocks=16)
    p_d = dense.compute_topk_batch(sources, 10, 0.5)
    p_f = full.compute_topk_batch(sources, 10, 0.5)
    np.testing.assert_array_equal(p_f, p_d)


def test_frontier_low_capacity_same_answer(got, mesh8):
    """C << NB defers most blocks per sweep yet must converge to the same
    top-k answer — deferral changes push ORDER only; the annealing /
    stopping thresholds see the full residue (deferred included), so the
    terminating state satisfies the same FORA bound."""
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44])
    dense = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8)
    sparse = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8,
                                 frontier_blocks=4, num_blocks=32)
    v_d, i_d = dense.compute_topk_ids_batch(sources, 10, 0.5)
    v_s, i_s = sparse.compute_topk_ids_batch(sources, 10, 0.5)
    for row in range(len(sources)):
        sup = min(10, int((v_d[row] > 0).sum()), int((v_s[row] > 0).sum()))
        assert sup >= 1
        assert set(i_s[row][:sup].tolist()) == set(i_d[row][:sup].tolist())
        np.testing.assert_allclose(np.sort(v_s[row][:sup]),
                                   np.sort(v_d[row][:sup]),
                                   rtol=5e-2, atol=5e-3)


def test_frontier_composes_with_bf16_ring(got, mesh8):
    """Compaction and bf16 wire casts stack (bytes: C/NB * 1/2)."""
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

    sources = np.array([3, 14, 50, 7])
    dense = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8)
    combo = NodeShardedForaTopk(got, ALPHA, 10, mesh=mesh8,
                                ring_dtype="bf16", frontier_blocks=8,
                                num_blocks=32)
    v_d, i_d = dense.compute_topk_ids_batch(sources, 10, 0.5)
    v_c, i_c = combo.compute_topk_ids_batch(sources, 10, 0.5)
    for row in range(len(sources)):
        sup = min(10, int((v_d[row] > 0).sum()), int((v_c[row] > 0).sum()))
        assert sup >= 1
        assert set(i_c[row][:sup].tolist()) == set(i_d[row][:sup].tolist())


def test_comm_model_prices_frontier():
    from ppr_tpu.parallel.comm_model import (
        frontier_ring_bytes_per_sweep,
        ring_bytes_per_sweep,
    )

    # C/NB of the dense payload, plus the [C] i32 id vector per hop
    dense = ring_bytes_per_sweep(4096, 64, 8)
    quarter = frontier_ring_bytes_per_sweep(4096, 64, 8,
                                            capacity_frac=0.25)
    assert quarter < dense * 0.26 + 8 * 64 * 4
    assert frontier_ring_bytes_per_sweep(4096, 64, 8, capacity_frac=1.0) \
        >= dense
    # bf16 composes
    assert frontier_ring_bytes_per_sweep(
        4096, 64, 8, capacity_frac=0.25, payload_bytes=2
    ) < quarter
