"""Communication model: bytes formulas, prediction structure, pricing from
the device table, and the measured collective-vs-compute breakdown on the
virtual mesh."""

import numpy as np

from ppr_tpu.parallel.comm_model import (
    four_card_prediction,
    measure_breakdown,
    predict_sweep,
    psum_bytes_per_sweep,
    ring_bytes_per_sweep,
)
from ppr_tpu.parallel.sharded import make_mesh


def test_bytes_formulas():
    # 1 shard: no traffic
    assert psum_bytes_per_sweep(1024, 8, 1) == 0
    assert ring_bytes_per_sweep(1024, 8, 1) == 0
    # ring all-reduce: 2(S-1)/S of the full state out of each device
    assert psum_bytes_per_sweep(1024, 8, 2) == 1024 * 8 * 4
    # traffic scales linearly with the batch width
    assert psum_bytes_per_sweep(1024, 16, 4) == 2 * psum_bytes_per_sweep(
        1024, 8, 4
    )
    # node-sharded ring moves (S-1)*n/S*B -> approaches HALF the psum bytes
    p8, r8 = psum_bytes_per_sweep(4096, 8, 8), ring_bytes_per_sweep(4096, 8, 8)
    assert r8 < p8 and abs(r8 / p8 - 0.5) < 0.1


def test_predict_sweep_efficiency_monotone():
    from ppr_tpu.graph.io import synthetic_powerlaw

    g = synthetic_powerlaw(8192, 8, seed=1, dense_threshold=0).graph
    effs = [predict_sweep(g, s_graph=s, batch=512).efficiency
            for s in (1, 2, 4, 8)]
    assert effs[0] == 1.0
    # fixed work + growing collectives -> strong-scaling efficiency decays
    assert all(a >= b for a, b in zip(effs, effs[1:]))


def test_two_host_prediction_fields():
    """The multi-device prediction (four NVLink cards of one host, priced
    from the device table) keeps its structure."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.utils.devices import TABLE

    g = synthetic_powerlaw(8192, 8, seed=1, dense_threshold=0).graph
    h100 = TABLE["NVIDIA H100 80GB HBM3"]
    out = four_card_prediction(g, batch=512, rates=h100)
    assert out["data_parallel"]["efficiency"] == 1.0
    assert out["graph_parallel_1card"]["efficiency"] == 1.0
    assert 0 < out["graph_parallel"]["efficiency"] <= 1.0
    assert out["assumptions"]["link_bytes_per_s"] == h100.link_bytes_per_s


def test_predict_sweep_prices_per_row_rates():
    """A device whose sweep cost is per row pays it for every local row;
    the comm time comes from the table's link rate."""
    import dataclasses

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.utils.devices import TABLE

    g = synthetic_powerlaw(4096, 8, seed=1, dense_threshold=0).graph
    per_sweep = TABLE["NVIDIA H100 80GB HBM3"]
    per_row = dataclasses.replace(per_sweep, spmv_batch_amortized=False)
    a = predict_sweep(g, s_graph=4, batch=64, rates=per_sweep)
    b = predict_sweep(g, s_graph=4, batch=64, rates=per_row)
    assert np.isclose(b.t_compute_s, 64 * a.t_compute_s)
    assert np.isclose(a.t_comm_s, a.comm_bytes / per_sweep.link_bytes_per_s)


def test_measure_breakdown_virtual_mesh():
    from ppr_tpu.graph.io import synthetic_powerlaw

    g = synthetic_powerlaw(4096, 6, seed=2, dense_threshold=0).graph
    mesh = make_mesh(8)
    out = measure_breakdown(mesh, g, batch=16, num_sweeps=8, iters=3)
    assert out["t_sweep_full_s"] > 0 and out["t_sweep_local_only_s"] > 0
    assert 0.0 <= out["collective_fraction"] < 1.0
    assert out["platform"] == "cpu"
    assert out["model_psum_bytes"] == psum_bytes_per_sweep(
        g.n_pad, 16 // 4, 2
    )
