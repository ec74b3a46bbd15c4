"""Regression tests for code-review findings."""

import numpy as np


def test_progress_marks_fire_on_crossing(capsys):
    from ppr_tpu.utils.report import progress_printer

    report = progress_printer(10_000)
    report(127)
    report(2047)    # crosses 10% and 20%
    out = capsys.readouterr().out
    assert "Progress: 10%" in out and "Progress: 20%" in out
    report(9_999)   # crosses everything else exactly once
    out = capsys.readouterr().out
    assert out.count("Progress: 100%") == 1
    assert "Progress: 90%" in out


def test_store_reattach_fresh_instance(got, tmp_path, monkeypatch):
    from ppr_tpu.models import AlgoConf

    monkeypatch.chdir(tmp_path)
    fp = AlgoConf(0.15).set_conf_fwdpush(got)
    fp.preprocessing(-1.0, 1e-5, progress=False)

    # a brand-new instance (fresh process scenario) reads the persisted store
    fp2 = AlgoConf(0.15).set_conf_fwdpush(got)
    fp2.read_preprocessed_ppr(17, param=1e-5)
    row = fp2.get_whole_graph_dense()
    direct = fp.compute_whole_graph_batch(np.asarray([17]), 1e-5)[0]
    np.testing.assert_allclose(row, direct, atol=1e-6)
    fp.delete_prep_dir()


def test_sharded_weighted_push_matches_single_device():
    import jax.numpy as jnp

    from ppr_tpu.graph.csr import build_graph
    from ppr_tpu.ops.push import forward_push_init, forward_push_sweeps
    from ppr_tpu.parallel.sharded import (
        make_mesh, make_sharded_push_sweeps, shard_graph,
    )

    rng = np.random.default_rng(23)
    n, m = 150, 1200
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.random(m) + 0.1
    g = build_graph(src, dst, n=n, weights=w, dense_threshold=0)
    mesh = make_mesh(4, data=2, graph=2)
    gs = shard_graph(g, mesh)

    sources = jnp.asarray([3, 11], jnp.int32)
    p0, r0, onehot = forward_push_init(g, sources)
    rmax = jnp.float32(1e-3)
    push = make_sharded_push_sweeps(mesh, 0.15, num_sweeps=6, weighted=True)
    p_sh, r_sh = push(
        gs.edge_src, gs.edge_dst, gs.edge_mask, gs.edge_coef,
        gs.out_deg, gs.node_mask, p0, r0, onehot, rmax,
    )

    # single-device reference: same number of masked sweeps
    p, r, _ = forward_push_sweeps(g, p0, r0, onehot, rmax, 0.15, max_sweeps=6)
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p), atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_sh), np.asarray(r), atol=1e-5)


def test_synthetic_weighted_no_dense_blowup():
    from ppr_tpu.graph.io import synthetic_weighted

    # would OOM before the fix (17 GB dense operator for the base graph)
    ds = synthetic_weighted(6000, 4, seed=2, dense_threshold=0)
    assert ds.graph.weighted
    assert ds.graph.dense_out is None


def test_native_long_line_handling(tmp_path):
    from ppr_tpu.native import get_lib, parse_edge_list_native

    if get_lib() is None:
        return
    p = tmp_path / "long.txt"
    long_comment = "# " + "x1 " * 5000  # >> 8 KiB of digit-bearing junk
    p.write_text(long_comment + "\n0 1\n1 2\n")
    parsed = parse_edge_list_native(str(p), 64)
    assert parsed is not None
    src, dst = parsed
    assert list(src) == [0, 1]
    assert list(dst) == [1, 2]


def test_final_state_shard_shape_rounds_up():
    """Round-3 review fix: the shard-shape helper mirrors _pad_batch's
    round-up to a multiple of the data axis."""
    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.parallel.sharded import make_mesh
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk

    ds = synthetic_powerlaw(512, 4, seed=3, dense_threshold=0)
    eng = NodeShardedForaTopk(ds, mesh=make_mesh(8, data=4, graph=2))
    n_local = ds.graph.n_pad // 2
    assert eng.final_state_shard_shape(10) == (3, n_local)   # 10 -> 12 rows
    assert eng.final_state_shard_shape(8) == (2, n_local)
    assert eng.final_state_shard_shape(1) == (2, n_local)    # min 8 rows


def test_prep_pending_and_batch_clamp(tmp_path, monkeypatch):
    """Round-3 review fixes: MC's walker-budget batch clamp routes through
    _prep_batch (warm/resume agree with the sweep), and _prep_pending is
    False only for an unfinalized store with every shard present."""
    import os

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf, AlgoType

    monkeypatch.chdir(tmp_path)
    ds = synthetic_powerlaw(256, 4, seed=2, dense_threshold=0)
    mc = AlgoConf(0.15).new_algo_obj(AlgoType.MC, ds, 10)
    mc.max_walk_batch = 4096          # force a tight clamp
    eps = 1.0
    bs = mc._prep_batch(eps, 128)
    assert bs == mc._source_chunk(eps) < 128
    assert mc._prep_pending(eps)                       # nothing on disk yet
    mc.preprocessing(-1.0, eps, progress=False)
    # finalized store: reference semantics re-preprocess -> still pending
    assert mc._prep_pending(eps)
    # unfinalized with all shards present: a resume does no device work
    store = mc.make_store(eps)
    os.remove(os.path.join(store.root, "manifest.json"))
    assert not mc._prep_pending(eps)
