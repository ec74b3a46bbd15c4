"""Run the PPR engine's main paths once on a GPU and check every answer.

    python chip_smoke.py               # phases A-E, one GPU
    python chip_smoke.py --four-cards  # only the mesh engines, four GPUs

Phases (graphs are seeded ``synthetic_powerlaw`` graphs, nothing is read
from disk):

A. headline serving: ``PPRService`` (bf16 hub split at the auto count) on
   the bench graph (n=65,536, m~1.04M): ``top_k`` at B=2048, single-source
   requests through ``PPRBatchServer``, ``whole_graph`` on 8 sources;
B. FORA top-k at n~1M (m~8.4M), B=256, bf16 hub split at the auto count;
C. the small dense-operator paths (``PowerMethod``, ``Neo4jMethod``) at
   n_pad=128 and 1024 against float64 numpy, plus the dense loop's time;
D. the protocol algorithms (MC, Forward Push, FORA whole-graph and top-k,
   Neo4j-method, BASE with an all-pair preprocessing) on the grqc stand-in;
E. the daemon's own JSON-lines loop (``serving.serve_loop``) in process.

Each phase prints one JSON line with its graph, batch, cold and warm times,
device memory and accuracy numbers beside their bounds; a failed check
raises. The last line is ``{"ok": true, "device": {...}}``. The script
refuses to run unless JAX's first device is a GPU. One process uses the
card(s).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ALPHA, EPS, K = 0.15, 0.5, 10

#: the sizes every phase runs at
SIZES = dict(
    headline=(65536, 16), batch=2048, acc=32, served=256, wg=8,
    big=(1048576, 8), big_batch=256, big_acc=8,
    dense=((107, 3), (1000, 3)), loop_batches=(8, 2048),
    protocol=(5120, 3, 103), protocol_sources=16, daemon=8,
    four_big=(1048576, 8), four_batch=256, four_big_batch=64,
)

#: full-capacity frontier ring vs dense ring on the card: summation order
#: only (measured 1.49e-8 on four H100s, scores up to ~0.3)
FRONTIER_ATOL = 1e-7

#: data-sheet peaks of one H100 SXM (dense): f32 outside the tensor cores,
#: and memory bandwidth — the dense loop's roofline reference
F32_FLOPS = 67e12
MEM_BYTES_PER_S = 3.35e12


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()


def result_line(devices) -> dict:
    """The run's last line: the devices as JAX reports them."""
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


def require_gpu(devices) -> None:
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX's first device is "
            f"{devices[0].platform} ({devices[0].device_kind})"
        )


def emit(obj) -> None:
    print(json.dumps(obj, default=float), flush=True)


def check(name: str, value: float, bound: float, op: str) -> dict:
    """Record ``value`` beside its bound and fail the run if it misses."""
    ok = {"<": value < bound, "<=": value <= bound, ">": value > bound,
          ">=": value >= bound}[op]
    if not ok:
        raise AssertionError(f"{name} = {value!r}, bound {op} {bound!r}")
    return {"value": value, "bound": f"{op} {bound}"}


def timed(fn):
    """(result, seconds) of ``fn()``; results are host arrays or lists."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def device_memory() -> dict:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return {k: stats[k] for k in ("peak_bytes_in_use", "bytes_limit")
            if k in stats}


def memory_analysis(jitted, *args, **kwargs):
    """``compiled.memory_analysis()`` of one jitted program at these args."""
    m = jitted.lower(*args, **kwargs).compile().memory_analysis()
    if m is None:
        return None
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


# ------------------------------------------------------------------ accuracy
def topk_precision(vals, ids, oracle, k=K, tol=0.0):
    """Mean precision@k of device-selected (vals, ids) rows against oracle
    rows, with the reference's tie semantics; ``tol`` widens the
    algorithm's tie set (bench.py's tie tolerance)."""
    import numpy as np

    from ppr_tpu.ops.topk import (
        topk_ids_with_ties,
        topk_ids_with_ties_from_pairs,
    )
    from ppr_tpu.utils.metrics import precision_at_k

    precs = [
        precision_at_k(
            topk_ids_with_ties_from_pairs(vals[i], ids[i], k, tol=tol),
            topk_ids_with_ties(oracle[i], k))
        for i in range(len(oracle))
    ]
    return float(np.mean(precs))


def dense_metrics(scores, oracle, k=K):
    """(mean max-abs error, mean precision@k, mean NDCG@k) of dense rows."""
    import numpy as np

    from ppr_tpu.ops.topk import topk_ids_with_ties
    from ppr_tpu.utils.metrics import max_abs_err, ndcg_at_k, precision_at_k

    errs, precs, ndcgs = [], [], []
    for row, gnd_row in zip(scores, oracle):
        gnd = topk_ids_with_ties(gnd_row, k)
        got = topk_ids_with_ties(row, k)
        errs.append(max_abs_err(row, gnd_row))
        precs.append(precision_at_k(got, gnd))
        ndcgs.append(ndcg_at_k(got, gnd, gnd_row))
    return float(np.mean(errs)), float(np.mean(precs)), float(np.mean(ndcgs))


def hits_precision(hit_rows, oracle, k=K):
    import numpy as np

    from ppr_tpu.ops.topk import topk_ids_with_ties
    from ppr_tpu.utils.metrics import precision_at_k

    return float(np.mean([
        precision_at_k(np.asarray([h[0] for h in hits]),
                       topk_ids_with_ties(gnd_row, k))
        for hits, gnd_row in zip(hit_rows, oracle)
    ]))


# ------------------------------------------------------------------- phases
def phase_a(cfg, rng):
    import jax.numpy as jnp
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models.fora import annealed_topk_propagate
    from ppr_tpu.models.power_method import power_method_batch
    from ppr_tpu.ops.push import forward_push_init
    from ppr_tpu.service import PPRService
    from ppr_tpu.serving import PPRBatchServer

    n, deg = cfg["headline"]
    ds = synthetic_powerlaw(n, deg, seed=42, dense_threshold=0)
    g = ds.graph
    svc, t_build = timed(lambda: PPRService.from_dataset(
        ds, alpha=ALPHA, eps=EPS, k=K, hub_split="auto"))
    algo = svc._topk_algo
    hs = algo.hub_split
    sources = rng.integers(0, g.n, size=cfg["batch"])

    _, cold = timed(lambda: svc.top_k(sources))
    _, warm = timed(lambda: svc.top_k(sources))
    acc = sources[: cfg["acc"]]
    oracle = np.asarray(power_method_batch(g, acc, ALPHA, 100))[:, : g.n]
    vals, ids = algo.compute_topk_ids_batch(sources, K, EPS)
    tie_tol = EPS / g.n
    recall = topk_precision(vals[: len(acc)], ids[: len(acc)], oracle,
                            tol=tie_tol)
    recall_raw = topk_precision(vals[: len(acc)], ids[: len(acc)], oracle)

    # the main jitted program: the fused annealed loop at B, hub split on
    src_j = jnp.asarray(sources, jnp.int32)
    _, r0, onehot = forward_push_init(g, src_j)
    mem = memory_analysis(
        annealed_topk_propagate, g, jnp.zeros_like(r0), r0, onehot,
        jnp.float32(EPS * 0.5), algo.delta0, algo.min_delta, K, ALPHA,
        hs=hs, num_chunks=algo._num_chunks(len(sources)))

    # single-source requests through the batch server
    served = sources[: cfg["served"]]
    with PPRBatchServer(svc, max_batch=cfg["batch"]) as server:
        futs, t_served = timed(lambda: [
            f.result() for f in [server.submit(int(s)) for s in served]])
        dispatches = server.stats.dispatches
    if not all(futs):
        raise AssertionError("a served request returned no hits")
    served_prec = hits_precision(
        [[(h.node, h.score) for h in row] for row in futs[: len(acc)]],
        oracle)

    wg_src = acc[: cfg["wg"]]
    dense, t_wg = timed(lambda: svc.whole_graph(wg_src))
    wg_err, _, _ = dense_metrics(dense, oracle[: len(wg_src)])
    row_sum_dev = float(np.abs(dense.sum(axis=1) - 1.0).max())

    emit({
        "phase": "A_headline_serving", "graph": {"n": g.n, "m": g.m},
        "batch": len(sources), "hubs": hs.num_hubs,
        "hub_edge_share": 1.0 - hs.m_tail / g.m,
        "build_s": t_build, "cold_s": cold, "warm_s": warm,
        "warm_qps": len(sources) / warm,
        "recall_at_10_tie_tol": check("recall@10", recall, 1.0, ">="),
        "recall_at_10_raw": recall_raw, "tie_tol": tie_tol,
        "served": {"requests": len(served), "dispatches": dispatches,
                   "seconds": t_served,
                   "precision_at_10_raw": check(
                       "served precision@10", served_prec, 0.9, ">")},
        "whole_graph": {
            "sources": len(wg_src), "seconds": t_wg,
            "mean_max_abs_err": check("whole-graph err", wg_err, 0.03, "<"),
            "max_row_sum_dev": check("row sum", row_sum_dev, 1e-3, "<")},
        "memory_analysis": mem, "device_memory": device_memory(),
    })
    return svc, acc, oracle


def phase_b(cfg, rng):
    import jax.numpy as jnp
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models.fora import ForaTopk, annealed_topk_propagate
    from ppr_tpu.models.power_method import power_method_batch
    from ppr_tpu.ops.push import forward_push_init

    n, deg = cfg["big"]
    ds, t_graph = timed(lambda: synthetic_powerlaw(n, deg, seed=0))
    g = ds.graph
    # push="none": the annealed loop alone, as scripts/scale_1m_knee.py
    fora = ForaTopk(ds, ALPHA, K, push="none")
    _, t_hubs = timed(lambda: fora.enable_hub_split(
        "auto", dtype=jnp.bfloat16))
    hs = fora.hub_split
    sources = rng.integers(0, g.n, size=cfg["big_batch"])
    _, cold = timed(lambda: fora.compute_topk_ids_batch(sources, K, EPS))
    (vals, ids), warm = timed(
        lambda: fora.compute_topk_ids_batch(sources, K, EPS))
    acc = sources[: cfg["big_acc"]]
    oracle = np.asarray(power_method_batch(g, acc, ALPHA, 100))[:, : g.n]
    tie_tol = EPS / g.n
    recall = topk_precision(vals[: len(acc)], ids[: len(acc)], oracle,
                            tol=tie_tol)
    recall_raw = topk_precision(vals[: len(acc)], ids[: len(acc)], oracle)
    src_j = jnp.asarray(sources, jnp.int32)
    _, r0, onehot = forward_push_init(g, src_j)
    mem = memory_analysis(
        annealed_topk_propagate, g, jnp.zeros_like(r0), r0, onehot,
        jnp.float32(EPS * 0.5), fora.delta0, fora.min_delta, K, ALPHA,
        hs=hs, num_chunks=fora._num_chunks(len(sources)))
    emit({
        "phase": "B_1m_topk", "graph": {"n": g.n, "m": g.m},
        "batch": len(sources), "hubs": hs.num_hubs,
        "hub_edge_share": 1.0 - hs.m_tail / g.m,
        "graph_build_s": t_graph, "hub_build_s": t_hubs,
        "cold_s": cold, "warm_s": warm, "warm_qps": len(sources) / warm,
        "recall_at_10_tie_tol": check("1M recall@10", recall, 1.0, ">="),
        "recall_at_10_raw": recall_raw, "tie_tol": tie_tol,
        "memory_analysis": mem, "device_memory": device_memory(),
    })


def dense_reference(g, sources, alpha, iterations, *, neo4j: bool):
    """float64 numpy: the power method (dangling mass back to the source,
    Power_Method.java:55-100) or the Neo4j-library iteration
    ``x = (1-d) e_s + d x W`` with sum normalization (neo4j_method.py)."""
    import numpy as np

    n = g.n
    src = np.asarray(g.edge_src)[: g.m]
    dst = np.asarray(g.edge_dst)[: g.m]
    deg = np.bincount(src, minlength=n).astype(np.float64)
    w = np.zeros((n, n))
    np.add.at(w, (src, dst), 1.0 / deg[src])
    rows = np.arange(len(sources))
    e = np.zeros((len(sources), n))
    e[rows, sources] = 1.0
    if neo4j:
        d = 1.0 - alpha
        x = (1.0 - d) * e
        for _ in range(iterations):
            x = (1.0 - d) * e + d * (x @ w)
        return x / x.sum(axis=1, keepdims=True)
    dangling = deg == 0
    p, r = np.zeros_like(e), e
    for _ in range(iterations):
        p = p + alpha * r
        rem = (1.0 - alpha) * r
        dang = rem[:, dangling].sum(axis=1)
        r = rem @ w
        r[rows, sources] += dang
    return p


def phase_c(cfg, rng):
    import jax
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf
    from ppr_tpu.models.power_method import power_method_batch

    out = {"phase": "C_dense_operator", "graphs": []}
    for n, deg in cfg["dense"]:
        ds = synthetic_powerlaw(n, deg, seed=7)
        g = ds.graph
        if not g.has_dense:
            raise AssertionError(f"n={n}: expected a dense operator")
        sources = rng.integers(0, g.n, size=8)
        conf = AlgoConf(ALPHA)
        pm, t_pm = timed(lambda: conf.set_conf_power_method(ds)
                         .compute_whole_graph_batch(sources))
        nm, t_nm = timed(lambda: conf.set_conf_neo4j_method(ds)
                         .compute_whole_graph_batch(sources, 20))
        pm_err = float(np.abs(pm[:, : g.n] - dense_reference(
            g, sources, ALPHA, 100, neo4j=False)).max())
        nm_err = float(np.abs(nm[:, : g.n] - dense_reference(
            g, sources, ALPHA, 20, neo4j=True)).max())
        loops = []
        for b in cfg["loop_batches"]:
            src_b = rng.integers(0, g.n, size=b)
            run = lambda: jax.block_until_ready(  # noqa: E731
                power_method_batch(g, src_b, ALPHA, 100))
            _, cold = timed(run)
            warm = min(timed(run)[1] for _ in range(5))
            n_pad = g.n_pad
            flops = 2.0 * n_pad * n_pad * b
            bytes_ = 4.0 * (n_pad * n_pad + 2 * n_pad * b)
            loops.append({
                "batch": b, "iterations": 100, "cold_s": cold,
                "warm_s": warm, "per_iteration_us": warm / 100 * 1e6,
                "matmul_roofline_us": max(flops / F32_FLOPS,
                                          bytes_ / MEM_BYTES_PER_S) * 1e6,
            })
        out["graphs"].append({
            "n": g.n, "m": g.m, "n_pad": g.n_pad, "batch": len(sources),
            "power_method_s": t_pm, "neo4j_method_s": t_nm,
            "power_method_max_abs_err_vs_f64": check(
                "power method vs f64", pm_err, 2e-5, "<="),
            "neo4j_method_max_abs_err_vs_f64": check(
                "neo4j method vs f64", nm_err, 2e-5, "<="),
            "dense_loop": loops,
        })
    out["device_memory"] = device_memory()
    emit(out)


def phase_d(cfg):
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf

    n, deg, seed = cfg["protocol"]
    ds = synthetic_powerlaw(n, deg, seed=seed, dense_threshold=0,
                            name="grqc")
    g = ds.graph
    sources = np.linspace(0, g.n - 1, cfg["protocol_sources"]).astype(
        np.int64)
    conf = AlgoConf(ALPHA, seed=1)
    oracle, t_oracle = timed(lambda: conf.set_conf_power_method(ds)
                             .compute_whole_graph_batch(sources))
    oracle = oracle[:, : g.n]
    res = {}

    def run(name, fn):
        scores, secs = timed(fn)
        res[name] = {"seconds": secs}
        return np.asarray(scores)[:, : g.n]

    # bounds: tests/test_algorithms.py at the reference operating point
    err, prec, ndcg = dense_metrics(
        run("monte_carlo", lambda: conf.set_conf_mc(ds)
            .compute_whole_graph_batch(sources, EPS)), oracle)
    res["monte_carlo"].update(
        mean_max_abs_err=check("MC err", err, 0.05, "<"),
        precision=check("MC precision", prec, 0.85, ">"),
        ndcg=check("MC ndcg", ndcg, 0.95, ">"))
    scores = run("forward_push", lambda: conf.set_conf_fwdpush(ds)
                 .compute_whole_graph_batch(sources, 1e-6))
    worst = max(float(np.abs(s - o).max()) for s, o in zip(scores, oracle))
    _, prec, _ = dense_metrics(scores, oracle)
    res["forward_push"].update(
        max_abs_err=check("FP err", worst, 1e-3, "<"),
        precision=check("FP precision", prec, 0.95, ">"))
    err, prec, ndcg = dense_metrics(
        run("fora_whole_graph", lambda: conf.set_conf_fora_whole_graph(ds)
            .compute_whole_graph_batch(sources, EPS)), oracle)
    res["fora_whole_graph"].update(
        mean_max_abs_err=check("FORA wg err", err, 0.03, "<"),
        precision=check("FORA wg precision", prec, 0.9, ">"),
        ndcg=check("FORA wg ndcg", ndcg, 0.97, ">"))
    _, prec, ndcg = dense_metrics(
        run("fora_topk", lambda: conf.set_conf_fora_topk(ds, K)
            .compute_topk_batch(sources, K, EPS)), oracle)
    res["fora_topk"].update(
        precision=check("FORA topk precision", prec, 0.9, ">"),
        ndcg=check("FORA topk ndcg", ndcg, 0.97, ">"))
    scores = run("neo4j_method", lambda: conf.set_conf_neo4j_method(ds)
                 .compute_whole_graph_batch(sources, 200))
    _, prec, _ = dense_metrics(scores, oracle)
    res["neo4j_method"].update(
        precision=check("Neo4j precision", prec, 0.6, ">"),
        max_row_sum_dev=check(
            "Neo4j row sum",
            float(np.abs(scores.sum(axis=1) - 1.0).max()), 1e-4, "<"))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        os.chdir(td)              # prep stores are cwd-relative
        try:
            base = conf.set_conf_base_whole_graph(ds)
            _, t_prep = timed(lambda: base.preprocessing(
                1e-4, -1, progress=False))
            scores = run("base", lambda: base.compute_whole_graph_batch(
                sources))
            _, prec, _ = dense_metrics(scores, oracle)
            res["base"].update(
                prep_s=t_prep, prep_bytes=base.get_prep_size(),
                precision=check("BASE precision", prec, 0.5, ">"))
            base.delete_prep_dir()
        finally:
            os.chdir(cwd)
    emit({"phase": "D_protocol", "graph": {"n": g.n, "m": g.m},
          "batch": len(sources), "oracle_s": t_oracle, "algorithms": res,
          "device_memory": device_memory()})


def phase_e(cfg, svc, acc, oracle):
    from ppr_tpu.serving import serve_loop

    n_req = cfg["daemon"]
    lines = [json.dumps({"source": int(s), "id": f"q{i}"})
             for i, s in enumerate(acc[:n_req])]
    lines.append(json.dumps({"cmd": "stats", "id": "stats"}))
    out = io.StringIO()
    stats, secs = timed(lambda: serve_loop(
        svc, io.StringIO("\n".join(lines) + "\n"), out, max_batch=2048))
    replies = {r["id"]: r for r in map(json.loads,
                                       out.getvalue().splitlines())}
    errors = [r for r in replies.values() if "error" in r]
    if errors or len(replies) != n_req + 1:
        raise AssertionError(f"daemon replies: {len(replies)} for "
                             f"{n_req + 1} lines, errors {errors[:2]}")
    prec = hits_precision([replies[f"q{i}"]["hits"] for i in range(n_req)],
                          oracle[:n_req])
    emit({"phase": "E_daemon_loop", "requests": n_req, "seconds": secs,
          "dispatches": stats.dispatches,
          "stats_reply": "stats" in replies["stats"],
          "precision_at_10_raw": check("daemon precision@10", prec, 0.9,
                                       ">")})


def four_cards(cfg, rng):
    """The edge-sharded (2x2) and node-sharded (graph axis 4) engines vs
    the single-device engine on card 0."""
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf
    from ppr_tpu.ops.topk import topk_ids_with_ties_from_pairs
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk
    from ppr_tpu.parallel.sharded import make_mesh
    from ppr_tpu.parallel.sharded_fora import ShardedForaTopk

    def compare(name, engine, single_out, sources, g):
        _, cold = timed(lambda: engine.compute_topk_ids_batch(
            sources, K, EPS))
        (vals, ids), warm = timed(lambda: engine.compute_topk_ids_batch(
            sources, K, EPS))
        s_vals, s_ids = single_out
        worst = 0.0
        for i in range(len(sources)):
            got = topk_ids_with_ties_from_pairs(vals[i], ids[i], K, tol=1e-6)
            want = topk_ids_with_ties_from_pairs(s_vals[i], s_ids[i], K,
                                                 tol=1e-6)
            if set(got.tolist()) != set(want.tolist()):
                raise AssertionError(f"{name} row {i}: top-k ids differ")
            a = dict(zip(ids[i].tolist(), vals[i].tolist()))
            b = dict(zip(s_ids[i].tolist(), s_vals[i].tolist()))
            for v in want.tolist():
                worst = max(worst, abs(a[v] - b[v]) / (5e-6 + 1e-4 * b[v]))
        return {"engine": name, "graph": {"n": g.n, "m": g.m},
                "batch": len(sources), "cold_s": cold, "warm_s": warm,
                "score_err_over_tol": check(
                    f"{name} |score - single| / (5e-6 + 1e-4 |single|)",
                    worst, 1.0, "<="),
                "vals": vals, "ids": ids}

    rows = []
    for (n, deg), batch, engines in (
            (cfg["headline"], cfg["four_batch"], ("edge", "node",
                                                  "frontier")),
            (cfg["four_big"], cfg["four_big_batch"], ("node",))):
        ds = synthetic_powerlaw(n, deg, seed=42, dense_threshold=0)
        g = ds.graph
        sources = rng.integers(0, g.n, size=batch)
        single = AlgoConf(ALPHA, seed=7).set_conf_fora_topk(ds, K)
        single.push, single.completion = "none", "spmv"
        single_out = single.compute_topk_ids_batch(sources, K, EPS)
        out = {}
        for e in engines:
            if e == "edge":
                engine = ShardedForaTopk(ds, ALPHA, K,
                                         mesh=make_mesh(4, data=2, graph=2))
            else:
                kw = dict(frontier_blocks=16, num_blocks=16) \
                    if e == "frontier" else {}
                engine = NodeShardedForaTopk(
                    ds, ALPHA, K, mesh=make_mesh(4, data=1, graph=4), **kw)
            out[e] = compare(f"{e}_sharded", engine, single_out, sources, g)
        if "frontier" in out:
            # full-capacity frontier ring vs the dense ring: the same terms,
            # which the GPU's scatter-add may sum in another order, so the
            # two agree to a few f32 ulps rather than bitwise (bitwise on
            # the CPU, __graft_entry__.dryrun_multichip)
            f, d = out["frontier"], out["node"]
            f["bitwise_equal_dense_ring"] = bool(
                np.array_equal(f["vals"], d["vals"])
                and np.array_equal(f["ids"], d["ids"]))
            f["max_abs_diff_dense_ring"] = check(
                "frontier vs dense ring",
                float(np.abs(f["vals"] - d["vals"]).max()), FRONTIER_ATOL,
                "<=")
        for r in out.values():
            r.pop("vals"), r.pop("ids")
            rows.append(r)
    emit({"phase": "four_cards", "checks": rows,
          "device_memory": device_memory()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh engines (needs four devices)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    import numpy as np

    from ppr_tpu.utils.cache import cache_dir, enable_compilation_cache

    enable_compilation_cache()
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"header": True, "nvidia_smi": smi, "jax": jax.__version__,
          "devices": [str(d) for d in devices],
          "device_kind": devices[0].device_kind,
          "xla_flags": os.environ.get("XLA_FLAGS"),
          "compile_cache": cache_dir()})
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 devices, "
                             f"found {len(devices)}")
        four_cards(SIZES, rng)
    else:
        svc, acc, oracle = phase_a(SIZES, rng)
        phase_b(SIZES, rng)
        phase_c(SIZES, rng)
        phase_d(SIZES)
        phase_e(SIZES, svc, acc, oracle)
    emit({"total_s": time.perf_counter() - t0})
    print(json.dumps(result_line(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
