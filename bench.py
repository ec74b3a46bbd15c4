"""Benchmark: FORA top-k PPR queries/sec on the device vs a CPU baseline.

Workload (BASELINE.json configs): top-k SSPPR with the full FORA hybrid
(push-until-rmax then residual-weighted walks) at alpha=0.15, eps=0.5, k=10
on a seeded ~1M-edge synthetic graph, accuracy-checked as precision@10
against the exact power-iteration oracle (the reference protocol of
Gen_Util.java:109-257 at the defaults of PPR.java:177-184).

The CPU baseline is a faithful vectorized scipy/numpy implementation of the
same algorithm (sparse-matvec push sweeps + lockstep numpy walks) — a
stand-in for the reference's Java/Neo4j engine, which cannot run here (no
JVM/Maven in the image; the committed reference also does not compile,
Fora_Topk.java:136).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
naming the device it ran on. A device failure fails the run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np


def build_dataset(n, deg, seed=42):
    from ppr_tpu.graph.io import synthetic_powerlaw

    return synthetic_powerlaw(n, deg, seed=seed, dense_threshold=0)


# --------------------------------------------------------------------------
# CPU baseline: same FORA top-k algorithm on scipy sparse + numpy
# --------------------------------------------------------------------------
class CpuFora:
    def __init__(self, ds, alpha, k):
        import scipy.sparse as sp

        g = ds.graph
        self.n = g.n
        self.alpha = alpha
        self.k = k
        src = np.asarray(g.edge_src)[: g.m]
        dst = np.asarray(g.edge_dst)[: g.m]
        deg = np.asarray(g.out_deg)[: self.n].astype(np.float64)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
        self.P = sp.coo_matrix(
            (inv[src], (src, dst)), shape=(self.n, self.n)
        ).tocsr()
        self.deg = deg
        self.dangling = deg == 0
        # CSR for walks
        order = np.argsort(src, kind="stable")
        self.w_dst = dst[order]
        self.w_indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=self.n), out=self.w_indptr[1:])
        self.min_delta = 1.0 / self.n
        self.pfail = 1.0 / self.n / self.n / math.log(max(self.n / k, math.e))

    def _push(self, p, r, rmax):
        for _ in range(10_000):
            gate = np.where(self.deg > 0, rmax * self.deg, np.inf)
            active = (r >= gate) | (self.dangling & (r > 0))
            if not active.any():
                break
            a = np.where(active, r, 0.0)
            p += self.alpha * a
            a_d = np.where(self.dangling, a, 0.0)
            out = (1 - self.alpha) * (a - a_d)
            r = r - a + out @ self.P
            r[self.src] += (1 - self.alpha) * a_d.sum()
        return p, r

    def _walks(self, starts, rng, max_steps=128):
        cur = starts.copy()
        active = np.ones(cur.shape, bool)
        for _ in range(max_steps):
            if not active.any():
                break
            stop = rng.random(cur.shape) < self.alpha
            act_idx = active & ~stop
            d = self.deg[cur].astype(np.int64)
            u = rng.random(cur.shape)
            pick = np.minimum((u * d).astype(np.int64), np.maximum(d - 1, 0))
            nxt = self.w_dst[np.minimum(self.w_indptr[cur] + pick,
                                        len(self.w_dst) - 1)]
            nxt = np.where(d > 0, nxt, starts)
            cur = np.where(act_idx, nxt, cur)
            active = act_idx
        return cur

    def topk(self, source, eps, rng):
        eps = eps * 0.5
        self.src = source
        ln_t = math.log(2.0 / self.pfail)
        m = self.P.nnz
        delta = 1.0 / self.k
        p = np.zeros(self.n)
        r = np.zeros(self.n)
        r[source] = 1.0
        while True:
            rmax = eps * math.sqrt(delta / 3.0 / m / ln_t)
            rmax *= math.sqrt(m * rmax) * 3.0
            omega = (eps + 2.0) * ln_t / eps / eps / delta
            p, r = self._push(p, r, rmax)
            num_walk = omega * r.sum() * (1 - self.alpha)
            om = np.where(r > 0, np.ceil(r * num_walk), 0).astype(np.int64)
            total = int(om.sum())
            round_p = p.copy()
            if total > 0:
                starts = np.repeat(np.arange(self.n), om)
                w = np.repeat(
                    np.where(om > 0, r / np.maximum(om, 1), 0.0), om
                )
                stops = self._walks(starts, rng)
                np.add.at(round_p, stops, w)
            sup = round_p[round_p > 0]
            kth = np.partition(sup, -self.k)[-self.k] if sup.size >= self.k else 0.0
            if kth >= (1 + eps) * delta or delta <= self.min_delta:
                return round_p
            delta = max(self.min_delta, delta / 4.0)


# --------------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--cpu-queries", type=int, default=16)
    ap.add_argument("--acc-queries", type=int, default=32)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-hub-split", action="store_true",
                    help="disable the dense-hub hybrid SpMV (default: auto "
                         "hub count, bf16 hub matrix)")
    ap.add_argument("--hub-split", type=int, default=None,
                    help="override the auto hub count")
    args = ap.parse_args()
    if args.hub_split is not None and args.hub_split <= 0:
        ap.error("--hub-split must be positive; use --no-hub-split to "
                 "disable the hybrid SpMV")
    if args.quick:
        args.n, args.deg, args.batch = 4096, 8, 8
        args.cpu_queries, args.acc_queries = 1, 4

    import jax
    import jax.numpy as jnp

    from ppr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from ppr_tpu.models import AlgoConf
    from ppr_tpu.models.power_method import power_method_batch
    from ppr_tpu.ops.topk import (
        topk_ids_with_ties,
        topk_ids_with_ties_from_pairs,
    )
    from ppr_tpu.utils.metrics import precision_at_k

    ds = build_dataset(args.n, args.deg)
    g = ds.graph
    rng = np.random.default_rng(0)
    sources = rng.integers(0, g.n, size=args.batch)

    conf = AlgoConf(args.alpha, seed=7)
    fora = conf.set_conf_fora_topk(ds, args.k)
    if not args.no_hub_split:
        # dense-hub hybrid SpMV, bf16 hub matrix, auto hub count
        fora.enable_hub_split(
            args.hub_split if args.hub_split is not None else "auto",
            dtype=jnp.bfloat16,
        )

    # warmup (compile) then one timed run
    fora.compute_topk_ids_batch(sources, args.k, args.eps)
    t0 = time.perf_counter()
    vals, ids = fora.compute_topk_ids_batch(sources, args.k, args.eps)
    device_s = time.perf_counter() - t0
    # tie tolerance = eps*min_delta: estimates of an exact oracle tie at
    # the k-th value can split by float noise far below the algorithm's
    # eps*delta accuracy bound; the raw (tol=0) sets are also reported
    tie_tol = args.eps * (1.0 / g.n)
    n_acc = min(args.batch, args.acc_queries)
    algo_ids_rows = [
        topk_ids_with_ties_from_pairs(vals[i], ids[i], args.k, tol=tie_tol)
        for i in range(n_acc)
    ]
    algo_ids_rows_raw = [
        topk_ids_with_ties_from_pairs(vals[i], ids[i], args.k)
        for i in range(n_acc)
    ]
    # tie sets that could extend past the device selection window get
    # exact (dense) recomputation so reported recall is never understated
    overflow = [
        i for i in range(n_acc)
        if len(algo_ids_rows[i]) == vals.shape[1] and vals[i][-1] > 0.0
    ]
    if overflow:
        dense_rows = fora.compute_topk_batch(
            sources[overflow], args.k, args.eps
        )
        for j, i in enumerate(overflow):
            algo_ids_rows[i] = topk_ids_with_ties(
                dense_rows[j], args.k, tol=tie_tol
            )
            algo_ids_rows_raw[i] = topk_ids_with_ties(dense_rows[j], args.k)
    device_qps = args.batch / device_s
    dev = jax.devices()[0]

    # accuracy vs exact power iteration
    acc_sources = sources[: args.acc_queries]
    oracle = np.asarray(
        power_method_batch(g, np.asarray(acc_sources, np.int32), args.alpha,
                           100)
    )
    precs, precs_raw = [], []
    for i in range(min(len(acc_sources), len(algo_ids_rows))):
        gnd = topk_ids_with_ties(oracle[i], args.k)
        precs.append(precision_at_k(algo_ids_rows[i], gnd))
        precs_raw.append(precision_at_k(algo_ids_rows_raw[i], gnd))
    recall = float(np.mean(precs))
    recall_raw = float(np.mean(precs_raw))

    # CPU baseline
    cpu = CpuFora(ds, args.alpha, args.k)
    crng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for s in sources[: args.cpu_queries]:
        cpu.topk(int(s), args.eps, crng)
    cpu_qps = args.cpu_queries / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": "fora_topk_queries_per_sec",
        "value": round(device_qps, 3),
        "unit": "queries/s",
        "vs_baseline": round(device_qps / cpu_qps, 3),
        "recall_at_10": round(recall, 4),
        "recall_at_10_raw": round(recall_raw, 4),
        "acc_queries": len(precs),
        "cpu_queries": args.cpu_queries,
        "cpu_baseline_qps": round(cpu_qps, 3),
        "graph": {"n": g.n, "m": g.m},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
