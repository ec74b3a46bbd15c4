"""Live cost-constant calibration for FORA's push/walk/SpMV balance.

The reference bakes in 400 ns/walk measured on its JVM
(Fora_Whole_Graph.java:35). This measures the real per-walk and per-edge
SpMV costs and the device->host rate on the active device and graph, in the
format of :class:`ppr_tpu.utils.devices.DeviceRates`; algorithms pick them
up via :func:`apply`.

``python -m ppr_tpu.utils.calibrate`` prints the measured rates of the
current device as a table entry for :mod:`ppr_tpu.utils.devices`.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.spmv import push_out
from ..ops.walk import weighted_walk_counts


def _time_sweep(g: Graph, a, reps: int):
    """(seconds per sweep, last output)."""
    out = push_out(g, a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = push_out(g, a)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def measure(g: Graph, *, alpha: float = 0.15, walkers: int = 1 << 16,
            batch: int = 32, reps: int = 3, seed: int = 0):
    """Returns (walk_ns_per_walk, spmv_ns_per_edge, batch_amortized,
    d2h_bytes_per_s).

    The propagation sweep is timed at ``batch`` and at ``8 * batch`` rows.
    When the wide sweep costs less than twice the narrow one, the sweep's
    cost is shared by the rows of a batch (``batch_amortized=True``, ns per
    edge per sweep, priced at the wide width); otherwise each row pays its
    own share (ns per edge per row)."""
    rng = np.random.default_rng(seed)
    starts = jnp.asarray(rng.integers(0, g.n, walkers), jnp.int32)
    rows = jnp.zeros((walkers,), jnp.int32)
    weights = jnp.full((walkers,), 1.0 / walkers, jnp.float32)

    counts = weighted_walk_counts(
        g, starts, rows, weights, jax.random.key(0), alpha, num_rows=1
    )
    jax.block_until_ready(counts)
    t0 = time.perf_counter()
    for i in range(reps):
        counts = weighted_walk_counts(
            g, starts, rows, weights, jax.random.key(i + 1), alpha, num_rows=1
        )
    jax.block_until_ready(counts)
    walk_ns = (time.perf_counter() - t0) / reps / walkers * 1e9

    mask = np.asarray(g.node_mask)
    m = max(g.m, 1)
    wide = 8 * batch
    t_narrow, _ = _time_sweep(
        g, jnp.asarray(rng.random((batch, g.n_pad), np.float32) * mask), reps)
    t_wide, out = _time_sweep(
        g, jnp.asarray(rng.random((wide, g.n_pad), np.float32) * mask), reps)
    amortized = t_wide < 2.0 * t_narrow
    spmv_ns_per_edge = t_wide / m * 1e9
    if not amortized:
        spmv_ns_per_edge /= wide

    # device->host transfer rate; prices the preprocessing compaction
    # transfer in the completion choice (_ForaCostModel._use_spmv).
    # Two DISTINCT device slices (jax caches a converted array's host value,
    # so re-reading the same one is free): both are materialized and any
    # slice-op compile paid BEFORE the timed read, which then measures the
    # device->host copy alone.
    h = min(wide // 2, 64)
    warm_probe, probe = out[:h], out[h:2 * h]
    jax.block_until_ready((warm_probe, probe))
    np.asarray(warm_probe)                             # warm the path
    nbytes = probe.size * 4
    t0 = time.perf_counter()
    np.asarray(probe)
    d2h_bytes_per_s = nbytes / max(time.perf_counter() - t0, 1e-9)

    return walk_ns, spmv_ns_per_edge, amortized, d2h_bytes_per_s


def apply(algo, constants) -> None:
    """Install measured constants on a FORA algorithm instance.

    Accepts both the 3-tuple (walk, spmv, amortized) and the 4-tuple that
    adds the measured device->host rate."""
    (
        algo.avg_rand_walk_time_ns,
        algo.spmv_ns_per_edge,
        algo.spmv_batch_amortized,
    ) = constants[:3]
    if len(constants) > 3:
        algo.d2h_bytes_per_s = constants[3]


def main(argv=None) -> int:
    import argparse
    import json

    from ..cli import load_dataset

    ap = argparse.ArgumentParser(
        prog="ppr_tpu.utils.calibrate",
        description="measure this device's FORA cost rates on a graph and "
                    "print them as a ppr_tpu.utils.devices table entry",
    )
    ap.add_argument("--db", default="synth:65536x16")
    ap.add_argument("--walkers", type=int, default=1 << 16)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)

    g = load_dataset(args.db).graph
    dev = jax.devices()[0]
    walk_ns, spmv_ns, amortized, d2h = measure(
        g, walkers=args.walkers, batch=args.batch, reps=5)
    print(json.dumps({
        "device_kind": dev.device_kind, "platform": dev.platform,
        "graph": {"db": args.db, "n": g.n, "m": g.m},
        "walk_ns": walk_ns, "spmv_ns_per_edge": spmv_ns,
        "spmv_batch_amortized": bool(amortized), "d2h_bytes_per_s": d2h,
        "memory_stats": dev.memory_stats(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
