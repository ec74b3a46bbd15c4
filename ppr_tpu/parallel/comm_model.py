"""Analytic communication model for the sharded PPR engines.

A virtual CPU mesh shares one socket's silicon, so its timings measure
partition overhead, not scaling. This module gives (a) a bytes-level model
of what each sweep moves between devices vs what it computes, priced with
a device table entry (:mod:`ppr_tpu.utils.devices`), and (b) a measured
collective-vs-compute breakdown (:func:`measure_breakdown`) that validates
the model's structure on the virtual mesh and measures real collective
time on real devices.

Communication per propagation sweep, per device:

* **edge-sharded (1D) engines** (sharded_fora / sharded_allpair /
  mesh_algos): the local [n_pad, B_local] segment-sum partials are combined
  by ONE ``psum`` over the 'graph' axis. A ring all-reduce moves
  ``2 (S-1)/S * n_pad * B_local * 4`` bytes out of each device (reduce-
  scatter + all-gather halves).
* **node-sharded ring engines** (node_sharded / node_sharded_fora): the
  residue chunks circulate with ``S-1`` ``ppermute`` hops of
  ``[B_local, n_local] * 4`` bytes each; no full-width array ever moves.
  Note ring traffic is ``(S-1) * n_pad/S * B_l * 4`` ~ HALF the 1D psum
  traffic at large S, and its peak memory is O(n/S).

Compute per sweep, per device: ``m/S`` edges through the gather +
segment-sum pipeline at the table's per-edge sweep cost (per sweep, or per
row times the local batch where the entry's cost is per row).

Link rate: the table's per-device egress. On NVLink cards every device
reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from ..utils.devices import DeviceRates, device_rates


def psum_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                         payload_bytes: int = 4) -> int:
    """Ring all-reduce egress bytes per device per sweep (1D engines)."""
    if s_graph <= 1:
        return 0
    return int(2 * (s_graph - 1) / s_graph * n_pad * b_local * payload_bytes)


def ring_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                         payload_bytes: int = 4) -> int:
    """ppermute-ring egress bytes per device per sweep (node-sharded).

    ``payload_bytes=2`` prices the bf16 ring (``ring_dtype="bf16"`` in
    node_sharded/node_sharded_fora): the chunk is cast to bfloat16 for
    each hop's wire transfer, halving the linear comm term directly."""
    if s_graph <= 1:
        return 0
    n_local = n_pad // s_graph
    return int((s_graph - 1) * n_local * b_local * payload_bytes)


def frontier_ring_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                                  capacity_frac: float = 1.0,
                                  payload_bytes: int = 4,
                                  num_blocks: int = 64) -> int:
    """ppermute-ring egress bytes with FRONTIER COMPACTION (round 5).

    ``frontier_blocks=C`` in node_sharded_fora circulates only the top-C
    of ``num_blocks`` column blocks per sweep: values shrink to
    ``capacity_frac = C/num_blocks`` of the dense chunk, plus a [C] i32
    block-id vector per hop. Composes with bf16 (``payload_bytes=2``).
    Deferral inflates the SWEEP COUNT, not the per-sweep bytes — price
    that separately via the measured mass-coverage curve
    (scripts/ring_occupancy.py): sweeps multiply by roughly
    1/coverage(C) on the decaying tail."""
    if s_graph <= 1:
        return 0
    n_local = n_pad // s_graph
    vals = (s_graph - 1) * int(n_local * capacity_frac) * b_local \
        * payload_bytes
    ids = (s_graph - 1) * int(num_blocks * capacity_frac) * 4
    return vals + ids


@dataclasses.dataclass
class SweepPrediction:
    engine: str
    s_graph: int
    batch: int
    b_local: int
    payload_bytes: int
    comm_bytes: int
    t_comm_s: float
    t_compute_s: float
    t_sweep_s: float
    #: strong-scaling efficiency vs 1 device: T(1) / (S * T(S))
    efficiency: float
    #: upper-bound variant: ring hops overlapped with block compute
    #: (rotate-after-use lets XLA's latency-hiding scheduler run hop t's
    #: segment-sum while hop t's send is in flight) ->
    #: t = max(t_comm, t_compute); the serial number is the lower bound
    t_sweep_overlap_s: float = 0.0
    efficiency_overlap: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def predict_sweep(
    g: Graph,
    *,
    engine: str = "edge_sharded",      # or "node_sharded"
    s_graph: int = 2,
    s_data: int = 1,
    batch: int = 512,
    payload_bytes: int = 4,            # 2 = bf16 ring payloads
    capacity_frac: float = 1.0,        # <1 = frontier-compacted ring
    sweep_inflation: float = 1.0,      # extra sweeps deferral costs
    rates: DeviceRates | None = None,  # default: the first device's entry
) -> SweepPrediction:
    """Model one propagation sweep on an (s_data x s_graph) mesh.

    The 'data' axis is communication-free (independent query rows), so
    efficiency is governed by the graph axis: compute shrinks as m/S while
    the psum/ring traffic grows with the state width.

    ``capacity_frac < 1`` prices the frontier-compacted node-sharded ring
    (node_sharded_fora ``frontier_blocks``); pass the measured
    ``sweep_inflation`` (~1/mass-coverage on the decaying tail,
    scripts/ring_occupancy.py) so the deferral cost is not hidden.
    """
    rates = rates or device_rates()
    b_local = max(1, batch // max(s_data, 1))
    ns_per_edge = rates.spmv_ns_per_edge * (
        1 if rates.spmv_batch_amortized else b_local)
    if engine == "edge_sharded":
        comm = psum_bytes_per_sweep(g.n_pad, b_local, s_graph,
                                    payload_bytes)
    elif engine == "node_sharded":
        if capacity_frac < 1.0:
            comm = frontier_ring_bytes_per_sweep(
                g.n_pad, b_local, s_graph, capacity_frac, payload_bytes
            )
        else:
            comm = ring_bytes_per_sweep(g.n_pad, b_local, s_graph,
                                        payload_bytes)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    t_comm = comm / rates.link_bytes_per_s
    t_compute_1 = g.m * ns_per_edge * 1e-9               # all edges, 1 dev
    t_compute = t_compute_1 / max(s_graph, 1)
    t_sweep = (t_compute + t_comm) * sweep_inflation
    t_overlap = max(t_compute, t_comm) * sweep_inflation
    total_devices = max(s_graph, 1)                      # per data group
    eff = t_compute_1 / (total_devices * t_sweep)
    eff_ov = t_compute_1 / (total_devices * t_overlap) if t_overlap else 0.0
    return SweepPrediction(
        engine=engine, s_graph=s_graph, batch=batch, b_local=b_local,
        payload_bytes=payload_bytes, comm_bytes=comm, t_comm_s=t_comm,
        t_compute_s=t_compute, t_sweep_s=t_sweep, efficiency=eff,
        t_sweep_overlap_s=t_overlap, efficiency_overlap=min(eff_ov, 1.0),
    )


#: cards of one host in :func:`four_card_prediction`
CARDS = 4


def four_card_prediction(g: Graph, *, batch: int = 512,
                         frontier: dict | None = None,
                         rates: DeviceRates | None = None) -> dict:
    """Going from one card to four cards of one host: data-parallel
    over the cards (the engines' preferred layout for throughput, since
    query rows are independent) and graph-parallel (the layout for graphs
    one card cannot hold)."""
    rates = rates or device_rates()

    def pred(engine, s_graph, **kw):
        return predict_sweep(g, engine=engine, s_graph=s_graph, batch=batch,
                             rates=rates, **kw)

    s1 = pred("edge_sharded", 1)
    sk = pred("edge_sharded", CARDS)
    nk = pred("node_sharded", CARDS)
    nk_bf16 = pred("node_sharded", CARDS, payload_bytes=2)
    nk_frontier = None
    if frontier is not None:
        # frontier-compacted + bf16 ring, priced with the MEASURED sweep
        # inflation (scripts/ring_occupancy.py empirical part) so the
        # deferral cost is inside the efficiency number, not beside it
        nk_frontier = pred(
            "node_sharded", CARDS, payload_bytes=2,
            capacity_frac=float(frontier["capacity_frac"]),
            sweep_inflation=float(frontier.get("sweep_inflation", 1.0)),
        )
    return {
        "graph": {"n_pad": int(g.n_pad), "m": int(g.m)},
        "batch": batch,
        "cards": CARDS,
        "data_parallel": {
            "efficiency": 1.0,
            "note": "independent query rows; no collectives",
        },
        "graph_parallel_1card": s1.as_dict(),
        "graph_parallel": sk.as_dict(),
        "node_sharded": nk.as_dict(),
        "node_sharded_bf16_ring": nk_bf16.as_dict(),
        "node_sharded_frontier_bf16": (
            dict(nk_frontier.as_dict(), **{
                "capacity_frac": frontier["capacity_frac"],
                "sweep_inflation": frontier.get("sweep_inflation", 1.0),
                "block_order": frontier.get("block_order", "degree"),
                "source": frontier.get("source", "scripts/ring_occupancy.py"),
            }) if nk_frontier is not None else None
        ),
        "assumptions": {
            "link_bytes_per_s": rates.link_bytes_per_s,
            "spmv_ns_per_edge": rates.spmv_ns_per_edge,
            "spmv_batch_amortized": rates.spmv_batch_amortized,
            "rates_source": rates.source,
        },
    }


def measure_breakdown(
    mesh: Mesh,
    g: Graph,
    *,
    alpha: float = 0.15,
    batch: int = 64,
    num_sweeps: int = 16,
    iters: int = 5,
) -> dict:
    """Measured collective-vs-compute split of the edge-sharded sweep.

    Two identical fused sweep programs are timed: the real one (psum over
    'graph' each sweep) and a local-only twin (psum deleted; numerically
    wrong on purpose — same FLOPs/gathers, zero collectives). Their
    difference isolates what the collectives + the induced scheduling cost
    on THIS backend. On the virtual CPU mesh this validates the model's
    structure; on real devices it measures actual collective time."""
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    s_graph = mesh_shape["graph"]
    alpha_f = jnp.float32(alpha)
    n_pad = g.n_pad

    edge_spec = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())
    state_spec = NamedSharding(mesh, P(None, "data"))
    edge_src = jax.device_put(g.edge_src_bydst, edge_spec)
    edge_dst = jax.device_put(g.edge_dst_bydst, edge_spec)
    out_deg = jax.device_put(g.out_deg, rep)

    def make(with_psum: bool):
        def local(e_src, e_dst, deg, r_t):
            inv_deg = jnp.where(
                deg > 0, 1.0 / jnp.maximum(deg.astype(jnp.float32), 1.0), 0.0
            )

            def body(_, r_):
                contrib = jnp.take(r_ * inv_deg[:, None], e_src, axis=0)
                pushed = jax.ops.segment_sum(
                    contrib, e_dst, num_segments=n_pad,
                    indices_are_sorted=True,
                )
                if with_psum:
                    pushed = jax.lax.psum(pushed, "graph")
                return (1.0 - alpha_f) * pushed

            return jax.lax.fori_loop(0, num_sweeps, body, r_t)

        return jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("graph"), P("graph"), P(), P(None, "data")),
            out_specs=P(None, "data"),
            check_vma=False,
        ))

    rng = np.random.default_rng(0)
    r0 = jax.device_put(
        jnp.asarray(rng.random((n_pad, batch)), jnp.float32), state_spec
    )

    timings = {}
    for name, fn in (("full", make(True)), ("local_only", make(False))):
        jax.block_until_ready(fn(edge_src, edge_dst, out_deg, r0))  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(edge_src, edge_dst, out_deg, r0))
        timings[name] = (time.perf_counter() - t0) / iters / num_sweeps

    t_full, t_local = timings["full"], timings["local_only"]
    return {
        "mesh": mesh_shape,
        "batch": batch,
        "num_sweeps": num_sweeps,
        "t_sweep_full_s": t_full,
        "t_sweep_local_only_s": t_local,
        "collective_s": max(0.0, t_full - t_local),
        "collective_fraction": max(0.0, 1.0 - t_local / t_full)
        if t_full > 0 else 0.0,
        "platform": jax.devices()[0].platform,
        "model_psum_bytes": psum_bytes_per_sweep(
            n_pad, max(1, batch // mesh_shape["data"]), s_graph
        ),
    }


def main(argv=None) -> int:
    import argparse
    import json

    from ..graph.io import synthetic_powerlaw
    from ..utils.devices import TABLE
    from .sharded import make_mesh

    ap = argparse.ArgumentParser(prog="ppr_tpu.parallel.comm_model")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--measure", action="store_true",
                    help="also run the virtual-mesh breakdown measurement")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="force the CPU backend with N virtual devices")
    ap.add_argument("--device-kind", default=None,
                    help="price the prediction with this device table "
                         "entry (default: the first device's kind)")
    ap.add_argument("--frontier-json", default=None,
                    help="ring-occupancy artifact "
                         "(scripts/ring_occupancy.py); the prediction "
                         "adds a frontier-compacted entry priced at the "
                         "measured capacity/inflation point that "
                         "minimizes the modeled sweep time")
    ap.add_argument("--frontier-graph", default=None,
                    help="graph key inside --frontier-json (default: "
                         "synth:<n>x<deg>)")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    ds = synthetic_powerlaw(args.n, args.deg, seed=3, dense_threshold=0)
    rates = TABLE[args.device_kind] if args.device_kind else device_rates()
    frontier = None
    if args.frontier_json:
        occ = json.load(open(args.frontier_json))
        key = args.frontier_graph or f"synth:{args.n}x{args.deg}"
        entry = occ["graphs"][key]["empirical"]
        # pick the measured (capacity, inflation) point with the best
        # modeled sweep time; record the runner-ups in the output
        cands = []
        for f in entry["frontier"]:
            pred = predict_sweep(
                ds.graph, engine="node_sharded", s_graph=CARDS,
                batch=args.batch, payload_bytes=2,
                capacity_frac=f["capacity_frac"],
                sweep_inflation=f["sweep_inflation"], rates=rates,
            )
            cands.append((pred.t_sweep_s, f))
        cands.sort(key=lambda x: x[0])
        frontier = dict(cands[0][1], source=args.frontier_json,
                        measured_graph=key)
    out = four_card_prediction(ds.graph, batch=args.batch,
                               frontier=frontier, rates=rates)
    if args.frontier_json:
        out["frontier_candidates_measured"] = [c[1] for c in cands]
    if args.measure:
        mesh = make_mesh()
        out["measured_breakdown"] = measure_breakdown(
            mesh, ds.graph, batch=min(args.batch, 64)
        )
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
