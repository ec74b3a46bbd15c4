"""Multi-device execution: row/edge-sharded push + walk under ``shard_map``.

The reference is a single-threaded JVM program (SURVEY.md §2 parallelism
table: no DP/TP/PP/collectives of any kind). This engine introduces two
mesh axes:

* ``data`` — query-batch data parallelism: the ``[B, n_pad]``
  residue/reserve matrices are sharded by query row. Replaces the reference's
  sequential per-query loop (Gen_Util.java:146-165).
* ``graph`` — the tensor-parallel analogue for graphs: the COO edge list is
  sharded into contiguous chunks; each device scatters its local edges'
  contributions into a full-width node vector and a ``lax.psum`` over the
  ``graph`` axis completes the SpMV (1D edge partition + all-reduce). Random-walk phases shard the *walker pool* over ``graph`` (each
  device advances its own walkers over the replicated CSR adjacency) and
  psum the weighted stop counts.

Pipeline/sequence/expert parallelism do not apply to PPR (no layer stack,
no sequences, no experts) — see SURVEY.md §2.

Node vectors are replicated along ``graph``; this is the standard 1D SpMV
partition (pick a mesh, annotate shardings, let XLA insert the
collectives). The node-sharded engines (:mod:`ppr_tpu.parallel.node_sharded`)
cover graphs whose node vectors exceed one device's memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph


def make_mesh(n_devices: int | None = None, *, data: int | None = None,
              graph: int | None = None, devices=None) -> Mesh:
    """Build a (data, graph) mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if graph is None:
        graph = 2 if n_devices % 2 == 0 else 1
    if data is None:
        data = n_devices // graph
    if data * graph != n_devices:
        raise ValueError(f"mesh {data}x{graph} != {n_devices} devices")
    arr = np.asarray(devices).reshape(data, graph)
    return Mesh(arr, ("data", "graph"))


def shard_graph(g: Graph, mesh: Mesh) -> Graph:
    """Place edge arrays sharded over ``graph``; node arrays replicated."""
    edge_spec = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())
    return Graph(
        indptr=jax.device_put(g.indptr, rep),
        indices=jax.device_put(g.indices, rep),
        edge_src=jax.device_put(g.edge_src, edge_spec),
        edge_dst=jax.device_put(g.edge_dst, edge_spec),
        edge_mask=jax.device_put(g.edge_mask, edge_spec),
        edge_src_bydst=jax.device_put(g.edge_src_bydst, edge_spec),
        edge_dst_bydst=jax.device_put(g.edge_dst_bydst, edge_spec),
        out_deg=jax.device_put(g.out_deg, rep),
        in_deg=jax.device_put(g.in_deg, rep),
        node_mask=jax.device_put(g.node_mask, rep),
        dense_out=None,  # sharded path always uses the COO kernels
        n=g.n,
        m=g.m,
        edge_coef=(
            jax.device_put(g.edge_coef, edge_spec)
            if g.edge_coef is not None else None
        ),
        edge_coef_bydst=(
            jax.device_put(g.edge_coef_bydst, edge_spec)
            if g.edge_coef_bydst is not None else None
        ),
        alias_prob=(
            jax.device_put(g.alias_prob, rep)
            if g.alias_prob is not None else None
        ),
        alias_other=(
            jax.device_put(g.alias_other, rep)
            if g.alias_other is not None else None
        ),
    )


def _local_push_sweep(alpha: float):
    """One forward-push sweep body over local edge chunks; psum over 'graph'.

    Semantics identical to ops/push.py forward_push_sweeps (single sweep):
    frontier gate r/d >= rmax with dangling => r > 0, dangling mass returned
    to the source (Forward_Push.java:85-141 quirks preserved)."""

    def sweep(edge_src, edge_dst, edge_mask, edge_coef, out_deg, node_mask,
              p, r, src_onehot, rmax):
        deg_f = out_deg.astype(jnp.float32)
        is_dangling = (out_deg == 0) & (node_mask > 0)
        active = (
            ((out_deg > 0) & (r >= rmax * deg_f))
            | (is_dangling & (r > 0))
        ) & (node_mask > 0)
        a = jnp.where(active, r, 0.0)
        p = p + alpha * a
        a_dang = jnp.where(is_dangling, a, 0.0)
        dang_mass = jnp.sum(a_dang, axis=-1, keepdims=True)
        rem = (1.0 - alpha) * (a - a_dang)
        if edge_coef is None:
            inv_deg = jnp.where(
                out_deg > 0, 1.0 / jnp.maximum(deg_f, 1.0), 0.0
            )
            vals = jnp.take(rem * inv_deg, edge_src, axis=-1) * edge_mask
        else:
            # weighted: per-edge normalized coefficient replaces 1/d scaling
            vals = jnp.take(rem, edge_src, axis=-1) * edge_coef * edge_mask
        contrib = jnp.zeros_like(r).at[..., edge_dst].add(vals)
        pushed = jax.lax.psum(contrib, "graph")
        r = r - a + pushed + (1.0 - alpha) * dang_mass * src_onehot
        return p, r

    return sweep


def make_sharded_push_sweeps(mesh: Mesh, alpha: float, num_sweeps: int,
                             weighted: bool = False):
    """jit-compiled: ``num_sweeps`` sharded push sweeps over the mesh.

    With ``weighted=True`` the callable takes an extra per-edge coefficient
    chunk after ``edge_mask``."""
    sweep = _local_push_sweep(alpha)

    if weighted:
        def many(edge_src, edge_dst, edge_mask, edge_coef, out_deg,
                 node_mask, p, r, src_onehot, rmax):
            def body(_, pr):
                return sweep(edge_src, edge_dst, edge_mask, edge_coef,
                             out_deg, node_mask, pr[0], pr[1], src_onehot,
                             rmax)

            p, r = jax.lax.fori_loop(0, num_sweeps, body, (p, r))
            return p, r

        edge_specs = (P("graph"), P("graph"), P("graph"), P("graph"))
    else:
        def many(edge_src, edge_dst, edge_mask, out_deg, node_mask, p, r,
                 src_onehot, rmax):
            def body(_, pr):
                return sweep(edge_src, edge_dst, edge_mask, None, out_deg,
                             node_mask, pr[0], pr[1], src_onehot, rmax)

            p, r = jax.lax.fori_loop(0, num_sweeps, body, (p, r))
            return p, r

        edge_specs = (P("graph"), P("graph"), P("graph"))

    mapped = jax.shard_map(
        many,
        mesh=mesh,
        in_specs=edge_specs + (
            P(), P(),                              # node arrays (replicated)
            P("data", None), P("data", None),      # p, r
            P("data", None),                       # src one-hot
            P(),                                   # rmax
        ),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_sharded_walk_counts(mesh: Mesh, alpha: float, max_steps: int = 128,
                             weighted: bool = False):
    """jit-compiled: advance a [B, W] walker grid (rows sharded over 'data',
    walkers over 'graph'), psum weighted stop counts into [B, n_pad].

    ``weighted=True`` adds Walker alias-table sampling (the single-device
    kernel's law, ops/walk._uniform_neighbor): the uniform draw picks a CSR
    slot, a second uniform accepts it with ``alias_prob[slot]`` or
    redirects to ``alias_other[slot]`` — exact weight-proportional
    transitions; the call then takes ``(indptr, indices, alias_prob,
    alias_other, out_deg, starts, weights, key)``."""

    def local(indptr, indices, alias_prob, alias_other, out_deg, starts,
              weights, keys):
        # starts/weights: [B_local, W_local]; keys: [1, 1, 2] uint32 material
        n_pad = out_deg.shape[0]
        b, w = starts.shape
        flat_starts = starts.reshape(-1)
        key = jax.random.fold_in(
            jax.random.wrap_key_data(keys[0, 0]),
            jax.lax.axis_index("data") * jax.lax.axis_size("graph")
            + jax.lax.axis_index("graph"),
        )

        def cond(state):
            _, active, _, step = state
            return (step < max_steps) & jnp.any(active)

        def body(state):
            cur, active, k, step = state
            k, k_stop, k_move = jax.random.split(k, 3)
            stop_now = jax.random.uniform(k_stop, flat_starts.shape) < alpha
            deg = jnp.take(out_deg, cur)
            u = jax.random.uniform(k_move, flat_starts.shape)
            pick = jnp.minimum((u * deg.astype(jnp.float32)).astype(jnp.int32),
                               deg - 1)
            idx = jnp.take(indptr, cur) + jnp.maximum(pick, 0)
            if weighted:
                k, k_acc = jax.random.split(k)
                u2 = jax.random.uniform(k_acc, flat_starts.shape)
                accept = u2 < jnp.take(alias_prob, idx)
                idx = jnp.where(accept, idx, jnp.take(alias_other, idx))
            nxt = jnp.take(indices, idx)
            nxt = jnp.where(deg > 0, nxt, flat_starts)
            cur = jnp.where(active & ~stop_now, nxt, cur)
            return cur, active & ~stop_now, k, step + 1

        stops, _, _, _ = jax.lax.while_loop(
            cond, body,
            (flat_starts, jnp.ones(flat_starts.shape, bool), key, jnp.int32(0)),
        )
        rows = jnp.repeat(jnp.arange(b, dtype=jnp.int32), w)
        counts = jnp.zeros((b, n_pad), jnp.float32)
        counts = counts.at[rows, stops.reshape(-1)].add(weights.reshape(-1))
        return jax.lax.psum(counts, "graph")

    if weighted:
        fn = local
        csr_specs = (P(), P(), P(), P())
    else:
        def fn(indptr, indices, out_deg, starts, weights, keys):
            return local(indptr, indices, None, None, out_deg, starts,
                         weights, keys)

        csr_specs = (P(), P())

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=csr_specs + (
            P(),                                   # out_deg (replicated)
            P("data", "graph"), P("data", "graph"),  # walkers
            P("data", "graph"),                     # per-device key material
        ),
        out_specs=P("data", None),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def call(indptr, indices, *rest):
        mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        if weighted:
            alias_prob, alias_other, out_deg, starts, weights, key = rest
        else:
            out_deg, starts, weights, key = rest
        keys = jax.random.key_data(
            jax.random.split(key, mesh_shape["data"] * mesh_shape["graph"])
        ).reshape(mesh_shape["data"], mesh_shape["graph"], -1)
        if weighted:
            return jitted(indptr, indices, alias_prob, alias_other, out_deg,
                          starts, weights, keys)
        return jitted(indptr, indices, out_deg, starts, weights, keys)

    return call


def sharded_fora_step(mesh: Mesh, g: Graph, alpha: float = 0.15,
                      num_sweeps: int = 4, walkers_per_row: int | None = None):
    """One full FORA-style query step (push sweeps + walk estimate), jitted
    over the mesh. Returns ``(step_fn, example_args)``; used by the multichip
    dry-run and as the scaling unit of the engine."""
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    b = max(mesh_shape["data"] * 2, 2)
    if walkers_per_row is None:
        walkers_per_row = mesh_shape["graph"] * 64

    gs = shard_graph(g, mesh)
    push = make_sharded_push_sweeps(mesh, alpha, num_sweeps)
    walk = make_sharded_walk_counts(mesh, alpha)

    sources = jnp.arange(b, dtype=jnp.int32) % g.n
    src_onehot = jax.nn.one_hot(sources, g.n_pad, dtype=jnp.float32)
    data_sharded = NamedSharding(mesh, P("data", None))
    src_onehot = jax.device_put(src_onehot, data_sharded)
    p0 = jax.device_put(jnp.zeros((b, g.n_pad), jnp.float32), data_sharded)
    rmax = jnp.float32(1e-4)

    walker_sharding = NamedSharding(mesh, P("data", "graph"))
    starts = jax.device_put(
        jnp.broadcast_to(sources[:, None], (b, walkers_per_row)).astype(jnp.int32),
        walker_sharding,
    )

    def step(p, r, src_onehot, rmax, key):
        p, r = push(
            gs.edge_src, gs.edge_dst, gs.edge_mask, gs.out_deg, gs.node_mask,
            p, r, src_onehot, rmax,
        )
        weights = jax.device_put(
            jnp.broadcast_to(
                (r.sum(axis=-1, keepdims=True) / walkers_per_row),
                (b, walkers_per_row),
            ),
            walker_sharding,
        )
        counts = walk(gs.indptr, gs.indices, gs.out_deg, starts, weights, key)
        # plain (zero-hop-allowed) walks already realize the alpha-stop at the
        # walk origin, so the walk estimate covers the full residual mass
        return p + counts, r

    example = (p0, src_onehot, src_onehot, rmax, jax.random.key(0))
    return step, example
