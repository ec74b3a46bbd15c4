"""Sharded BASE all-pair preprocessing: backward search on a device mesh.

BASE preprocessing (Base_Whole_Graph.java:58-165) is the heaviest offline
job in the reference — a reverse push from *every* node as target. The
single-device engine already batches T targets into one ``[T, n_pad]``
matrix program (:mod:`ppr_tpu.models.base_allpair`); this module runs that
same reverse-push sweep end to end on a (data, graph) mesh so the all-pair
sweep scales past one chip:

* ``data`` axis: target rows — the ``[n_pad, T]`` node-major reserve and
  residue state is column-sharded, T/data_size rows per device;
* ``graph`` axis: the src-sorted COO edge list is 1D-partitioned into
  contiguous chunks (a contiguous chunk of globally src-sorted edges is
  itself src-sorted, so every local scatter is a sorted segment
  reduction); one ``lax.psum(..., "graph")`` per sweep completes the
  reverse SpMV (``y[u] = 1/d_out(u) * sum over edges u->v of rem[v]``).

Semantics match :func:`ppr_tpu.ops.push.backward_push_sweeps` exactly —
strict ``r > rmax`` gate (Backward_Search.java:89-94), mass dying at
in-degree-0 frontier nodes (:73-96), and the in-degree-0 target
short-circuit ``pi(t,t)=1`` (:46-49) applied in the device epilogue.
Loop control is ``pmax``-combined over 'data' so every device runs the
batch-wide trip count of the single-device kernel (extra sweeps on
already-settled rows are exact no-ops under the strict gate).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from .sharded import make_mesh


def _shard_edges_bysrc(g: Graph, mesh: Mesh) -> dict:
    """Device-put the primary (src-sorted) COO view sharded over 'graph';
    node arrays replicated. Padding edges carry the sentinel node, which
    never holds residue, so chunk-local scatters need no masks."""
    edge_spec = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())
    arrays = dict(
        edge_src=jax.device_put(g.edge_src, edge_spec),
        edge_dst=jax.device_put(g.edge_dst, edge_spec),
        out_deg=jax.device_put(g.out_deg, rep),
        in_deg=jax.device_put(g.in_deg, rep),
        node_mask=jax.device_put(g.node_mask, rep),
    )
    if g.weighted:
        arrays["edge_coef"] = jax.device_put(g.edge_coef, edge_spec)
    return arrays


def make_sharded_backward_sweeps(mesh: Mesh, g: Graph, *, alpha: float,
                                 max_sweeps: int = 10_000):
    """Build the jitted sharded reverse-push program.

    Returns ``fn(edges..., targets, rmax) -> reserve [T, n_pad]`` with
    ``targets`` int32[T] sharded over 'data' and the output row-sharded
    over 'data'. The whole sweep loop (init, push iterations, zero-indeg
    short-circuit) runs in ONE shard_map program — no host round trips.
    """
    alpha_f = jnp.float32(alpha)
    n_pad = g.n_pad
    weighted = g.weighted

    def local(edge_src, edge_dst, edge_coef, out_deg, in_deg, node_mask,
              targets, rmax):
        # edge_src/dst[/coef]: [E_local] src-sorted chunk; targets: [T_local]
        deg_f = out_deg.astype(jnp.float32)
        inv_deg = jnp.where(out_deg > 0, 1.0 / jnp.maximum(deg_f, 1.0), 0.0)
        tgt_onehot = jax.nn.one_hot(targets, n_pad, dtype=jnp.float32).T
        p0 = jnp.zeros_like(tgt_onehot)                 # [n_pad, T_local]
        valid = (node_mask > 0)[:, None]

        def frontier(r_):
            return (r_ > rmax) & valid

        def cond(state):
            _, r_, it = state
            any_local = jnp.any(frontier(r_))
            any_all = jax.lax.pmax(any_local.astype(jnp.int32), "data") > 0
            return (it < max_sweeps) & any_all

        def body(state):
            p_, r_, it = state
            a = jnp.where(frontier(r_), r_, 0.0)
            p_ = p_ + alpha_f * a
            rem = (1.0 - alpha_f) * a
            # reverse step: gather residue at edge destinations, reduce by
            # source — the local chunk contributes a partial node vector,
            # one psum over 'graph' completes it
            contrib = jnp.take(rem, edge_dst, axis=0)   # [E_local, T_local]
            if weighted:
                contrib = contrib * edge_coef[:, None]
            pulled_local = jax.ops.segment_sum(
                contrib, edge_src, num_segments=n_pad,
                indices_are_sorted=True,
            )
            pulled = jax.lax.psum(pulled_local, "graph")
            if not weighted:
                pulled = pulled * inv_deg[:, None]
            r_ = r_ - a + pulled
            return p_, r_, it + 1

        p_f, _, _ = jax.lax.while_loop(
            cond, body, (p0, tgt_onehot, jnp.int32(0))
        )
        # zero-in-degree target short-circuit (Backward_Search.java:46-49)
        deg_t = jnp.take(in_deg, targets)[None, :]
        p_f = jnp.where(deg_t == 0, tgt_onehot, p_f)
        return p_f.T                                    # [T_local, n_pad]

    edge_specs = (P("graph"), P("graph"))
    if weighted:
        edge_specs = edge_specs + (P("graph"),)
        fn = local
    else:
        def fn(edge_src, edge_dst, out_deg, in_deg, node_mask, targets,
               rmax):
            return local(edge_src, edge_dst, None, out_deg, in_deg,
                         node_mask, targets, rmax)

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=edge_specs + (
            P(), P(), P(),                # out_deg, in_deg, node_mask
            P("data"),                    # targets
            P(),                          # rmax scalar
        ),
        out_specs=P("data", None),        # reserve rows
        check_vma=False,
    )
    return jax.jit(mapped)


class ShardedBackwardSearch:
    """Drop-in for :class:`ppr_tpu.models.backward_search.BackwardSearch`
    running the reverse-push sweep on a mesh."""

    def __init__(self, graph: Graph, alpha: float, rmax: float, *,
                 mesh: Mesh | None = None, max_sweeps: int = 10_000):
        self.graph = graph
        self.alpha = float(alpha)
        self.rmax = float(rmax)
        self.duration_ns = 0
        self.mesh = mesh if mesh is not None else make_mesh()
        self._data_size = dict(zip(self.mesh.axis_names,
                                   self.mesh.devices.shape))["data"]
        self._arrays = _shard_edges_bysrc(graph, self.mesh)
        self._tgt_spec = NamedSharding(self.mesh, P("data"))
        self._fn = make_sharded_backward_sweeps(
            self.mesh, graph, alpha=self.alpha, max_sweeps=max_sweeps
        )

    def whole_graph(self, targets: np.ndarray) -> np.ndarray:
        """pi(., t) for a batch of targets — rows indexed by target."""
        p = self.whole_graph_device(targets)  # accounts its own duration
        t0 = time.perf_counter_ns()
        out = np.asarray(p)[: len(targets)]
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def whole_graph_device(self, targets: np.ndarray) -> jax.Array:
        """Device-resident reserve; rows past ``len(targets)`` are padding
        (the batch is padded to a multiple of the 'data' axis — padding
        rows recompute target 0 and must be dropped by the consumer)."""
        t0 = time.perf_counter_ns()
        targets = np.asarray(targets, np.int32)
        b = len(targets)
        unit = self._data_size
        b_pad = max(unit, ((b + unit - 1) // unit) * unit)
        padded = np.concatenate(
            [targets, np.zeros(b_pad - b, np.int32)]
        ) if b_pad > b else targets
        tj = jax.device_put(jnp.asarray(padded), self._tgt_spec)
        a = self._arrays
        if self.graph.weighted:
            out = self._fn(a["edge_src"], a["edge_dst"], a["edge_coef"],
                           a["out_deg"], a["in_deg"], a["node_mask"], tj,
                           jnp.float32(self.rmax))
        else:
            out = self._fn(a["edge_src"], a["edge_dst"], a["out_deg"],
                           a["in_deg"], a["node_mask"], tj,
                           jnp.float32(self.rmax))
        out.block_until_ready()
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def get_duration(self) -> int:
        return self.duration_ns


def sharded_base_allpair(dataset, alpha: float, *, mesh: Mesh | None = None,
                         seed: int = 0, target_batch: int = 512):
    """A :class:`BaseAllPair` whose preprocessing sweep runs on the mesh."""
    from ..models.base_allpair import BaseAllPair

    mesh = mesh if mesh is not None else make_mesh()

    class _Sharded(BaseAllPair):
        name = BaseAllPair.name  # same store dir / result-file identity

        def _make_bws(self, threshold: float) -> ShardedBackwardSearch:
            return ShardedBackwardSearch(
                self.graph, self.alpha, rmax=threshold, mesh=mesh
            )

    return _Sharded(dataset, alpha, seed=seed, target_batch=target_batch)
