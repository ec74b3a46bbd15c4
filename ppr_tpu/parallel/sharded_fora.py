"""End-to-end FORA top-k on a device mesh: the sharded query engine.

Round-1 had sharded *kernels* plus a fixed-schedule demo step; this module
runs the actual flagship algorithm — the fused delta-annealing FORA top-k
loop of :func:`ppr_tpu.models.fora.annealed_topk_propagate`
(Fora_Topk.java:102-184 semantics: delta annealed /4 from 1/k to 1/n,
termination when the k-th reserve >= (1+eps')*delta) — end to end on a
(data, graph) mesh:

* ``data`` axis: query-batch rows (the ``[B]`` sources and the node-major
  ``[n_pad, B]`` reserve/residue state are column-sharded);
* ``graph`` axis: the dst-sorted COO edge list is 1D-partitioned into
  contiguous chunks; each device computes its chunk's gather + sorted
  segment-sum into a full-width node vector and a single
  ``lax.psum(..., "graph")`` per sweep completes the SpMV.

Everything — propagation sweeps, the annealing schedule, the (1+eps')*delta
stopping rule, the dangling-to-source mass return (Power_Method.java:74-80),
the dangling-source short-circuit (Fora_Topk.java:128-132) and the top-k
selection — runs inside ONE jitted ``shard_map`` program: no host round
trips, loop control identical on every device (termination scalars are
pmax/pmin-combined over the mesh so all data shards run the same decision
points as the single-device engine).

Cross-device loop-control invariant: ``settled``/``finished`` come from
``lax.pmax``/``lax.pmin`` reductions, so every device sees bitwise-identical
values and the while_loop trip counts agree — required for the psum inside
the body to rendezvous.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from .sharded import make_mesh


def _shard_edges(g: Graph, mesh: Mesh):
    """Device-put the dst-sorted COO view sharded over 'graph'; node arrays
    replicated. A contiguous chunk of globally dst-sorted edges is itself
    dst-sorted, so every local scatter is a sorted segment reduction."""
    edge_spec = NamedSharding(mesh, P("graph"))
    rep = NamedSharding(mesh, P())
    arrays = dict(
        edge_src_bydst=jax.device_put(g.edge_src_bydst, edge_spec),
        edge_dst_bydst=jax.device_put(g.edge_dst_bydst, edge_spec),
        out_deg=jax.device_put(g.out_deg, rep),
        node_mask=jax.device_put(g.node_mask, rep),
    )
    if g.weighted:
        arrays["edge_coef_bydst"] = jax.device_put(g.edge_coef_bydst,
                                                   edge_spec)
    return arrays


def make_sharded_annealed_topk(
    mesh: Mesh,
    g: Graph,
    *,
    alpha: float,
    k: int,
    kcap: int,
    delta0: float,
    min_delta: float,
    max_iters: int = 600,
):
    """Build the jitted end-to-end sharded FORA top-k program.

    Returns ``fn(sources, p_t, r_t, src_t, eps) -> (vals, ids, p_t, iters)``
    where ``sources`` is int32[B] sharded over 'data', the node-major state
    is ``[n_pad, B]`` column-sharded over 'data', and the outputs are
    ``vals/ids [B, kcap]`` (data-sharded) plus the final node-major reserve
    (for dense/test consumers) and the sweep count.
    """
    alpha_f = jnp.float32(alpha)
    n_pad = g.n_pad
    weighted = g.weighted

    def local(edge_src, edge_dst, edge_coef, out_deg, node_mask, sources,
              p_t, r_t, src_t, eps):
        # edge_src/dst[/coef]: [E_local] dst-sorted chunk;
        # p_t/r_t/src_t: [n_pad, B_local]; sources: [B_local]
        deg_f = out_deg.astype(jnp.float32)
        inv_deg = jnp.where(out_deg > 0, 1.0 / jnp.maximum(deg_f, 1.0), 0.0)
        is_dangling = ((out_deg == 0) & (node_mask > 0))[:, None]

        def row_done(p_, delta):
            thresh = (1.0 + eps) * delta
            return jnp.sum((p_ >= thresh).astype(jnp.int32), axis=0) >= k

        def cond(state):
            _, _, delta, finished, it = state
            return (it < max_iters) & ~finished

        def body(state):
            p_, r_, delta, finished, it = state
            p_ = p_ + alpha_f * r_
            rem = (1.0 - alpha_f) * r_
            # rem is replicated along 'graph', so the dangling-mass reduce is
            # local; the SpMV needs one psum to combine edge-chunk partials
            dang_mass = jnp.sum(
                jnp.where(is_dangling, rem, 0.0), axis=0, keepdims=True
            )
            if weighted:
                contrib = jnp.take(rem, edge_src, axis=0) \
                    * edge_coef[:, None]
            else:
                contrib = jnp.take(rem * inv_deg[:, None], edge_src, axis=0)
            pushed_local = jax.ops.segment_sum(
                contrib, edge_dst, num_segments=n_pad,
                indices_are_sorted=True,
            )
            pushed = jax.lax.psum(pushed_local, "graph")
            r_ = pushed + dang_mass * src_t

            # global decision scalars: identical on every device by
            # construction (pmax/pmin over 'data'; 'graph' copies already
            # agree because r_ is post-psum)
            rsum_max = jax.lax.pmax(jnp.max(jnp.sum(r_, axis=0)), "data")
            settled = rsum_max <= eps * delta
            done_local = jnp.all(row_done(p_, delta))
            done = jax.lax.pmin(done_local.astype(jnp.int32), "data") > 0
            done = settled & done
            at_floor = delta <= min_delta
            finished = done | (settled & at_floor)
            delta = jnp.where(
                settled & ~finished, jnp.maximum(min_delta, delta / 4.0),
                delta,
            )
            return p_, r_, delta, finished, it + 1

        p_t_f, r_t_f, _, _, iters = jax.lax.while_loop(
            cond, body,
            (p_t, r_t, jnp.float32(delta0), jnp.bool_(False), jnp.int32(0)),
        )

        # epilogue on device: dangling-source short-circuit
        # (Fora_Topk.java:128-132) + top-(kcap) selection, so only [B, kcap]
        # ever needs to cross the device->host link
        deg_src = jnp.take(out_deg, sources)[None, :]
        p_final = jnp.where(deg_src == 0, src_t, p_t_f)
        vals, ids = jax.lax.top_k(p_final.T, kcap)
        return vals, ids, p_final, iters

    edge_specs = (P("graph"), P("graph"))
    if weighted:
        edge_specs = edge_specs + (P("graph"),)
        fn = local
    else:
        def fn(edge_src, edge_dst, out_deg, node_mask, sources, p_t, r_t,
               src_t, eps):
            return local(edge_src, edge_dst, None, out_deg, node_mask,
                         sources, p_t, r_t, src_t, eps)

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=edge_specs + (
            P(), P(),                     # out_deg, node_mask (replicated)
            P("data"),                    # sources
            P(None, "data"), P(None, "data"), P(None, "data"),  # p, r, onehot
            P(),                          # eps scalar
        ),
        out_specs=(
            P("data", None), P("data", None),   # vals, ids
            P(None, "data"),                    # final reserve (node-major)
            P(),                                # iters
        ),
        check_vma=False,
    )
    return jax.jit(mapped)


class ShardedForaTopk:
    """Multi-device FORA top-k query engine (drop-in for the serving calls
    of :class:`ppr_tpu.models.fora.ForaTopk` on a mesh).

    Matches the single-device annealed engine's decision points exactly
    (same annealing schedule, same global stopping rule over the whole
    batch); results differ only by float reassociation across edge chunks.
    """

    name = "FORA-Topk-sharded"

    def __init__(self, dataset, alpha: float = 0.15, k: int = 10, *,
                 mesh: Mesh | None = None, max_iters: int = 600):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self.k = int(k)
        n = self.graph.n
        self.delta0 = 1.0 / self.k
        self.min_delta = 1.0 / n
        self.max_iters = max_iters
        self.mesh = mesh if mesh is not None else make_mesh()
        self._mesh_shape = dict(zip(self.mesh.axis_names,
                                    self.mesh.devices.shape))
        self._arrays = _shard_edges(self.graph, self.mesh)
        self._state_spec = NamedSharding(self.mesh, P(None, "data"))
        self._src_spec = NamedSharding(self.mesh, P("data"))
        self._programs: dict = {}

    # -- batching ----------------------------------------------------------
    def _pad_batch(self, sources: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad the batch to a multiple of the 'data' axis (and >= 8 rows,
        like models/fora._pad_sources)."""
        sources = np.asarray(sources, np.int32)
        b = len(sources)
        unit = self._mesh_shape["data"]
        b_pad = max(8, b)
        b_pad = ((b_pad + unit - 1) // unit) * unit
        if b_pad > b:
            sources = np.concatenate(
                [sources, np.zeros(b_pad - b, np.int32)]
            )
        return sources, b

    def _program(self, k: int, kcap: int):
        key = (k, kcap)
        if key not in self._programs:
            self._programs[key] = make_sharded_annealed_topk(
                self.mesh, self.graph, alpha=self.alpha, k=k, kcap=kcap,
                delta0=1.0 / k, min_delta=self.min_delta,
                max_iters=self.max_iters,
            )
        return self._programs[key]

    def _prepare_state(self, sources: np.ndarray):
        g = self.graph
        sources_j = jax.device_put(jnp.asarray(sources, jnp.int32),
                                   self._src_spec)
        onehot = jax.nn.one_hot(sources_j, g.n_pad, dtype=jnp.float32).T
        # rows whose source is dangling start (and stay) at zero; the
        # epilogue short-circuits them to e_s (Fora_Topk.java:128-132)
        deg_src = jnp.take(g.out_deg, sources_j)[None, :]
        r_t = jnp.where(deg_src == 0, 0.0, onehot)
        p_t = jnp.zeros_like(onehot)
        put = partial(jax.device_put, device=self._state_spec)
        return sources_j, put(p_t), put(r_t), put(onehot)

    # -- queries -----------------------------------------------------------
    def compute_topk_ids_batch(self, sources: np.ndarray, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: (values [B, K], ids [B, K]) numpy, selected on
        device across the mesh; only O(B*K) crosses device->host."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        eps = float(param) * 0.5          # eps' = eps/2 (Fora_Topk.java:110)
        sources_p, b = self._pad_batch(sources)
        kcap = int(kcap) if kcap else min(max(4 * k, k + 32), g.n_pad)
        kcap = min(kcap, g.n_pad)
        fn = self._program(k, kcap)
        sources_j, p_t, r_t, onehot = self._prepare_state(sources_p)
        vals, ids, _, _ = self._call(fn, sources_j, p_t, r_t, onehot, eps)
        return np.asarray(vals)[:b], np.asarray(ids)[:b]

    def compute_topk_batch(self, sources: np.ndarray, k: int,
                           param) -> np.ndarray:
        """Dense [B, n_pad] scores (test/verification path — O(B*n) host
        copy; prefer :meth:`compute_topk_ids_batch` for serving)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        eps = float(param) * 0.5
        sources_p, b = self._pad_batch(sources)
        fn = self._program(k, min(max(4 * k, k + 32), g.n_pad))
        sources_j, p_t, r_t, onehot = self._prepare_state(sources_p)
        _, _, p_final, _ = self._call(fn, sources_j, p_t, r_t, onehot, eps)
        return np.asarray(p_final.T)[:b]

    def _call(self, fn, sources_j, p_t, r_t, onehot, eps):
        a = self._arrays
        if self.graph.weighted:
            return fn(a["edge_src_bydst"], a["edge_dst_bydst"],
                      a["edge_coef_bydst"], a["out_deg"], a["node_mask"],
                      sources_j, p_t, r_t, onehot, jnp.float32(eps))
        return fn(a["edge_src_bydst"], a["edge_dst_bydst"], a["out_deg"],
                  a["node_mask"], sources_j, p_t, r_t, onehot,
                  jnp.float32(eps))
