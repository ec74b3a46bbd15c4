"""Mesh-backed drop-ins for every protocol algorithm (harness/CLI `--mesh`).

Without these, only FORA top-k (sharded_fora) and BASE (sharded_allpair)
could run on a device mesh; the preprocessing sweeps of FORA whole-graph
(Fora_Whole_Graph.java:82-146), Forward Push (Forward_Push.java:63-142),
Neo4j-method (Neo4j_Method.java:67-99) and Monte-Carlo
(Monte_Carlo.java:136-158) — the multi-hour offline jobs at amazon scale —
were single-device only, and the harness could not select the sharded
engines at all.

This module provides edge-sharded (1D 'graph' partition, node state
replicated; the throughput layout of :mod:`.sharded_fora`) variants of the
remaining compute kernels plus ``mesh_algo_obj`` — the mesh analogue of
``Algo_Conf.newAlgoObj`` (Gen_Util.java:66-97) the harness plumbs a mesh
through:

* forward push: frontier-masked sweeps with one psum per sweep, identical
  decision points to :func:`ppr_tpu.ops.push.forward_push_sweeps` (the
  frontier is computed on the post-psum replicated residue, so every device
  agrees);
* residual propagation to a target mass (FORA's deterministic completion,
  :func:`ppr_tpu.models.fora.residual_propagate` semantics);
* damped power iterations with a TRACED iteration count (one compiled
  program covers the whole Neo4j-method parameter sweep) + normalization;
* Monte-Carlo walks on the (data x graph)-sharded walker grid of
  :func:`ppr_tpu.parallel.sharded.make_sharded_walk_counts`.

The wrapper classes keep each algorithm's ``name``/``prep_dirname`` so
stores and result files are interchangeable with the single-device runs
(a store written on the mesh resumes on one device and vice versa).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from ..models import AlgoType
from ..models.fora import ForaWholeGraph
from ..models.forward_push import ForwardPush
from ..models.monte_carlo import MonteCarlo, mc_num_walks
from ..models.neo4j_method import Neo4jMethod
from .sharded import make_mesh, make_sharded_walk_counts, shard_graph
from .sharded_fora import ShardedForaTopk, _shard_edges


def _pad_rows(sources: np.ndarray, data_size: int,
              min_b: int = 8) -> tuple[np.ndarray, int]:
    """Pad a source batch to >= min_b rows and a multiple of the data axis
    (padding rows target node 0; consumers slice/mask them away)."""
    sources = np.asarray(sources, np.int32)
    b = len(sources)
    b_pad = ((max(min_b, b) + data_size - 1) // data_size) * data_size
    if b_pad > b:
        sources = np.concatenate([sources, np.zeros(b_pad - b, np.int32)])
    return sources, b


class _EdgeShardedKernels:
    """Shared edge-sharded propagation programs for one (mesh, graph).

    State is node-major ``[n_pad, B]`` column-sharded over 'data' (the
    proven sharded_fora layout: per-edge gathers read contiguous columns);
    edges ride the dst-sorted COO chunks so every local scatter is a sorted
    segment reduction completed by one ``psum`` over 'graph'.
    """

    def __init__(self, mesh: Mesh, g: Graph, alpha: float,
                 max_sweeps: int = 10_000):
        self.mesh = mesh
        self.g = g
        self.alpha = float(alpha)
        self.max_sweeps = max_sweeps
        self.mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.arrays = _shard_edges(g, mesh)
        self.state_spec = NamedSharding(mesh, P(None, "data"))
        self.src_spec = NamedSharding(mesh, P("data"))
        self._push = None
        self._propagate = None
        self._power = None

    # --- shared local helpers ---------------------------------------------
    def _edge_specs(self):
        specs = (P("graph"), P("graph"))
        if self.g.weighted:
            specs = specs + (P("graph"),)
        return specs

    def _edge_args(self):
        a = self.arrays
        args = [a["edge_src_bydst"], a["edge_dst_bydst"]]
        if self.g.weighted:
            args.append(a["edge_coef_bydst"])
        return args

    def _spmv_local(self, edge_src, edge_dst, edge_coef, inv_deg, rem_t):
        """One sharded SpMV: rem_t [n_pad, B_l] -> pushed [n_pad, B_l]."""
        if edge_coef is not None:
            contrib = jnp.take(rem_t, edge_src, axis=0) * edge_coef[:, None]
        else:
            contrib = jnp.take(rem_t * inv_deg[:, None], edge_src, axis=0)
        pushed = jax.ops.segment_sum(
            contrib, edge_dst, num_segments=self.g.n_pad,
            indices_are_sorted=True,
        )
        return jax.lax.psum(pushed, "graph")

    def prepare(self, sources: np.ndarray, *, init_shortcircuit: bool):
        """(sources_j, p_t, r_t, onehot_t) node-major, column-sharded.

        ``init_shortcircuit=True`` applies the dangling-source init of
        :func:`ppr_tpu.ops.push.forward_push_init` (reserve = e_s,
        residue = 0 when d_out(s) = 0, Forward_Push.java:70-74)."""
        g = self.g
        sources_j = jax.device_put(jnp.asarray(sources, jnp.int32),
                                   self.src_spec)
        onehot = jax.nn.one_hot(sources_j, g.n_pad, dtype=jnp.float32).T
        deg_src = jnp.take(g.out_deg, sources_j)[None, :]
        if init_shortcircuit:
            p_t = jnp.where(deg_src == 0, onehot, 0.0)
            r_t = jnp.where(deg_src == 0, 0.0, onehot)
        else:
            p_t = jnp.zeros_like(onehot)
            r_t = onehot
        put = lambda x: jax.device_put(x, self.state_spec)  # noqa: E731
        return sources_j, put(p_t), put(r_t), put(onehot)

    # --- programs -----------------------------------------------------------
    def push(self, p_t, r_t, onehot_t, rmax):
        """Frontier-masked push sweeps to the rmax fixpoint (the sharded
        :func:`forward_push_sweeps`). Returns (p_t, r_t, sweeps)."""
        if self._push is None:
            g, alpha = self.g, jnp.float32(self.alpha)
            max_sweeps = self.max_sweeps

            def local(*args):
                if g.weighted:
                    (edge_src, edge_dst, edge_coef, out_deg, node_mask,
                     p_t, r_t, onehot_t, rmax) = args
                else:
                    (edge_src, edge_dst, out_deg, node_mask,
                     p_t, r_t, onehot_t, rmax) = args
                    edge_coef = None
                deg_f = out_deg.astype(jnp.float32)
                inv_deg = jnp.where(out_deg > 0,
                                    1.0 / jnp.maximum(deg_f, 1.0), 0.0)
                is_dangling = ((out_deg == 0) & (node_mask > 0))[:, None]

                def frontier(r_):
                    gated = (out_deg > 0)[:, None] \
                        & (r_ >= rmax * deg_f[:, None])
                    dang = (out_deg == 0)[:, None] & (r_ > 0)
                    return (gated | dang) & (node_mask > 0)[:, None]

                def cond(state):
                    _, r_, it = state
                    any_active = jnp.any(frontier(r_)).astype(jnp.int32)
                    return (it < max_sweeps) & (
                        jax.lax.pmax(any_active, "data") > 0
                    )

                def body(state):
                    p_, r_, it = state
                    active = frontier(r_)
                    a = jnp.where(active, r_, 0.0)
                    p_ = p_ + alpha * a
                    dang_mass = jnp.sum(
                        jnp.where(is_dangling, a, 0.0), axis=0, keepdims=True
                    )
                    pushed = self._spmv_local(
                        edge_src, edge_dst, edge_coef, inv_deg,
                        (1.0 - alpha) * a,
                    )
                    r_ = r_ - a + pushed \
                        + (1.0 - alpha) * dang_mass * onehot_t
                    return p_, r_, it + 1

                return jax.lax.while_loop(
                    cond, body, (p_t, r_t, jnp.int32(0))
                )

            mapped = jax.shard_map(
                local, mesh=self.mesh,
                in_specs=self._edge_specs() + (
                    P(), P(),
                    P(None, "data"), P(None, "data"), P(None, "data"),
                    P(),
                ),
                out_specs=(P(None, "data"), P(None, "data"), P()),
                check_vma=False,
            )
            self._push = jax.jit(mapped)
        a = self.arrays
        return self._push(*self._edge_args(), a["out_deg"], a["node_mask"],
                          p_t, r_t, onehot_t, jnp.float32(rmax))

    def propagate(self, p_t, r_t, onehot_t, target):
        """Synchronous residue propagation until every row's rsum <= target
        (the sharded :func:`ppr_tpu.models.fora.residual_propagate`)."""
        if self._propagate is None:
            g, alpha = self.g, jnp.float32(self.alpha)
            max_sweeps = self.max_sweeps

            def local(*args):
                if g.weighted:
                    (edge_src, edge_dst, edge_coef, out_deg, node_mask,
                     p_t, r_t, onehot_t, target) = args
                else:
                    (edge_src, edge_dst, out_deg, node_mask,
                     p_t, r_t, onehot_t, target) = args
                    edge_coef = None
                inv_deg = jnp.where(
                    out_deg > 0,
                    1.0 / jnp.maximum(out_deg.astype(jnp.float32), 1.0), 0.0,
                )
                is_dangling = ((out_deg == 0) & (node_mask > 0))[:, None]

                def cond(state):
                    _, r_, it = state
                    rmax_local = jnp.max(jnp.sum(r_, axis=0))
                    return (it < max_sweeps) & (
                        jax.lax.pmax(rmax_local, "data") > target
                    )

                def body(state):
                    p_, r_, it = state
                    p_ = p_ + alpha * r_
                    rem = (1.0 - alpha) * r_
                    dang_mass = jnp.sum(
                        jnp.where(is_dangling, rem, 0.0), axis=0,
                        keepdims=True,
                    )
                    pushed = self._spmv_local(edge_src, edge_dst, edge_coef,
                                              inv_deg, rem)
                    return p_, pushed + dang_mass * onehot_t, it + 1

                return jax.lax.while_loop(
                    cond, body, (p_t, r_t, jnp.int32(0))
                )

            mapped = jax.shard_map(
                local, mesh=self.mesh,
                in_specs=self._edge_specs() + (
                    P(), P(),
                    P(None, "data"), P(None, "data"), P(None, "data"),
                    P(),
                ),
                out_specs=(P(None, "data"), P(None, "data"), P()),
                check_vma=False,
            )
            self._propagate = jax.jit(mapped)
        a = self.arrays
        return self._propagate(*self._edge_args(), a["out_deg"],
                               a["node_mask"], p_t, r_t, onehot_t,
                               jnp.float32(target))

    def power_iterations(self, onehot_t, damping: float, iterations):
        """x_{t+1} = (1-d) e_s + d P^T x_t, ``iterations`` (TRACED — one
        program per mesh covers the whole sweep array) times, then
        sum-normalized (Neo4j_Method.java:73-99 semantics)."""
        if self._power is None:
            g = self.g
            d = jnp.float32(damping)

            def local(*args):
                if g.weighted:
                    (edge_src, edge_dst, edge_coef, out_deg,
                     onehot_t, iters) = args
                else:
                    edge_src, edge_dst, out_deg, onehot_t, iters = args
                    edge_coef = None
                inv_deg = jnp.where(
                    out_deg > 0,
                    1.0 / jnp.maximum(out_deg.astype(jnp.float32), 1.0), 0.0,
                )
                base = (1.0 - d) * onehot_t

                def body(_, x):
                    return base + d * self._spmv_local(
                        edge_src, edge_dst, edge_coef, inv_deg, x
                    )

                x = jax.lax.fori_loop(0, iters, body, base)
                # x is replicated over 'graph' (post-psum), so the
                # normalization total is a local full-height reduce
                total = jnp.sum(x, axis=0, keepdims=True)
                return jnp.where(total > 0, x / total, x)

            mapped = jax.shard_map(
                local, mesh=self.mesh,
                in_specs=self._edge_specs() + (
                    P(), P(None, "data"), P(),
                ),
                out_specs=P(None, "data"),
                check_vma=False,
            )
            self._power = jax.jit(mapped)
        a = self.arrays
        return self._power(*self._edge_args(), a["out_deg"], onehot_t,
                           jnp.int32(iterations))


class MeshForwardPush(ForwardPush):
    """Forward Push whose sweeps run edge-sharded on a mesh."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh, seed: int = 0):
        super().__init__(dataset, alpha, seed=seed)
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        sources_p, _ = _pad_rows(sources, self._kern.mesh_shape["data"])
        _, p_t, r_t, onehot_t = self._kern.prepare(sources_p,
                                                   init_shortcircuit=True)
        p_t, r_t, _ = self._kern.push(p_t, r_t, onehot_t, float(param))
        self._last_rsum_dev = jnp.sum(r_t, axis=0)
        return p_t.T

    def compute_whole_graph_batch(self, sources: np.ndarray,
                                  param) -> np.ndarray:
        return np.asarray(
            self.compute_whole_graph_device(sources, param)
        )[: len(sources)]


class MeshNeo4jMethod(Neo4jMethod):
    """Neo4j-method power iterations on a mesh (one program per mesh —
    the iteration count is traced)."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh, seed: int = 0):
        super().__init__(dataset, alpha, seed=seed)
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        sources_p, _ = _pad_rows(sources, self._kern.mesh_shape["data"])
        _, _, _, onehot_t = self._kern.prepare(sources_p,
                                               init_shortcircuit=False)
        x = self._kern.power_iterations(onehot_t, 1.0 - self.alpha,
                                        int(param))
        return x.T

    def compute_whole_graph_batch(self, sources: np.ndarray,
                                  param) -> np.ndarray:
        return np.asarray(
            self.compute_whole_graph_device(sources, param)
        )[: len(sources)]


class MeshForaWholeGraph(ForaWholeGraph):
    """FORA whole-graph on a mesh: adaptive sharded push rounds + sharded
    deterministic residual completion (the spmv path; for the randomized
    walks estimator on a node-sharded mesh use
    :class:`ppr_tpu.parallel.node_sharded_fora.NodeShardedForaWholeGraph`)."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh,
                 delta: float | None = None, pfail: float | None = None,
                 seed: int = 0, max_push_rounds: int = 30):
        super().__init__(dataset, alpha, delta=delta, pfail=pfail, seed=seed,
                         max_push_rounds=max_push_rounds, completion="spmv")
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)
        self._push_warmed = False

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        import time

        eps = float(param)
        g = self.graph
        sources_p, _ = _pad_rows(sources, self._kern.mesh_shape["data"])
        b = len(sources_p)
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        rmax = eps * math.sqrt(self.delta / 3.0 / m / ln_term) \
            / (1.0 - self.alpha)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta
        target = eps * self.delta

        _, p_t, r_t, onehot_t = self._kern.prepare(sources_p,
                                                   init_shortcircuit=True)
        # untimed warmup: the first push call's jit compile must never
        # pollute the push/completion balance
        # — same guard as the single-device engine's _WARMED_PUSH_SHAPES
        if not self._push_warmed:
            jax.block_until_ready(
                self._kern.push(p_t, r_t, onehot_t, rmax)
            )
            self._push_warmed = True
        # adaptive push rounds on the same wall-clock balance as the
        # single-device engine (Fora_Whole_Graph.java:93-103)
        rsum_local, push_ns, rounds = 1.0, 0.0, 0
        while (
            push_ns < min(
                self.avg_rand_walk_time_ns * rsum_local * omega,
                self._spmv_completion_ns(rsum_local, target, b),
            )
            and rounds < self.max_push_rounds
        ):
            t0 = time.perf_counter_ns()
            p_t, r_t, _ = self._kern.push(p_t, r_t, onehot_t, rmax)
            jax.block_until_ready(r_t)
            push_ns += (time.perf_counter_ns() - t0) / b
            rsum_local = float(np.asarray(
                jnp.sum(r_t, axis=0).mean()
            )) * (1.0 - self.alpha)
            rmax /= 2.0
            rounds += 1

        p_t, r_t, _ = self._kern.propagate(p_t, r_t, onehot_t, target)
        return p_t.T

    def compute_whole_graph_batch(self, sources: np.ndarray,
                                  param) -> np.ndarray:
        return np.asarray(
            self.compute_whole_graph_device(sources, param)
        )[: len(sources)]


class MeshMonteCarlo(MonteCarlo):
    """Monte-Carlo walks on the (data x graph)-sharded walker grid."""

    def __init__(self, dataset, alpha: float, *,
                 mesh: Mesh, delta: float | None = None,
                 pfail: float | None = None, seed: int = 0,
                 max_walk_batch: int = 4_000_000):
        super().__init__(dataset, alpha, delta=delta, pfail=pfail, seed=seed,
                         max_walk_batch=max_walk_batch)
        self.mesh = mesh
        self.mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        self._gs = shard_graph(self.graph, mesh)
        # weighted graphs use the alias-table kernel variant — the same
        # exact weight-proportional law as the single-device engine
        self._walk = make_sharded_walk_counts(
            mesh, self.alpha, weighted=self.graph.weighted
        )
        self._walker_spec = NamedSharding(mesh, P("data", "graph"))

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        eps = float(param)
        omega = mc_num_walks(eps, self.delta, self.pfail)
        sources_p, _ = _pad_rows(sources, self.mesh_shape["data"])
        b = len(sources_p)
        unit = self.mesh_shape["graph"]
        sources_j = jnp.asarray(sources_p, jnp.int32)
        gs = self._gs
        # lane budget: the single-device engine caps each dispatch at
        # max_walk_batch walkers; the padded [b, w] grid must respect the
        # same budget, so big omegas run in lane PASSES (pass j covers
        # lanes [j*w_pad, (j+1)*w_pad); weights mask lanes >= omega)
        w_cap = max(unit, self.max_walk_batch // max(b, 1))
        w_pad = max(unit, 1 << max(4, math.ceil(math.log2(
            max(min(omega, w_cap), 1)
        ))))
        counts = None
        for lane0 in range(0, omega, w_pad):
            starts = jax.device_put(
                jnp.broadcast_to(sources_j[:, None], (b, w_pad)),
                self._walker_spec,
            )
            lane = lane0 + jnp.arange(w_pad, dtype=jnp.int32)[None, :]
            weights = jax.device_put(
                jnp.broadcast_to(
                    jnp.where(lane < omega, 1.0 / omega, 0.0), (b, w_pad)
                ).astype(jnp.float32),
                self._walker_spec,
            )
            if self.graph.weighted:
                c = self._walk(gs.indptr, gs.indices, gs.alias_prob,
                               gs.alias_other, gs.out_deg, starts, weights,
                               self.next_key())
            else:
                c = self._walk(gs.indptr, gs.indices, gs.out_deg, starts,
                               weights, self.next_key())
            counts = c if counts is None else counts + c
        return counts

    def compute_whole_graph_batch(self, sources: np.ndarray,
                                  param) -> np.ndarray:
        return np.asarray(
            self.compute_whole_graph_device(sources, param)
        )[: len(sources)]


def mesh_algo_obj(algo_type: AlgoType, dataset, alpha: float, k: int, *,
                  mesh: Mesh | None = None, seed: int = 0):
    """Mesh analogue of ``AlgoConf.new_algo_obj`` (Gen_Util.java:66-97):
    the same theory-derived parameters, kernels on the (data, graph) mesh."""
    from .sharded_allpair import sharded_base_allpair

    mesh = mesh if mesh is not None else make_mesh()
    if algo_type == AlgoType.BASE_WHOLE_GRAPH:
        return sharded_base_allpair(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.FORA_TOPK:
        return ShardedForaTopk(dataset, alpha=alpha, k=k, mesh=mesh)
    if algo_type == AlgoType.FORA_WHOLE_GRAPH:
        return MeshForaWholeGraph(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.FWDPUSH:
        return MeshForwardPush(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.NEO4J_METHOD:
        return MeshNeo4jMethod(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.MC:
        return MeshMonteCarlo(dataset, alpha, mesh=mesh, seed=seed)
    raise ValueError(f"no mesh variant for {algo_type}")
