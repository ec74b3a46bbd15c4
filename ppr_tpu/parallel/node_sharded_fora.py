"""Node-sharded END-TO-END FORA top-k: the O(n/S)-memory query engine.

:class:`ppr_tpu.parallel.sharded_fora.ShardedForaTopk` shards *edges* and
replicates the node dimension of the state on every device — right for
throughput, wrong once ``[B, n]`` outgrows one device's HBM. This module
composes the same delta-annealing FORA top-k loop
(:func:`ppr_tpu.models.fora.annealed_topk_propagate`; Fora_Topk.java:102-184
semantics — delta annealed /4 from 1/k to 1/n, termination when the k-th
reserve >= (1+eps')*delta) over the 2D ring-exchange node partition of
:mod:`ppr_tpu.parallel.node_sharded`:

* nodes are split into contiguous ranges of ``n_pad/S`` along the 'graph'
  mesh axis; each device owns the [B_local, n_local] reserve/residue chunk
  for its range plus the (dst-shard, src-shard) edge blocks whose dst falls
  in it (:func:`partition_edges_by_dst_src`);
* one sweep circulates the residue chunks around the 'graph' ring (S-1
  ``ppermute`` hops); at hop t device d holds shard (d-t) mod S's chunk and
  accumulates that block's gather + sorted segment-sum into its local
  destinations — per-device transient state stays O(n/S);
* annealing/termination scalars are ``psum``/``pmax``/``pmin``-combined over
  BOTH mesh axes, so every device runs bitwise-identical while_loop trip
  counts (required for the ring collectives to rendezvous);
* the epilogue is a DISTRIBUTED top-k: each node shard takes its local
  ``lax.top_k`` candidates, an ``all_gather`` along 'graph' concatenates the
  ``[S * kc]`` candidate columns in shard order, and a second ``top_k``
  merges them. Concatenation in ascending-shard order + local top_k's
  ascending-index tie order reproduce the single-device ``lax.top_k`` tie
  semantics exactly (ties resolve to the lowest node id), so the
  tie-expanded result sets match the reference's quickselect-with-ties
  retrieval (Forward_Push.java:413-429).

Everything — state init from the source ids, the annealed propagation loop,
the dangling-to-source mass return (Power_Method.java:74-80), the
dangling-source short-circuit (Fora_Topk.java:128-132) and the distributed
selection — runs inside ONE jitted ``shard_map`` program; no [B, n_pad]
array is ever materialized on any single device.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.csr import Graph
from ..ops.walk import default_max_steps, expand_walkers
from .node_sharded import (
    make_node_sharded_propagate_ring,
    partition_csr_by_node,
    partition_edges_by_dst_src,
)
from .sharded import make_mesh


def _put_blocks(g: Graph, mesh: Mesh, col_perm: np.ndarray | None = None):
    """Device-put the (dst-shard, src-shard) edge blocks + node-range arrays
    sharded along 'graph'. Returns (arrays dict, n_local).

    ``col_perm`` ([S, n_local], ``col_perm[s, j]`` = the original local
    column of shard *s* sitting at PERMUTED position *j*) remaps every
    edge block's src indices into the permuted basis: the frontier ring
    circulates degree-sorted chunks, and pre-mapping the edge gather
    indices here means the hop path pays zero extra permutation work."""
    s_graph = dict(zip(mesh.axis_names, mesh.devices.shape))["graph"]
    src_b, dst_b, mask_b, coef_b, n_local = partition_edges_by_dst_src(
        g, s_graph
    )
    if col_perm is not None:
        inv = np.empty_like(col_perm)                     # [S, n_local]
        np.put_along_axis(inv, col_perm,
                          np.broadcast_to(np.arange(n_local),
                                          col_perm.shape), axis=1)
        src_b = np.asarray(src_b)
        # block [s_dst, s_src] holds src indices local to shard s_src
        for s_src in range(s_graph):
            src_b[:, s_src, :] = inv[s_src][src_b[:, s_src, :]]
    block_spec = NamedSharding(mesh, P("graph", None, None))
    node_spec = NamedSharding(mesh, P("graph"))
    inv_deg = jnp.where(
        g.out_deg > 0, 1.0 / jnp.maximum(g.out_deg.astype(jnp.float32), 1.0),
        0.0,
    )
    arrays = dict(
        src=jax.device_put(jnp.asarray(src_b), block_spec),
        dst=jax.device_put(jnp.asarray(dst_b), block_spec),
        mask=jax.device_put(jnp.asarray(mask_b), block_spec),
        coef=(jax.device_put(jnp.asarray(coef_b), block_spec)
              if coef_b is not None else None),
        inv_deg=jax.device_put(inv_deg, node_spec),
        dangling=jax.device_put(
            ((g.out_deg == 0) & (g.node_mask > 0)).astype(jnp.float32),
            node_spec,
        ),
        out_deg=jax.device_put(g.out_deg, node_spec),
    )
    return arrays, n_local


def make_node_sharded_annealed_topk(
    mesh: Mesh,
    g: Graph,
    *,
    alpha: float,
    k: int,
    kcap: int,
    delta0: float,
    min_delta: float,
    max_iters: int = 600,
    ring_dtype: str = "f32",
    frontier_blocks: int | None = None,
    num_blocks: int = 64,
    block_order: str = "degree",
):
    """Build the jitted end-to-end node-sharded FORA top-k program.

    Returns ``(fn, arrays)`` where ``fn(...block/node arrays..., sources,
    eps) -> (vals, ids, p_local, iters)``: ``sources`` int32[B] sharded over
    'data'; ``vals``/``ids`` are ``[B, kcap]`` data-sharded (replicated over
    'graph'); ``p_local`` is the final reserve sharded (data, graph) —
    [B_local, n_local] per device; ``iters`` the sweep count.

    ``ring_dtype="bf16"`` halves the ring's link traffic: the circulating
    residue chunk is cast to bfloat16 for each ``ppermute`` hop and
    widened back to f32 on arrival (accumulation and all decision scalars
    stay f32). Per hop this rounds the transported values once (relative
    error 2^-8); a chunk travels at most S-1 hops, and FORA's stopping
    rules are threshold-based on eps*delta-scale masses, so the id sets
    are unchanged in practice (equality-tested on the virtual mesh,
    tests/test_ring_bf16.py). The comm model prices it
    (parallel/comm_model.py: payload_bytes=2).

    ``frontier_blocks=C`` turns on the
    FRONTIER-COMPACTED ring: each device splits its ``n_local`` chunk
    columns into ``num_blocks`` contiguous blocks, selects the ``C``
    blocks carrying the most residue mass this sweep, pushes ONLY those
    (the unselected residue stays in place — exact deferral, no mass is
    ever dropped), and circulates just the compacted
    ``[B_l, C*blk]`` values + ``[C]`` block ids. Wire bytes shrink by
    ``C/num_blocks``; correctness is unconditional because push order is
    free in forward-push semantics (the reference's own queue pushes in
    arbitrary order, Forward_Push.java:60-88) and the stopping rule reads
    the FULL residue sum including deferred mass. Each sweep pushes the
    top-C blocks ≥ C/NB of the remaining mass, so convergence stays
    geometric; with ``C = num_blocks`` the arithmetic is identical to the
    dense ring (equality-tested, tests/test_frontier_ring.py). Residue
    mass on power-law graphs concentrates on hub blocks
    (scripts/ring_occupancy.py measures the coverage curve), so small C
    costs few extra sweeps while dividing the link bytes.

    ``block_order="degree"`` (frontier mode's default) permutes each
    shard's chunk columns by descending in-degree before blocking:
    residue mass concentrates on high-in-degree nodes (they receive the
    pushes), but node ids scatter hubs across CONTIGUOUS blocks, which is
    why id-ordered blocks measure poor mass coverage (about half the mass
    in the top eighth of the blocks on the 65k headline graph, so the
    sweep count more than doubles). Degree-sorting packs the
    hubs into the leading blocks. The edge gather indices are pre-mapped
    into the permuted basis at build time (:func:`_put_blocks`), so hops
    pay nothing extra; ``block_order="id"`` keeps contiguous blocks.
    """
    alpha_f = jnp.float32(alpha)
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    s_graph = mesh_shape["graph"]
    col_perm = None
    if frontier_blocks is not None and block_order == "degree":
        n_local_pre = g.n_pad // s_graph
        in_deg = np.bincount(np.asarray(g.edge_dst_bydst),
                             minlength=g.n_pad)[: g.n_pad]
        col_perm = np.stack([
            np.argsort(-in_deg[s * n_local_pre:(s + 1) * n_local_pre],
                       kind="stable").astype(np.int32)
            for s in range(s_graph)
        ])
    elif block_order not in ("degree", "id"):
        raise ValueError(f"block_order must be 'degree' or 'id', got "
                         f"{block_order!r}")
    arrays, n_local = _put_blocks(g, mesh, col_perm=col_perm)
    if col_perm is not None:
        arrays["colperm"] = jax.device_put(
            jnp.asarray(col_perm.reshape(-1)),
            NamedSharding(mesh, P("graph")),
        )
    weighted = arrays["coef"] is not None
    perm = [(i, (i + 1) % s_graph) for i in range(s_graph)]
    if ring_dtype not in ("f32", "bf16"):
        raise ValueError(f"ring_dtype must be 'f32' or 'bf16', got "
                         f"{ring_dtype!r}")

    def _rot(x):
        if s_graph <= 1:
            return x
        if ring_dtype == "bf16":
            # wire bytes are bf16; the fori_loop carry stays f32
            return jax.lax.ppermute(
                x.astype(jnp.bfloat16), "graph", perm
            ).astype(jnp.float32)
        return jax.lax.ppermute(x, "graph", perm)

    # frontier-compacted ring geometry (static). NB block-mass top-C
    # selection is per-device; blk*NB >= n_local with zero padding.
    NB = max(1, min(int(num_blocks), n_local))
    blk = -(-n_local // NB)               # ceil
    C = None
    if frontier_blocks is not None:
        C = max(1, min(int(frontier_blocks), NB))

    def _rot_pair(carry):
        comp_, sel_ = carry
        if s_graph <= 1:
            return comp_, sel_
        if ring_dtype == "bf16":
            comp_ = jax.lax.ppermute(
                comp_.astype(jnp.bfloat16), "graph", perm
            ).astype(jnp.float32)
        else:
            comp_ = jax.lax.ppermute(comp_, "graph", perm)
        return comp_, jax.lax.ppermute(sel_, "graph", perm)

    def local(src_e, dst_e, mask_e, coef_e, inv_deg_l, dangling_l,
              out_deg_l, perm_l, sources, eps):
        # src_e/dst_e/mask_e[/coef_e]: [1, S, E] this dst-shard's blocks;
        # inv_deg_l/dangling_l/out_deg_l: [n_local]; sources: [B_local];
        # perm_l: [n_local] degree-sorted column order (frontier) or None
        my = jax.lax.axis_index("graph").astype(jnp.int32)
        base = my * n_local
        b_l = sources.shape[0]

        # --- state init, all O(n/S): one-hot restricted to the local range
        local_ids = base + jnp.arange(n_local, dtype=jnp.int32)
        onehot_l = (sources[:, None] == local_ids[None, :]).astype(
            jnp.float32
        )
        src_in = (sources >= base) & (sources < base + n_local)
        deg_src_l = jnp.where(
            src_in,
            jnp.take(out_deg_l, jnp.clip(sources - base, 0, n_local - 1)),
            0,
        )
        deg_src = jax.lax.psum(deg_src_l, "graph")          # [B_local]
        # dangling-source rows start (and stay) at zero; the epilogue
        # short-circuits them to e_s (Fora_Topk.java:128-132)
        r0 = jnp.where(deg_src[:, None] == 0, 0.0, onehot_l)
        p0 = jnp.zeros_like(onehot_l)

        def _block_gather_acc(dense_chunk, s, acc):
            """Shared hop body: this dst-shard's block-s edge contributions
            accumulated from a dense [B_l, n_local] source chunk."""
            src_t = jax.lax.dynamic_index_in_dim(src_e[0], s, 0, False)
            dst_t = jax.lax.dynamic_index_in_dim(dst_e[0], s, 0, False)
            msk_t = jax.lax.dynamic_index_in_dim(mask_e[0], s, 0, False)
            contrib = jnp.take(dense_chunk, src_t, axis=-1) * msk_t
            if weighted:
                cf_t = jax.lax.dynamic_index_in_dim(coef_e[0], s, 0, False)
                contrib = contrib * cf_t
            add = jax.ops.segment_sum(
                jnp.moveaxis(contrib, -1, 0), dst_t,
                num_segments=n_local, indices_are_sorted=True,
            )
            return acc + jnp.moveaxis(add, 0, -1)

        def sweep(p_l, r_l):
            """One propagation sweep over the ring (O(n/S) transients)."""
            p_l = p_l + alpha_f * r_l
            rem = (1.0 - alpha_f) * r_l
            dang_mass = jax.lax.psum(
                jnp.sum(rem * dangling_l[None, :], axis=-1, keepdims=True),
                "graph",
            )
            chunk = rem if weighted else rem * inv_deg_l[None, :]

            def hop(t, carry):
                chunk_, acc = carry
                s = jax.lax.rem(my - t + s_graph, s_graph)
                acc = _block_gather_acc(chunk_, s, acc)
                # rotate AFTER use; the final hop's rotation is skipped
                # (both cond branches are collective-free when S == 1)
                chunk_ = jax.lax.cond(
                    t < s_graph - 1, _rot, lambda c: c, chunk_
                )
                return chunk_, acc

            _, acc = jax.lax.fori_loop(
                0, s_graph, hop, (chunk, jnp.zeros_like(r_l))
            )
            return p_l, acc + dang_mass * onehot_l

        def sweep_frontier(p_l, r_l):
            """Frontier-compacted sweep: push only the top-C residue-mass
            column blocks; circulate [B_l, C*blk] values + [C] block ids.
            Unselected residue defers in place (exact — see factory
            docstring); wire bytes shrink C/NB per hop."""
            b_l = r_l.shape[0]
            pad = NB * blk - n_local
            # block mass / payload in the (optionally degree-sorted)
            # permuted basis; edge src indices are pre-mapped to it
            r_basis = (jnp.take(r_l, perm_l, axis=-1)
                       if perm_l is not None else r_l)
            r_pad = jnp.pad(r_basis, ((0, 0), (0, pad)))
            mass = jnp.sum(r_pad.reshape(b_l, NB, blk), axis=(0, 2))  # [NB]
            _, sel = jax.lax.top_k(mass, C)
            sel = jnp.sort(sel).astype(jnp.int32)
            m_blk = jnp.zeros((NB,), jnp.float32).at[sel].set(1.0)
            m_flat = jnp.repeat(m_blk, blk)[:n_local]       # permuted basis
            if perm_l is not None:
                M = jnp.zeros((n_local,), jnp.float32) \
                    .at[perm_l].set(m_flat)[None, :]        # original basis
            else:
                M = m_flat[None, :]
            r_push = r_l * M
            p_l = p_l + alpha_f * r_push
            rem = (1.0 - alpha_f) * r_push
            dang_mass = jax.lax.psum(
                jnp.sum(rem * dangling_l[None, :], axis=-1, keepdims=True),
                "graph",
            )
            chunk = rem if weighted else rem * inv_deg_l[None, :]
            if perm_l is not None:
                chunk = jnp.take(chunk, perm_l, axis=-1)
            comp = jnp.pad(chunk, ((0, 0), (0, pad))) \
                .reshape(b_l, NB, blk)[:, sel, :]           # [B_l, C, blk]

            def hop(t, carry):
                comp_, sel_, acc = carry
                s = jax.lax.rem(my - t + s_graph, s_graph)
                dense = (
                    jnp.zeros((b_l, NB, blk), jnp.float32)
                    .at[:, sel_, :].set(comp_)
                    .reshape(b_l, NB * blk)[:, :n_local]
                )
                acc = _block_gather_acc(dense, s, acc)
                comp_, sel_ = jax.lax.cond(
                    t < s_graph - 1, _rot_pair, lambda c: c, (comp_, sel_)
                )
                return comp_, sel_, acc

            _, _, acc = jax.lax.fori_loop(
                0, s_graph, hop, (comp, sel, jnp.zeros_like(r_l))
            )
            r_new = r_l * (1.0 - M) + acc + dang_mass * onehot_l
            return p_l, r_new

        if C is not None:
            sweep = sweep_frontier

        def cond(state):
            _, _, delta, finished, it = state
            return (it < max_iters) & ~finished

        def body(state):
            p_, r_, delta, finished, it = state
            p_, r_ = sweep(p_, r_)

            # global decision scalars: identical on every device by
            # construction (psum over 'graph' completes row totals; pmax /
            # pmin fold the 'data' groups)
            rsum_row = jax.lax.psum(jnp.sum(r_, axis=-1), "graph")
            rsum_max = jax.lax.pmax(jnp.max(rsum_row), "data")
            settled = rsum_max <= eps * delta
            thresh = (1.0 + eps) * delta
            cnt = jax.lax.psum(
                jnp.sum((p_ >= thresh).astype(jnp.int32), axis=-1), "graph"
            )
            done_local = jnp.all(cnt >= k)
            done = jax.lax.pmin(done_local.astype(jnp.int32), "data") > 0
            done = settled & done
            at_floor = delta <= min_delta
            finished = done | (settled & at_floor)
            delta = jnp.where(
                settled & ~finished, jnp.maximum(min_delta, delta / 4.0),
                delta,
            )
            return p_, r_, delta, finished, it + 1

        p_f, _, _, _, iters = jax.lax.while_loop(
            cond, body,
            (p0, r0, jnp.float32(delta0), jnp.bool_(False), jnp.int32(0)),
        )

        # --- epilogue: dangling-source short-circuit + DISTRIBUTED top-k
        p_f = jnp.where(deg_src[:, None] == 0, onehot_l, p_f)
        kc = min(kcap, n_local)
        vals_l, ids_l = jax.lax.top_k(p_f, kc)              # [B_l, kc]
        ids_g = ids_l + base
        # ascending-shard concatenation keeps global tie order = node-id
        # order (each shard's candidates are already id-ordered within ties)
        vals_all = jax.lax.all_gather(vals_l, "graph", axis=1, tiled=True)
        ids_all = jax.lax.all_gather(ids_g, "graph", axis=1, tiled=True)
        km = min(kcap, vals_all.shape[-1])
        vals, sel = jax.lax.top_k(vals_all, km)
        ids = jnp.take_along_axis(ids_all, sel, axis=1)
        return vals, ids, p_f, iters

    use_perm = col_perm is not None

    def fn(*args):
        args = list(args)
        src_e, dst_e, mask_e = args[:3]
        i = 3
        coef_e = args[i] if weighted else None
        i += int(weighted)
        inv_deg_l, dangling_l, out_deg_l = args[i:i + 3]
        i += 3
        perm_l = args[i] if use_perm else None
        i += int(use_perm)
        sources, eps = args[i:]
        return local(src_e, dst_e, mask_e, coef_e, inv_deg_l, dangling_l,
                     out_deg_l, perm_l, sources, eps)

    block_specs = (P("graph", None, None),) * (3 + int(weighted))

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=block_specs + (
            P("graph"), P("graph"), P("graph"),   # inv_deg, dangling, deg
        ) + ((P("graph"),) if use_perm else ()) + (
            P("data"),                            # sources
            P(),                                  # eps
        ),
        out_specs=(
            P("data", None), P("data", None),     # vals, ids
            P("data", "graph"),                   # final reserve (local)
            P(),                                  # iters
        ),
        check_vma=False,
    )
    return jax.jit(mapped), arrays


class NodeShardedForaTopk:
    """Node-sharded multi-device FORA top-k engine: O(n/S) state per device.

    Drop-in for :class:`ppr_tpu.parallel.sharded_fora.ShardedForaTopk`'s
    query surface; matches the single-device annealed engine's decision
    points exactly (same annealing schedule, same global stopping rule),
    differing only by float reassociation across shard blocks/collectives.
    """

    name = "FORA-Topk-node-sharded"

    def __init__(self, dataset, alpha: float = 0.15, k: int = 10, *,
                 mesh: Mesh | None = None, max_iters: int = 600,
                 ring_dtype: str = "f32", frontier_blocks: int | None = None,
                 num_blocks: int = 64, block_order: str = "degree"):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self.k = int(k)
        n = self.graph.n
        self.delta0 = 1.0 / self.k
        self.min_delta = 1.0 / n
        self.max_iters = max_iters
        self.ring_dtype = ring_dtype
        self.frontier_blocks = frontier_blocks
        self.num_blocks = num_blocks
        self.block_order = block_order
        self.mesh = mesh if mesh is not None else make_mesh()
        self._mesh_shape = dict(zip(self.mesh.axis_names,
                                    self.mesh.devices.shape))
        self.n_local = self.graph.n_pad // self._mesh_shape["graph"]
        self._src_spec = NamedSharding(self.mesh, P("data"))
        self._programs: dict = {}

    def _pad_batch(self, sources: np.ndarray) -> tuple[np.ndarray, int]:
        sources = np.asarray(sources, np.int32)
        b = len(sources)
        unit = self._mesh_shape["data"]
        b_pad = max(8, b)
        b_pad = ((b_pad + unit - 1) // unit) * unit
        if b_pad > b:
            sources = np.concatenate([sources, np.zeros(b_pad - b, np.int32)])
        return sources, b

    def _program(self, k: int, kcap: int):
        key = (k, kcap)
        if key not in self._programs:
            self._programs[key] = make_node_sharded_annealed_topk(
                self.mesh, self.graph, alpha=self.alpha, k=k, kcap=kcap,
                delta0=1.0 / k, min_delta=self.min_delta,
                max_iters=self.max_iters, ring_dtype=self.ring_dtype,
                frontier_blocks=self.frontier_blocks,
                num_blocks=self.num_blocks, block_order=self.block_order,
            )
        return self._programs[key]

    def _run(self, sources: np.ndarray, k: int, kcap: int, eps: float):
        fn, arrays = self._program(k, kcap)
        sources_j = jax.device_put(jnp.asarray(sources, jnp.int32),
                                   self._src_spec)
        args = [arrays["src"], arrays["dst"], arrays["mask"]]
        if arrays["coef"] is not None:
            args.append(arrays["coef"])
        args += [arrays["inv_deg"], arrays["dangling"], arrays["out_deg"]]
        if "colperm" in arrays:
            args.append(arrays["colperm"])
        args += [sources_j, jnp.float32(eps)]
        return fn(*args)

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
        vals, ids, _, _ = self._run(sources_p, k, kcap, eps)
        return np.asarray(vals)[:b], np.asarray(ids)[:b]

    def compute_topk_batch(self, sources: np.ndarray, k: int,
                           param) -> np.ndarray:
        """Dense [B, n_pad] scores (test/verification path — gathers the
        node-sharded reserve to the host; prefer compute_topk_ids_batch)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        eps = float(param) * 0.5
        sources_p, b = self._pad_batch(sources)
        kcap = min(max(4 * k, k + 32), g.n_pad)
        _, _, p_local, _ = self._run(sources_p, k, kcap, eps)
        return np.asarray(p_local)[:b]

    def final_state_shard_shape(self, batch: int) -> tuple[int, int]:
        """The per-device reserve shard shape — O(B/data, n/S) by design;
        tests assert it against the addressable shards of a live result."""
        unit = self._mesh_shape["data"]
        b_pad = ((max(8, batch) + unit - 1) // unit) * unit
        return (b_pad // unit, self.n_local)


# --------------------------------------------------------------------------
# Walks-mode completion: FORA whole-graph over the node-sharded partition
# --------------------------------------------------------------------------

def make_node_sharded_walk_totals(mesh: Mesh, g: Graph, alpha: float):
    """Per-device walker-count program: ``fn(r_local, omega) -> int32[D, S]``
    of each device's ``sum(ceil((1-alpha) * r * omega))`` — the host reads
    the max to size the static walker pool (pow2-bucketed, so recompiles
    stay bounded)."""
    alpha_f = jnp.float32(alpha)

    def local(r_l, omega):
        r1 = (1.0 - alpha_f) * r_l
        om = jnp.where(r1 > 0, jnp.ceil(r1 * omega), 0.0)
        # float32 total: a sizing estimate only (per-device totals can pass
        # 2^31 before the push phase has shrunk the residue — int32 would
        # silently wrap and collapse the pool)
        return jnp.sum(om).reshape(1, 1)

    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", "graph"), P()),
        out_specs=P("data", "graph"),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_node_sharded_walk_completion(
    mesh: Mesh,
    g: Graph,
    alpha: float,
    cap: int,
    *,
    max_steps: int | None = None,
):
    """Fused walks-mode residual completion over the node-sharded state.

    One shard_map program per (mesh, cap): each device expands its local
    residue chunk ``r[B_l, n_local]`` into <= ``cap`` walkers
    (``omega_i = ceil(r_i' * omega)`` no-zero-hop walks of per-walk weight
    ``r_i'/omega_i`` — Fora_Whole_Graph.java:119-140 with
    ``r' = (1-alpha) r`` and reserve += alpha r applied first), advances them
    with the ROTATING-ADJACENCY ring (CSR slices circulate via ``ppermute``;
    walkers stay put — parallel/node_sharded.make_node_sharded_walk_counts's
    scheme), and deposits stop weights through a counts ring. Dangling
    walkers reset to their start (Monte_Carlo.java:87-90). Every per-device
    array is O(n/S) or O(cap).

    Returns ``fn(p_l, r_l, keys, omega) -> p_new`` sharded (data, graph).
    """
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    s_graph = mesh_shape["graph"]
    ip_np, idx_np, prob_np, other_np, n_local = partition_csr_by_node(
        g, s_graph
    )
    weighted = prob_np is not None
    chunk_spec = NamedSharding(mesh, P("graph", None))
    arrays = dict(
        ip=jax.device_put(jnp.asarray(ip_np), chunk_spec),
        idx=jax.device_put(jnp.asarray(idx_np), chunk_spec),
        prob=(jax.device_put(jnp.asarray(prob_np), chunk_spec)
              if weighted else None),
        other=(jax.device_put(jnp.asarray(other_np), chunk_spec)
               if weighted else None),
    )
    alpha_f = jnp.float32(alpha)
    perm = [(i, (i + 1) % s_graph) for i in range(s_graph)]

    def _rot(x):
        return jax.lax.ppermute(x, "graph", perm) if s_graph > 1 else x

    def local(ip_c, idx_c, prob_c, other_c, p_l, r_l, keys, omega):
        b_l = r_l.shape[0]
        my = jax.lax.axis_index("graph").astype(jnp.int32)
        base = my * n_local

        # --- walker expansion from the local residue chunk (O(cap))
        r1 = (1.0 - alpha_f) * r_l
        p_new = p_l + alpha_f * r_l
        om = jnp.where(r1 > 0, jnp.ceil(r1 * omega), 0.0).astype(jnp.int32)
        wgt_node = jnp.where(
            om > 0, r1 / jnp.maximum(om, 1).astype(jnp.float32), 0.0
        )
        slots, valid = expand_walkers(om.reshape(-1), cap)
        rows = (slots // n_local).astype(jnp.int32)
        starts = (base + slots % n_local).astype(jnp.int32)
        wgt = wgt_node.reshape(-1)[slots] * valid.astype(jnp.float32)
        key = jax.random.fold_in(
            jax.random.wrap_key_data(keys[0, 0]),
            jax.lax.axis_index("data") * s_graph + my,
        )

        def move(cur, u_move, u2, need, ip, idx, prob, other):
            """One walker move via S rotating-slice hops (chunks end home)."""

            def hop(t, carry):
                ip_, idx_, prob_, other_, nxt = carry
                b0 = jax.lax.rem(my - t + s_graph, s_graph) * n_local
                in_chunk = need & (cur >= b0) & (cur < b0 + n_local)
                lv = jnp.clip(cur - b0, 0, n_local - 1)
                lo = jnp.take(ip_[0], lv)
                deg = jnp.take(ip_[0], lv + 1) - lo
                pick = jnp.minimum(
                    (u_move * deg.astype(jnp.float32)).astype(jnp.int32),
                    deg - 1,
                )
                slot = lo + jnp.maximum(pick, 0)
                if weighted:
                    accept = u2 < jnp.take(prob_[0], slot)
                    slot = jnp.where(accept, slot, jnp.take(other_[0], slot))
                cand = jnp.take(idx_[0], slot)
                cand = jnp.where(deg > 0, cand, starts)   # dangling -> start
                nxt = jnp.where(in_chunk, cand, nxt)
                return (_rot(ip_), _rot(idx_),
                        _rot(prob_) if weighted else prob_,
                        _rot(other_) if weighted else other_, nxt)

            return jax.lax.fori_loop(
                0, s_graph, hop, (ip, idx, prob, other, cur)
            )

        # no-zero-hop: one forced move before stop tests begin
        # (Fora_Whole_Graph.java:134 uses random_walk_no_zero_hop)
        key, k0 = jax.random.split(key)
        u0 = jax.random.uniform(k0, starts.shape)
        u2_0 = None
        if weighted:
            key, k0b = jax.random.split(key)
            u2_0 = jax.random.uniform(k0b, starts.shape)
        ip_c, idx_c, prob_c, other_c, cur = move(
            starts, u0, u2_0, jnp.ones(starts.shape, bool),
            ip_c, idx_c, prob_c, other_c,
        )

        def cond(state):
            _, active, _, step, *_ = state
            any_global = jax.lax.pmax(
                jnp.any(active).astype(jnp.int32), ("data", "graph")
            )
            return (step < max_steps) & (any_global > 0)

        def body(state):
            cur_, active, k, step, ip, idx, prob, other = state
            k, k_u = jax.random.split(k)
            u = jax.random.uniform(k_u, starts.shape)
            stop_now = u < alpha_f
            u_move = (u - alpha_f) * (1.0 / (1.0 - alpha_f))
            u2 = None
            if weighted:
                k, k_u2 = jax.random.split(k)
                u2 = jax.random.uniform(k_u2, starts.shape)
            need = active & ~stop_now
            ip, idx, prob, other, nxt = move(cur_, u_move, u2, need,
                                             ip, idx, prob, other)
            cur_ = jnp.where(need, nxt, cur_)
            return cur_, active & ~stop_now, k, step + 1, ip, idx, prob, other

        stops, *_ = jax.lax.while_loop(
            cond, body,
            (cur, jnp.ones(starts.shape, bool), key, jnp.int32(0),
             ip_c, idx_c, prob_c, other_c),
        )

        # deposit ring: [B_l, n_local] counts chunks circulate; after S hops
        # each is home having visited every graph-group device
        def dhop(t, chunk):
            b0 = jax.lax.rem(my - t + s_graph, s_graph) * n_local
            in_range = (stops >= b0) & (stops < b0 + n_local)
            lv = jnp.clip(stops - b0, 0, n_local - 1)
            chunk = chunk.at[rows, lv].add(jnp.where(in_range, wgt, 0.0))
            return _rot(chunk)

        counts = jax.lax.fori_loop(
            0, s_graph, dhop, jnp.zeros((b_l, n_local), jnp.float32)
        )
        return p_new + counts

    if weighted:
        fn = local
        chunk_specs = (P("graph", None),) * 4
    else:
        def fn(ip_c, idx_c, p_l, r_l, keys, omega):
            return local(ip_c, idx_c, None, None, p_l, r_l, keys, omega)

        chunk_specs = (P("graph", None),) * 2

    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=chunk_specs + (
            P("data", "graph"), P("data", "graph"),   # p, r
            P("data", "graph", None),                 # key material
            P(),                                      # omega
        ),
        out_specs=P("data", "graph"),
        check_vma=False,
    )
    jitted = jax.jit(mapped)

    def call(p_l, r_l, key, omega):
        keys = jax.random.key_data(
            jax.random.split(key, mesh_shape["data"] * s_graph)
        ).reshape(mesh_shape["data"], s_graph, -1)
        if weighted:
            return jitted(arrays["ip"], arrays["idx"], arrays["prob"],
                          arrays["other"], p_l, r_l, keys,
                          jnp.float32(omega))
        return jitted(arrays["ip"], arrays["idx"], p_l, r_l, keys,
                      jnp.float32(omega))

    return call


def _pow2(x: int, floor: int = 1024) -> int:
    import math

    return max(floor, 1 << int(math.ceil(math.log2(max(x, 1)))))


class NodeShardedForaWholeGraph:
    """Node-sharded FORA whole-graph engine (O(n/S) state per device).

    The multi-device analogue of :class:`ppr_tpu.models.fora.ForaWholeGraph`
    (Fora_Whole_Graph.java:82-146): a push phase of synchronous ring-exchange
    propagation sweeps (each sweep multiplies the residue mass by exactly
    ``1-alpha``, so the sweep count for any target mass is closed-form — no
    host-polled adaptive loop needed), then residual completion either by

    * ``completion="spmv"``: more ring sweeps down to ``eps * delta``
      (deterministic, exact within the truncation bound), or
    * ``completion="walks"``: the reference's randomized estimator —
      ``omega_i = ceil(r_i' * omega)`` no-zero-hop walks per residual node,
      executed by the ROTATING-ADJACENCY walk ring (each device keeps 1/S of
      the CSR; SURVEY.md §7 "cross-shard walks", graph-migrates variant).

    The walks-mode cap per device is pow2-bucketed from a measured total
    (one [D, S] host read per call), bounding recompiles.
    """

    name = "FORA-node-sharded"

    def __init__(self, dataset, alpha: float = 0.15, *,
                 mesh: Mesh | None = None, completion: str = "spmv",
                 seed: int = 0, max_walkers_per_device: int = 1 << 26,
                 ring_dtype: str = "f32"):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        n = self.graph.n
        self.delta = 1.0 / n
        self.pfail = 1.0 / n
        self.completion = completion
        self.mesh = mesh if mesh is not None else make_mesh()
        self.max_walkers_per_device = max_walkers_per_device
        self._key = jax.random.key(seed)
        self._mesh_shape = dict(zip(self.mesh.axis_names,
                                    self.mesh.devices.shape))
        self.ring_dtype = ring_dtype
        self._prepare, self._run_ring = make_node_sharded_propagate_ring(
            self.mesh, self.graph, self.alpha, ring_dtype=ring_dtype
        )
        self._totals = None
        self._walk_programs: dict[int, object] = {}

    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _iters_to(self, rsum_from: float, rsum_to: float) -> int:
        import math

        if rsum_to >= rsum_from or rsum_from <= 0:
            return 0
        return int(math.ceil(
            math.log(rsum_to / rsum_from) / math.log1p(-self.alpha)
        ))

    def compute_whole_graph_batch(self, sources: np.ndarray,
                                  param) -> np.ndarray:
        import math

        eps = float(param)
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        sources = np.asarray(sources, np.int32)
        b = len(sources)
        unit = self._mesh_shape["data"]
        b_pad = ((max(8, b) + unit - 1) // unit) * unit
        src_pad = np.concatenate([sources,
                                  np.zeros(b_pad - b, np.int32)])

        ln_term = math.log(2.0 / self.pfail)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta
        target = eps * self.delta

        p_l, r_l, onehot_l = self._prepare(src_pad)
        if self.completion == "spmv":
            iters = self._iters_to(1.0, target)
            p_l, r_l = self._run_ring(p_l, r_l, onehot_l, iters)
            out = np.asarray(p_l)
        else:
            # push until the residual walk count fits the per-device pool:
            # EVERY row spawns ~omega * rsum walkers, so the budget must be
            # divided by the batch height; rsum(t) = (1-alpha)^t exactly.
            # 0.5 margin absorbs per-shard skew + the +1/ceil per entry.
            budget = self.max_walkers_per_device * math.prod(
                self.mesh.devices.shape
            )
            rsum_target = min(1.0, 0.5 * budget / (omega * b_pad))
            iters = max(1, self._iters_to(1.0, rsum_target))
            p_l, r_l = self._run_ring(p_l, r_l, onehot_l, iters)
            if self._totals is None:
                self._totals = make_node_sharded_walk_totals(
                    self.mesh, self.graph, self.alpha
                )
            per_dev = np.asarray(self._totals(r_l, jnp.float32(omega)))
            # measured backstop: if skew still blows the per-device pool,
            # run a few more ring sweeps (each shrinks every count by
            # (1-alpha)) instead of failing
            for _ in range(64):
                cap = _pow2(int(per_dev.max() * 1.05) + 1)
                if cap <= self.max_walkers_per_device:
                    break
                p_l, r_l = self._run_ring(p_l, r_l, onehot_l, 4)
                per_dev = np.asarray(self._totals(r_l, jnp.float32(omega)))
            else:
                raise ValueError(
                    f"walks-mode pool {cap} exceeds the per-device budget; "
                    "raise max_walkers_per_device or use completion='spmv'"
                )
            if cap not in self._walk_programs:
                self._walk_programs[cap] = make_node_sharded_walk_completion(
                    self.mesh, self.graph, self.alpha, cap
                )
            p_l = self._walk_programs[cap](p_l, r_l, self.next_key(), omega)
            out = np.asarray(p_l)

        # dangling-source short-circuit (Fora_Whole_Graph's walk phase never
        # leaves the source when d_out(s) = 0 — pi(s, s) = 1 exactly)
        deg_src = np.asarray(g.out_deg)[src_pad]
        out = out.copy()
        dangling_rows = np.nonzero(deg_src == 0)[0]
        if len(dangling_rows):
            out[dangling_rows] = 0.0
            out[dangling_rows, src_pad[dangling_rows]] = 1.0
        return out[:b]
