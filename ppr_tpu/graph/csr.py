"""Array-native graph store for batched Personalized PageRank.

This is the array replacement of the reference's in-memory "HeavyGraph"
snapshot (reference: PPR.java:141-147, loaded via
``GraphLoader(...).load(HeavyGraphFactory.class)``). Instead of a Java object
with per-node adjacency iterators (``degree``/``getTarget``/
``forEachRelationship``), the graph is a frozen pytree of padded int32/float32
arrays so every algorithm is expressible as gathers, segment-sums and matmuls
under ``jax.jit``:

* CSR out-adjacency (``indptr``/``indices``) drives the vectorized
  random-walk kernel (uniform out-neighbor selection, the array equivalent of
  ``adjM.getTarget(v, rand, OUTGOING)`` in Monte_Carlo.java:84).
* A COO edge list (``edge_src``/``edge_dst``) drives the push kernels: one
  forward-push sweep is a masked gather + segment-sum scatter, replacing the
  queue-driven loop of Forward_Push.java:85-141; the same arrays serve the
  backward (reverse) push of Backward_Search.java:73-96 by scattering to
  ``edge_src`` instead of ``edge_dst``.
* An optional dense transition matrix ``dense_out`` (row v holds
  (1-alpha)-unscaled 1/d_v at out-neighbors) maps the 100-iteration power
  method (Power_Method.java:55-100) onto plain ``[B, n] @ [n, n]`` matmuls
  for small/medium graphs.

Node ids are the dense mapped ids 0..n-1 (the reference's ``toMappedNodeId``
space); the loader keeps the original-id mapping on the host side
(graph/io.py), mirroring HeavyGraph's long<->int id map.

Padding: ``n_pad``/``m_pad`` round n and m up to multiples of 128, so the
array shapes (and with them the compiled programs) change only in steps of
128, and a sentinel node always exists past the real ones. Padded nodes are
isolated (degree 0) and padded edges carry ``edge_src = edge_dst = n_pad-1``
with ``edge_mask = 0`` so they contribute nothing to segment-sums.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128  # padding unit of node and edge arrays (see the module docstring)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable array graph snapshot (a JAX pytree).

    Shapes use the padded sizes ``n_pad`` and ``m_pad``; the logical sizes
    ``n`` (nodes) and ``m`` (directed edges) are static metadata.
    """

    # --- CSR out-adjacency ---
    indptr: jax.Array       # int32[n_pad + 1]; indptr[v]..indptr[v+1] out-edges of v
    indices: jax.Array      # int32[m_pad]; out-neighbor node ids (padded tail = n_pad-1)

    # --- COO edge list, src-sorted (drives push scatter kernels) ---
    edge_src: jax.Array     # int32[m_pad]
    edge_dst: jax.Array     # int32[m_pad]
    edge_mask: jax.Array    # float32[m_pad]; 1.0 for real edges, 0.0 for padding

    # --- same edges sorted by destination (for sorted segment-sum scatter) ---
    edge_src_bydst: jax.Array  # int32[m_pad]
    edge_dst_bydst: jax.Array  # int32[m_pad] (non-decreasing)

    # --- per-node arrays ---
    out_deg: jax.Array      # int32[n_pad]
    in_deg: jax.Array       # int32[n_pad]
    node_mask: jax.Array    # float32[n_pad]; 1.0 for real nodes

    # --- optional dense operator for matmul execution (None for large graphs) ---
    dense_out: jax.Array | None  # float32[n_pad, n_pad]; row v = 1/d_v at out-nbrs

    # --- static metadata ---
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))

    # --- optional weighted-edge extension (None for uniform graphs) ---
    # normalized per-edge coefficient w_e / W_src in each edge order, and
    # alias tables (CSR slot layout) for O(1) weighted neighbor sampling.
    # The reference supports only unweighted graphs; this is net-new
    # capability (SURVEY.md notes alias tables become necessary "if weighted
    # edges are ever added").
    edge_coef: jax.Array | None = None         # f32[m_pad], src-sorted order
    edge_coef_bydst: jax.Array | None = None   # f32[m_pad], dst-sorted order
    alias_prob: jax.Array | None = None        # f32[m_pad]
    alias_other: jax.Array | None = None       # int32[m_pad] (global slot)

    @property
    def n_pad(self) -> int:
        return int(self.out_deg.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def has_dense(self) -> bool:
        return self.dense_out is not None

    @property
    def weighted(self) -> bool:
        return self.edge_coef is not None


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    weights: np.ndarray | None = None,
    dense_threshold: int = 4096,
    node_align: int = LANES,
    edge_align: int = LANES,
) -> Graph:
    """Build a :class:`Graph` from a directed COO edge list.

    ``src[i] -> dst[i]`` are directed edges over dense node ids ``0..n-1``.
    Parallel edges and self-loops are kept as-is (the reference's HeavyGraph
    keeps whatever the Neo4j store holds; GOT_Rels.csv has plain directed
    edges).

    When ``n_pad <= dense_threshold`` a dense row-normalized out-operator is
    also materialized so push/power iterations run as dense matmuls.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        if weights.shape != src.shape:
            raise ValueError("weights shape mismatch")
        if (weights <= 0).any():
            raise ValueError("edge weights must be strictly positive")
    m = int(src.shape[0])
    if m and (src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n):
        raise ValueError("edge endpoint out of range")

    # n+1 guarantees the sentinel node n_pad-1 is always a padding node
    # (never a real node), so padding edges are inert without masking.
    n_pad = max(_round_up(n + 1, node_align), node_align)
    m_pad = max(_round_up(max(m, 1), edge_align), edge_align)

    # sort edges by src -> CSR order (stable). The native C++ builder does a
    # counting sort at memory bandwidth; the numpy argsort path is the
    # dependency-free fallback with identical layout.
    from ..native import build_csr_native

    native = build_csr_native(src, dst, n, n_pad) if (m and weights is None) \
        else None
    if native is not None:
        indptr, indices_m, src_s, out_deg, in_deg = native
        dst_s = indices_m.astype(np.int64)
        src_s = src_s.astype(np.int64)
        w_s = None
    else:
        order = np.argsort(src, kind="stable")
        src_s = src[order]
        dst_s = dst[order]
        w_s = weights[order] if weights is not None else None
        out_deg = np.bincount(src_s, minlength=n_pad).astype(np.int32)
        in_deg = np.bincount(dst_s, minlength=n_pad).astype(np.int32)
        indptr = np.zeros(n_pad + 1, dtype=np.int64)
        np.cumsum(out_deg, out=indptr[1:])
        indptr = indptr.astype(np.int32)

    pad_node = n_pad - 1
    indices = np.full(m_pad, pad_node, dtype=np.int32)
    indices[:m] = dst_s

    edge_src = np.full(m_pad, pad_node, dtype=np.int32)
    edge_src[:m] = src_s
    edge_dst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_dst[:m] = dst_s
    edge_mask = np.zeros(m_pad, dtype=np.float32)
    edge_mask[:m] = 1.0

    # destination-sorted view of the same edges (padding sorts to the end
    # since the sentinel is n_pad-1); enables sorted segment-sum scatter
    order_d = np.argsort(dst_s, kind="stable")
    edge_src_bydst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_src_bydst[:m] = src_s[order_d]
    edge_dst_bydst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_dst_bydst[:m] = dst_s[order_d]

    node_mask = np.zeros(n_pad, dtype=np.float32)
    node_mask[:n] = 1.0

    # per-edge normalized coefficients + alias tables (weighted graphs only)
    edge_coef = edge_coef_bydst = alias_prob = alias_other = None
    if weights is not None and m:
        w_sum = np.zeros(n_pad, np.float64)
        np.add.at(w_sum, src_s, w_s)
        coef = w_s / w_sum[src_s]
        edge_coef = np.zeros(m_pad, np.float32)
        edge_coef[:m] = coef
        edge_coef_bydst = np.zeros(m_pad, np.float32)
        edge_coef_bydst[:m] = coef[order_d]
        prob_np, other_np = _build_alias_tables(
            indptr, coef, m, m_pad
        )
        alias_prob, alias_other = jnp.asarray(prob_np), jnp.asarray(other_np)
        edge_coef = jnp.asarray(edge_coef)
        edge_coef_bydst = jnp.asarray(edge_coef_bydst)

    dense_out = None
    if n_pad <= dense_threshold:
        dense_np = np.zeros((n_pad, n_pad), dtype=np.float32)
        if m:
            if weights is not None:
                w_sum = np.zeros(n_pad, np.float64)
                np.add.at(w_sum, src_s, w_s)
                np.add.at(dense_np, (src_s, dst_s), w_s / w_sum[src_s])
            else:
                inv_deg = 1.0 / out_deg[src_s].astype(np.float64)
                np.add.at(dense_np, (src_s, dst_s), inv_deg)
        dense_out = jnp.asarray(dense_np)

    return Graph(
        indptr=jnp.asarray(indptr),
        indices=jnp.asarray(indices),
        edge_src=jnp.asarray(edge_src),
        edge_dst=jnp.asarray(edge_dst),
        edge_mask=jnp.asarray(edge_mask),
        edge_src_bydst=jnp.asarray(edge_src_bydst),
        edge_dst_bydst=jnp.asarray(edge_dst_bydst),
        out_deg=jnp.asarray(out_deg),
        in_deg=jnp.asarray(in_deg),
        node_mask=jnp.asarray(node_mask),
        dense_out=dense_out,
        n=n,
        m=m,
        edge_coef=edge_coef,
        edge_coef_bydst=edge_coef_bydst,
        alias_prob=alias_prob,
        alias_other=alias_other,
    )


def _build_alias_tables(indptr, coef, m, m_pad):
    """Walker's alias method per CSR segment: slot j of node v keeps its own
    target with probability ``prob[j]``, else redirects to slot
    ``other[j]``. O(d) construction per node — native C++ when available,
    numpy/python fallback."""
    from ..native import build_alias_native

    native = build_alias_native(np.asarray(indptr), coef, m_pad)
    if native is not None:
        return native
    prob = np.ones(m_pad, np.float32)
    other = np.arange(m_pad, dtype=np.int32)
    indptr = np.asarray(indptr)
    for v in range(len(indptr) - 1):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        d = hi - lo
        if d <= 1:
            continue
        q = coef[lo:hi].astype(np.float64) * d
        small = [j for j in range(d) if q[j] < 1.0]
        large = [j for j in range(d) if q[j] >= 1.0]
        q = q.copy()
        while small and large:
            s_j = small.pop()
            l_j = large.pop()
            prob[lo + s_j] = q[s_j]
            other[lo + s_j] = lo + l_j
            q[l_j] = q[l_j] - (1.0 - q[s_j])
            (small if q[l_j] < 1.0 else large).append(l_j)
        for j in small + large:
            prob[lo + j] = 1.0
            other[lo + j] = lo + j
    return prob, other


def graph_from_scipy(mat, **kwargs) -> Graph:
    """Build from a ``scipy.sparse`` matrix where ``mat[i, j] != 0`` is edge i->j."""
    coo = mat.tocoo()
    return build_graph(coo.row, coo.col, n=mat.shape[0], **kwargs)


def summarize(g: Graph) -> dict:
    """Host-side summary (for logs / harness headers)."""
    out_deg = np.asarray(g.out_deg[: g.n])
    return {
        "n": g.n,
        "m": g.m,
        "n_pad": g.n_pad,
        "m_pad": g.m_pad,
        "dangling": int((out_deg == 0).sum()),
        "max_out_deg": int(out_deg.max()) if g.n else 0,
        "dense": g.has_dense,
    }
