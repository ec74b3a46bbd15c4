"""Sparse-matrix-vector push operators — the hot kernels of every PPR algorithm.

The reference's per-node scatter loops become two whole-graph linear
operators over batched node vectors ``a`` of shape ``[..., n_pad]``:

* :func:`push_out` — ``y[u] = sum_{v: v->u} a[v] / d_out(v)``. One forward
  sweep of this operator is the vectorized equivalent of the queue-driven
  out-neighbor scatter in Forward_Push.java:119-139 and of one synchronous
  power-method iteration (Power_Method.java:82-96).
* :func:`pull_out_norm` — ``y[u] = (1/d_out(u)) * sum_{v: u->v} a[v]``. One
  backward (reverse-push) sweep, equivalent to the in-neighbor scatter of
  Backward_Search.java:77-96 where each in-neighbor u receives
  ``(1-alpha) * r(v) / d_out(u)``.

Two execution backends, picked per graph:

* **dense** (``g.dense_out`` present): a single ``[B, n] @ [n, n]`` matmul —
  for small/medium graphs where the row-normalized operator fits in device
  memory (the GOT benchmark graph is a 128x128 f32 matrix).
* **coo**: gather along ``edge_src``/``edge_dst`` + scatter-add, which XLA
  lowers to vectorized dynamic-slice/scatter; used for large graphs where a
  dense operator is infeasible. The million-edge regime uses the
  sorted-segment-sum path plus the dense-hub hybrid in ops/hub_split.py.

Both backends are linear, mask padding edges, and drop mass at dangling
nodes (callers re-inject dangling mass per algorithm semantics — to the
*source*, per Forward_Push.java:101-115 / Power_Method.java:74-80).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..graph.csr import Graph


def _safe_inv_deg(deg: jax.Array) -> jax.Array:
    d = deg.astype(jnp.float32)
    return jnp.where(deg > 0, 1.0 / jnp.maximum(d, 1.0), 0.0)


def push_out(g: Graph, a: jax.Array, *, backend: str | None = None) -> jax.Array:
    """``y[u] = sum over edges v->u of a[v] / d_out(v)`` (batched over leading dims)."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    if backend == "dense":
        # Precision.HIGHEST: a default-precision f32 matmul may round its
        # inputs (to TF32 on Hopper, to bf16 elsewhere), which costs up to
        # ~2.5e-3 of mass per propagation pass — fatal for an oracle. The
        # dense backend only triggers on small graphs, where full-precision
        # passes stay cheap.
        return jnp.matmul(a, g.dense_out, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    inv_deg = _safe_inv_deg(g.out_deg)
    if backend == "coo_sorted":
        # gather at source along the dst-sorted edge order, then a *sorted*
        # segmented reduction over destinations — avoids the serialized
        # random scatter-add (padding edges sort to the sentinel node, which
        # is never a real node, so a[pad] * inv_deg[pad] = 0).
        # Weighted graphs scale per *edge* (w_e / W_src) instead of per node.
        scaled = a if g.weighted else a * inv_deg
        if scaled.ndim == 1:
            contrib = jnp.take(scaled, g.edge_src_bydst, axis=0)
            if g.weighted:
                contrib = contrib * g.edge_coef_bydst
            return jax.ops.segment_sum(
                contrib, g.edge_dst_bydst, num_segments=g.n_pad,
                indices_are_sorted=True,
            )
        # transpose the small [.., n_pad] operand once, then row-gather
        # straight into [m_pad, ..] layout — the big per-edge intermediate is
        # materialized exactly once
        scaled_t = jnp.moveaxis(scaled, -1, 0)        # [n_pad, ...]
        contrib_t = jnp.take(scaled_t, g.edge_src_bydst, axis=0)
        if g.weighted:
            contrib_t = contrib_t * g.edge_coef_bydst[:, None]
        out_t = jax.ops.segment_sum(
            contrib_t, g.edge_dst_bydst, num_segments=g.n_pad,
            indices_are_sorted=True,
        )
        return jnp.moveaxis(out_t, 0, -1)
    # coo: per-edge contribution gathered at source, scattered to destination
    if g.weighted:
        contrib = jnp.take(a, g.edge_src, axis=-1) * g.edge_coef * g.edge_mask
    else:
        contrib = jnp.take(a * inv_deg, g.edge_src, axis=-1) * g.edge_mask
    out = jnp.zeros_like(a)
    return out.at[..., g.edge_dst].add(contrib)


def push_out_t(g: Graph, a_t: jax.Array) -> jax.Array:
    """``push_out`` on an already-transposed operand ``a_t: [n_pad, B]``.

    The propagation while-loops (models/fora.py) keep their whole state in
    node-major layout so the per-edge gather reads contiguous ``[B]`` rows
    and no ``[B, n_pad]`` transpose is materialized per sweep (two full
    HBM round-trips saved per iteration vs. wrapping :func:`push_out`).
    """
    if g.has_dense:
        # y = a @ D  <=>  y^T = D^T @ a^T: contract both leading axes — no
        # transpose of either operand is materialized. Precision.HIGHEST:
        # see push_out's dense branch.
        return jax.lax.dot_general(
            g.dense_out, a_t, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    if g.weighted:
        contrib_t = jnp.take(a_t, g.edge_src_bydst, axis=0)
        contrib_t = contrib_t * g.edge_coef_bydst[:, None]
    else:
        inv_deg = _safe_inv_deg(g.out_deg)
        contrib_t = jnp.take(a_t * inv_deg[:, None], g.edge_src_bydst, axis=0)
    return jax.ops.segment_sum(
        contrib_t, g.edge_dst_bydst, num_segments=g.n_pad,
        indices_are_sorted=True,
    )


def push_out_chunked_t(
    g: Graph, a_t: jax.Array, *, num_chunks: int = 16
) -> jax.Array:
    """:func:`push_out_t` with the edge dimension processed in sequential
    chunks (lax.scan), bounding the per-edge intermediate to
    ``[m_pad/num_chunks, B]`` — the node-major variant of
    :func:`push_out_chunked`, used by the propagation loops when the full
    ``[m_pad, B]`` gather would not fit HBM (e.g. 33M edges at B=32)."""
    if g.weighted:
        scaled_t = a_t
    else:
        scaled_t = a_t * _safe_inv_deg(g.out_deg)[:, None]

    m_pad = g.m_pad
    chunk = -(-m_pad // num_chunks)
    pad = chunk * num_chunks - m_pad
    src_chunks = jnp.pad(
        g.edge_src_bydst, (0, pad), constant_values=g.n_pad - 1
    ).reshape(num_chunks, chunk)
    dst_chunks = jnp.pad(
        g.edge_dst_bydst, (0, pad), constant_values=g.n_pad - 1
    ).reshape(num_chunks, chunk)
    if g.weighted:
        coef_chunks = jnp.pad(
            g.edge_coef_bydst, (0, pad)
        ).reshape(num_chunks, chunk)

    def step(acc, chunks):
        if g.weighted:
            src_c, dst_c, coef_c = chunks
            contrib = jnp.take(scaled_t, src_c, axis=0) * coef_c[:, None]
        else:
            src_c, dst_c = chunks
            contrib = jnp.take(scaled_t, src_c, axis=0)
        acc = acc + jax.ops.segment_sum(
            contrib, dst_c, num_segments=g.n_pad, indices_are_sorted=True
        )
        return acc, None

    xs = (
        (src_chunks, dst_chunks, coef_chunks) if g.weighted
        else (src_chunks, dst_chunks)
    )
    out_t, _ = jax.lax.scan(step, jnp.zeros_like(scaled_t), xs)
    return out_t


def push_out_chunked(
    g: Graph, a: jax.Array, *, num_chunks: int = 16
) -> jax.Array:
    """``push_out`` with the edge dimension processed in ``num_chunks``
    sequential chunks (lax.scan), bounding peak memory to
    ``[m_pad/num_chunks, B]`` — for graphs where the full per-edge
    intermediate would not fit HBM (tens of millions of edges at large B).
    Edges are dst-sorted globally, hence also within each chunk, so every
    chunk uses the sorted segmented reduction."""
    inv_deg = _safe_inv_deg(g.out_deg)
    scaled = a * inv_deg
    squeeze = scaled.ndim == 1
    if squeeze:
        scaled = scaled[None, :]
    scaled_t = jnp.moveaxis(scaled, -1, 0)            # [n_pad, B]

    m_pad = g.m_pad
    chunk = -(-m_pad // num_chunks)
    pad = chunk * num_chunks - m_pad
    # padding chunk entries point at the sentinel node (inert by construction)
    src_chunks = jnp.pad(
        g.edge_src_bydst, (0, pad), constant_values=g.n_pad - 1
    ).reshape(num_chunks, chunk)
    dst_chunks = jnp.pad(
        g.edge_dst_bydst, (0, pad), constant_values=g.n_pad - 1
    ).reshape(num_chunks, chunk)

    def step(acc, chunks):
        src_c, dst_c = chunks
        contrib = jnp.take(scaled_t, src_c, axis=0)   # [chunk, B]
        acc = acc + jax.ops.segment_sum(
            contrib, dst_c, num_segments=g.n_pad, indices_are_sorted=True
        )
        return acc, None

    init = jnp.zeros_like(scaled_t)
    out_t, _ = jax.lax.scan(step, init, (src_chunks, dst_chunks))
    out = jnp.moveaxis(out_t, 0, -1)
    return out[0] if squeeze else out


def pull_out_norm(g: Graph, a: jax.Array, *, backend: str | None = None) -> jax.Array:
    """``y[u] = (1/d_out(u)) * sum over edges u->v of a[v]`` (reverse push step)."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    if backend == "dense":
        return jnp.matmul(
            a, g.dense_out.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    inv_deg = _safe_inv_deg(g.out_deg)
    if backend == "coo_sorted":
        # the primary edge order is already src-sorted: gather at dst, sorted
        # segmented reduction over sources (padding edges are inert — the
        # sentinel node never carries residue). Weighted: per-edge coef
        # w_uv/W_u replaces the 1/d_u node scaling.
        if a.ndim == 1:
            contrib = jnp.take(a, g.edge_dst, axis=0)
            if g.weighted:
                contrib = contrib * g.edge_coef
            out = jax.ops.segment_sum(
                contrib, g.edge_src, num_segments=g.n_pad,
                indices_are_sorted=True,
            )
            return out if g.weighted else out * inv_deg
        a_t = jnp.moveaxis(a, -1, 0)                  # [n_pad, ...]
        contrib_t = jnp.take(a_t, g.edge_dst, axis=0)
        if g.weighted:
            contrib_t = contrib_t * g.edge_coef[:, None]
        out_t = jax.ops.segment_sum(
            contrib_t, g.edge_src, num_segments=g.n_pad,
            indices_are_sorted=True,
        )
        out = jnp.moveaxis(out_t, 0, -1)
        return out if g.weighted else out * inv_deg
    # coo: gather residue at edge destination, scatter to edge source / d_out(src)
    contrib = jnp.take(a, g.edge_dst, axis=-1) * g.edge_mask
    if g.weighted:
        contrib = contrib * g.edge_coef
        out = jnp.zeros_like(a)
        return out.at[..., g.edge_src].add(contrib)
    out = jnp.zeros_like(a)
    out = out.at[..., g.edge_src].add(contrib)
    return out * inv_deg
