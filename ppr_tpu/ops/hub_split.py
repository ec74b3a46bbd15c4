"""Hub-split hybrid SpMV: dense matmul columns for high-in-degree hubs.

A sparse push sweep pays per edge (a gather and a segmented reduction per
edge and row), so one way to make a sweep cheaper is to *remove edges from
the sparse path*. In power-law graphs a few hundred hub nodes receive a
large fraction of all edges; their incoming contributions are a dense
reduction:

    y[hub_h] = sum_v a[v]/d_v * (#edges v->hub_h)   ==  (a * inv_deg) @ M[:, h]

i.e. one ``[B, n] @ [n, H]`` matmul replaces the segment-sum over every
hub-destined edge. The remaining tail edges go through the usual sorted
segmented reduction. How many hubs pay off depends on the device's sparse
and memory rates (:func:`auto_num_hubs`).

The hub data lives in its own small pytree (:class:`HubSplit`) next to the
Graph, so enabling it does not change the Graph pytree (and therefore does
not invalidate compiled-program caches of the non-hybrid paths).

Currently uniform-weight graphs only (the hybrid path is a performance
backend for the large-graph regime; weighted graphs use the standard
backends).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..utils.devices import device_rates
from .spmv import _safe_inv_deg


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HubSplit:
    hub_ids: jax.Array        # int32[H] node ids (largest in-degree)
    hub_matrix: jax.Array     # f32[n_pad, H]; [v, h] = multiplicity(v->hub_h)/d_v
    tail_src: jax.Array       # int32[mt_pad] dst-sorted tail edges
    tail_dst: jax.Array       # int32[mt_pad]
    num_hubs: int = dataclasses.field(metadata=dict(static=True))
    m_tail: int = dataclasses.field(metadata=dict(static=True))


def auto_num_hubs(
    g: Graph,
    dtype=np.float32,
    *,
    tail_ns_per_edge: float | None = None,
    mem_bytes_per_s: float | None = None,
    max_matrix_bytes: int = 4 << 30,
) -> int:
    """Marginal-benefit hub count: include node v as a hub while the sparse
    cost of its incoming edges (``in_deg(v) * tail_ns_per_edge``) exceeds
    the per-sweep memory cost of one more dense matrix column
    (``n_pad * itemsize / bandwidth``). Both rates default to the device
    table's (:mod:`ppr_tpu.utils.devices`); the rule only needs them to
    within ~2x.

    Capped so the matrix stays under ``max_matrix_bytes``; rounded to a
    multiple of 128 columns."""
    if not (tail_ns_per_edge and mem_bytes_per_s):
        rates = device_rates()
        tail_ns_per_edge = tail_ns_per_edge or rates.spmv_ns_per_edge
        mem_bytes_per_s = mem_bytes_per_s or rates.mem_bytes_per_s
    itemsize = np.dtype(dtype).itemsize if dtype != jnp.bfloat16 else 2
    col_ns = g.n_pad * itemsize / mem_bytes_per_s * 1e9
    min_deg = max(col_ns / tail_ns_per_edge, 1.0)
    in_deg = np.asarray(g.in_deg)[: g.n]
    h = int((in_deg > min_deg).sum())
    h = min(h, max_matrix_bytes // max(g.n_pad * itemsize, 1), g.n)
    return max(128, (h // 128) * 128) if h else 128


def build_hub_split(
    g: Graph, num_hubs: int | str = 512, dtype=np.float32
) -> HubSplit:
    """Host-side construction from the dst-sorted edge view.

    ``dtype=jnp.bfloat16`` halves the hub matrix's per-sweep memory read
    and runs the matmul at the bf16 rate. Edge multiplicities are
    small integers (exact in bf16 up to 256); the only precision loss is the
    bf16 cast of the scaled residue operand (~2^-9 relative), well inside
    FORA's eps-approximation budget.
    """
    if g.weighted:
        raise NotImplementedError("hub split supports uniform graphs")
    if num_hubs == "auto":
        num_hubs = auto_num_hubs(g, dtype)
    num_hubs = int(min(num_hubs, g.n))
    in_deg = np.asarray(g.in_deg)[: g.n]
    hub_ids = np.argsort(-in_deg, kind="stable")[:num_hubs].astype(np.int32)
    is_hub = np.zeros(g.n_pad, bool)
    is_hub[hub_ids] = True

    src = np.asarray(g.edge_src_bydst)[: g.m]
    dst = np.asarray(g.edge_dst_bydst)[: g.m]
    hub_pos = np.full(g.n_pad, -1, np.int64)
    hub_pos[hub_ids] = np.arange(num_hubs)

    to_hub = is_hub[dst]
    # raw edge multiplicities: the consumer multiplies by a * 1/d_v first,
    # so the matrix itself must NOT carry the degree normalization
    hub_matrix = np.zeros((g.n_pad, num_hubs), np.float32)
    hsrc, hdst = src[to_hub], dst[to_hub]
    np.add.at(hub_matrix, (hsrc, hub_pos[hdst]), 1.0)

    t_src, t_dst = src[~to_hub], dst[~to_hub]
    m_tail = int(t_src.size)
    mt_pad = max(128, ((m_tail + 127) // 128) * 128)
    tail_src = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_dst = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_src[:m_tail] = t_src
    tail_dst[:m_tail] = t_dst

    return HubSplit(
        hub_ids=jnp.asarray(hub_ids),
        hub_matrix=jnp.asarray(hub_matrix, dtype=dtype),
        tail_src=jnp.asarray(tail_src),
        tail_dst=jnp.asarray(tail_dst),
        num_hubs=num_hubs,
        m_tail=m_tail,
    )


def _precision(dtype):
    """f32 hub matrices multiply at full f32 precision (the default may
    round operands, to TF32 on Hopper); bf16 ones stay bf16 products."""
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def push_out_hybrid(g: Graph, hs: HubSplit, a: jax.Array) -> jax.Array:
    """``push_out`` semantics via dense hub matmul + sparse tail reduction."""
    inv_deg = _safe_inv_deg(g.out_deg)
    scaled = a * inv_deg
    squeeze = scaled.ndim == 1
    if squeeze:
        scaled = scaled[None, :]

    hub_vals = jnp.matmul(
        scaled.astype(hs.hub_matrix.dtype), hs.hub_matrix,
        preferred_element_type=jnp.float32,
        precision=_precision(hs.hub_matrix.dtype),
    )                                                   # [B, H]

    scaled_t = jnp.moveaxis(scaled, -1, 0)              # [n_pad, B]
    contrib_t = jnp.take(scaled_t, hs.tail_src, axis=0)
    out_t = jax.ops.segment_sum(
        contrib_t, hs.tail_dst, num_segments=g.n_pad, indices_are_sorted=True
    )
    out = jnp.moveaxis(out_t, 0, -1)
    out = out.at[..., hs.hub_ids].add(hub_vals)
    return out[0] if squeeze else out


def push_out_hybrid_t(g: Graph, hs: HubSplit, a_t: jax.Array, *,
                      num_chunks: int = 1) -> jax.Array:
    """Hybrid push on an already-transposed operand ``a_t: [n_pad, B]``.

    Node-major throughout: the hub contribution lands as ``H`` contiguous
    ``[B]`` row adds (vs. a strided column scatter in batch-major layout),
    and the tail gather reads contiguous rows. Contracting the hub matrix on
    its leading axis means no transpose of either matmul operand is
    materialized.

    ``num_chunks > 1`` processes the TAIL edges in sequential lax.scan
    chunks, bounding the per-edge intermediate to ``[m_tail/num_chunks,
    B]`` — at the 1M-node scale even the post-hub tail times a wide batch
    is a gather of many gigabytes; the hub matmul is unaffected.
    """
    inv_deg = _safe_inv_deg(g.out_deg)
    scaled_t = a_t * inv_deg[:, None]                   # [n_pad, B] f32

    lhs = hs.hub_matrix                                 # [n_pad, H]
    rhs = scaled_t.astype(lhs.dtype)
    hub_vals_t = jax.lax.dot_general(
        lhs, rhs, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=_precision(lhs.dtype),
    )                                                   # [H, B]

    if num_chunks <= 1:
        contrib_t = jnp.take(scaled_t, hs.tail_src, axis=0)
        out_t = jax.ops.segment_sum(
            contrib_t, hs.tail_dst, num_segments=g.n_pad,
            indices_are_sorted=True,
        )
    else:
        mt = hs.tail_src.shape[0]
        chunk = -(-mt // num_chunks)
        pad = chunk * num_chunks - mt
        # pad edges point at the sentinel n_pad-1 (never a real node;
        # scaled_t's sentinel row is 0 by the inv_deg mask) — slices of
        # the dst-sorted tail stay sorted
        src_chunks = jnp.pad(
            hs.tail_src, (0, pad), constant_values=g.n_pad - 1
        ).reshape(num_chunks, chunk)
        dst_chunks = jnp.pad(
            hs.tail_dst, (0, pad), constant_values=g.n_pad - 1
        ).reshape(num_chunks, chunk)

        def step(acc, chunks):
            src_c, dst_c = chunks
            contrib = jnp.take(scaled_t, src_c, axis=0)
            acc = acc + jax.ops.segment_sum(
                contrib, dst_c, num_segments=g.n_pad,
                indices_are_sorted=True,
            )
            return acc, None

        out_t, _ = jax.lax.scan(
            step, jnp.zeros_like(scaled_t), (src_chunks, dst_chunks)
        )
    return out_t.at[hs.hub_ids, :].add(hub_vals_t)
