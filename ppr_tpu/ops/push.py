"""Frontier-masked synchronous push sweeps (forward and backward).

Array re-design of the reference's queue-driven local-push loops:

* Forward push (Forward_Push.java:63-142 whole-graph, :144-250 resumable
  top-k): the work queue ``Q`` with gate ``r(v)/d_out(v) >= rmax`` becomes a
  boolean *frontier mask* over the dense residue vector; one sweep settles
  every currently-active node at once (reserve += alpha*r, residue scattered
  to out-neighbors via :func:`ppr_tpu.ops.spmv.push_out`), iterated under
  ``lax.while_loop`` until the frontier is empty. The fixpoint satisfies the
  same invariant as the reference (all non-dangling nodes have
  r/d < rmax; dangling nodes have r = 0) and the same mass-conservation
  identity  sum(p) + sum(r) = 1.

  Semantic quirks preserved:
  - dangling active nodes return their (1-alpha)*r to the *source* as
    residue, not uniform teleport (Forward_Push.java:101-115);
  - a dangling node is "active" whenever r > 0, because the reference's
    enqueue test divides by out-degree 0 giving +Infinity >= rmax;
  - a *source* with out-degree 0 short-circuits to reserve = e_s, residue = 0
    (Forward_Push.java:70-74) — handled by the caller-visible wrapper.

* Backward push (Backward_Search.java:38-100): the reverse sweep over
  incoming edges with gate ``r(v) > rmax`` (strict, *not* degree-normalized —
  Backward_Search.java:89-94) and per-in-neighbor update
  ``r(u) += (1-alpha) * r(v) / d_out(u)`` via
  :func:`ppr_tpu.ops.spmv.pull_out_norm`. A target with in-degree 0
  short-circuits to reserve = e_t (Backward_Search.java:46-49) — also in the
  wrapper.

All functions are batched: residue/reserve are ``[B, n_pad]`` for B
simultaneous sources (forward) or targets (backward) — the query-batch data
parallelism absent from the reference (Gen_Util.java:146-165 runs queries
sequentially).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..graph.csr import Graph
from .spmv import push_out, pull_out_norm


def forward_frontier(g: Graph, r: jax.Array, rmax) -> jax.Array:
    """Active mask per (batch, node): r/d >= rmax, with d==0 meaning +inf ratio."""
    deg = g.out_deg.astype(jnp.float32)
    gated = (g.out_deg > 0) & (r >= rmax * deg)
    dangling = (g.out_deg == 0) & (r > 0)
    return (gated | dangling) & (g.node_mask > 0)


@partial(jax.jit, static_argnames=("max_sweeps",))
def forward_push_sweeps(
    g: Graph,
    p: jax.Array,            # f32[B, n_pad] reserve (pi)
    r: jax.Array,            # f32[B, n_pad] residue
    src_onehot: jax.Array,   # f32[B, n_pad] one-hot of each row's source
    rmax: jax.Array,         # f32 scalar or f32[B, 1]
    alpha: float,
    max_sweeps: int = 10_000,
):
    """Run masked push sweeps until no node is active (or ``max_sweeps``).

    Returns ``(p, r, sweeps_used)``. Restartable: calling again with a smaller
    ``rmax`` continues refinement exactly like the reference's resumable
    ``forward_push_topk`` (Forward_Push.java:144-250) — the Q/Q_next
    bookkeeping is implicit in the frontier mask.
    """
    alpha = jnp.float32(alpha)
    is_dangling = (g.out_deg == 0) & (g.node_mask > 0)

    def cond(state):
        _, r_, it = state
        return (it < max_sweeps) & jnp.any(forward_frontier(g, r_, rmax))

    def body(state):
        p_, r_, it = state
        active = forward_frontier(g, r_, rmax)
        a = jnp.where(active, r_, 0.0)
        p_ = p_ + alpha * a
        # dangling sources contribute nothing through any SpMV backend
        # (_safe_inv_deg is 0 at d_out=0, and they have no out-edges), so
        # ``a`` needs no zeroing before the push — one fused masked reduce
        # is the only dangling work per sweep
        dang_mass = jnp.sum(
            jnp.where(is_dangling, a, 0.0), axis=-1, keepdims=True
        )
        pushed = push_out(g, (1.0 - alpha) * a)
        r_ = r_ - a + pushed + (1.0 - alpha) * dang_mass * src_onehot
        return p_, r_, it + 1

    p, r, sweeps = jax.lax.while_loop(cond, body, (p, r, jnp.int32(0)))
    return p, r, sweeps


@jax.jit
def forward_push_init(g: Graph, sources: jax.Array):
    """Initial (p, r, src_onehot) state for a batch of source node ids.

    Rows whose source has out-degree 0 are short-circuited *at init* to
    reserve = e_s, residue = 0 (Forward_Push.java:70-74 terminates before
    entering the push loop) — this also avoids the degenerate self-feeding
    sweep loop a dangling source would otherwise cause."""
    src_onehot = jax.nn.one_hot(sources, g.n_pad, dtype=jnp.float32)
    is_shortcircuit = (jnp.take(g.out_deg, sources) == 0)[:, None]
    p = jnp.where(is_shortcircuit, src_onehot, 0.0)
    r = jnp.where(is_shortcircuit, 0.0, src_onehot)
    return p, r, src_onehot


def apply_dangling_source_shortcircuit(
    g: Graph, sources: jax.Array, p: jax.Array, r: jax.Array, src_onehot: jax.Array
):
    """Rows whose source has out-degree 0 get reserve = e_s, residue = 0.

    Mirrors Forward_Push.java:70-74 (and Fora_Topk.java:128-132): the
    reference terminates immediately with pi(s,s) = 1 when the start node has
    no out-edges.
    """
    deg_src = jnp.take(g.out_deg, sources)[:, None]
    is_shortcircuit = deg_src == 0
    p = jnp.where(is_shortcircuit, src_onehot, p)
    r = jnp.where(is_shortcircuit, 0.0, r)
    return p, r


@partial(jax.jit, static_argnames=("max_sweeps",))
def backward_push_sweeps(
    g: Graph,
    p: jax.Array,            # f32[T, n_pad] reserve pi(., t)
    r: jax.Array,            # f32[T, n_pad] residue r(., t)
    rmax: jax.Array,         # f32 scalar
    alpha: float,
    max_sweeps: int = 10_000,
):
    """Reverse push until no node has residue > rmax (strict gate).

    One sweep: every active node v settles ``p(v) += alpha*r(v)`` and sends
    ``(1-alpha)*r(v)/d_out(u)`` to each in-neighbor u. Mass simply vanishes at
    nodes with no in-neighbors, matching the reference (the (1-alpha) share
    of a popped node with in-degree 0 goes nowhere, Backward_Search.java:73-96).
    """
    alpha = jnp.float32(alpha)

    def frontier(r_):
        return (r_ > rmax) & (g.node_mask > 0)

    def cond(state):
        _, r_, it = state
        return (it < max_sweeps) & jnp.any(frontier(r_))

    def body(state):
        p_, r_, it = state
        a = jnp.where(frontier(r_), r_, 0.0)
        p_ = p_ + alpha * a
        r_ = r_ - a + pull_out_norm(g, (1.0 - alpha) * a)
        return p_, r_, it + 1

    p, r, sweeps = jax.lax.while_loop(cond, body, (p, r, jnp.int32(0)))
    return p, r, sweeps


def apply_zero_indeg_target_shortcircuit(
    g: Graph, targets: jax.Array, p: jax.Array, r: jax.Array, tgt_onehot: jax.Array
):
    """Rows whose target has in-degree 0 get reserve = e_t, residue = 0
    (Backward_Search.java:46-49)."""
    deg_t = jnp.take(g.in_deg, targets)[:, None]
    is_shortcircuit = deg_t == 0
    p = jnp.where(is_shortcircuit, tgt_onehot, p)
    r = jnp.where(is_shortcircuit, 0.0, r)
    return p, r
