"""Vectorized alpha-terminated random-walk kernel.

Array re-design of the reference's per-walk inner loops
(Monte_Carlo.random_walk, Monte_Carlo.java:60-94, and
random_walk_no_zero_hop, :96-133): instead of one Java while-loop per walk,
``W`` walkers advance in lockstep as int32 lanes. Per step each active walker

* stops with probability alpha (uniform draw < alpha, matching the stop test
  at Monte_Carlo.java:76-78 which runs *before* the move — so a walk may stop
  at its start node, "zero hops");
* otherwise moves to a uniformly chosen out-neighbor via the CSR gather
  ``indices[indptr[v] + floor(u * d_v)]`` (the vectorized
  ``adjM.getTarget(v, rand, OUTGOING)`` of Monte_Carlo.java:84-85);
* at a dangling node (d_v == 0) it resets to its start node and keeps
  walking (Monte_Carlo.java:87-90).

A walk whose start node has out-degree 0 returns the start node — in the
reference this is an explicit early return (Monte_Carlo.java:70-72); here it
falls out naturally because every move from it resets to itself.

The loop runs under ``lax.while_loop`` until all walkers stopped or
``max_steps`` is reached. With stop probability alpha per step the survivor
fraction after L steps is (1-alpha)^L; the default cap keeps the truncation
bias below ~1e-9 at alpha = 0.15.

The ``no_zero_hop`` variant forces one initial hop before stop tests begin —
used by FORA whole-graph (Fora_Whole_Graph.java:134 calls
random_walk_no_zero_hop) whereas FORA top-k and Monte-Carlo use plain walks.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..graph.csr import LANES, Graph


def default_max_steps(alpha: float, tail: float = 1e-9) -> int:
    """Smallest L with (1-alpha)^L <= tail (survivor mass below ``tail``)."""
    return max(8, int(math.ceil(math.log(tail) / math.log1p(-alpha))))


def _uniform_neighbor(g: Graph, cur: jax.Array, u: jax.Array, starts: jax.Array,
                      u2: jax.Array | None = None):
    """Next node for each walker: uniform (or alias-table weighted)
    out-neighbor, or start if dangling.

    Weighted graphs use Walker's alias method: the uniform draw picks a CSR
    slot, and a second uniform accepts the slot's own target with
    ``alias_prob[slot]`` or redirects to ``alias_other[slot]`` — O(1) exact
    weighted sampling per step (the "alias-table walk kernel")."""
    deg = jnp.take(g.out_deg, cur)
    # floor(u * d) clamped to d-1 guards the u ~= 1.0 edge case
    pick = jnp.minimum((u * deg.astype(jnp.float32)).astype(jnp.int32), deg - 1)
    idx = jnp.take(g.indptr, cur) + jnp.maximum(pick, 0)
    if g.alias_prob is not None:
        assert u2 is not None, "weighted sampling needs a second uniform"
        accept = u2 < jnp.take(g.alias_prob, idx)
        idx = jnp.where(accept, idx, jnp.take(g.alias_other, idx))
    nxt = jnp.take(g.indices, idx)
    return jnp.where(deg > 0, nxt, starts)


@partial(jax.jit, static_argnames=("alpha", "no_zero_hop", "max_steps"))
def random_walks(
    g: Graph,
    starts: jax.Array,       # int32[W] start node per walker
    key: jax.Array,
    alpha: float,
    *,
    no_zero_hop: bool = False,
    max_steps: int | None = None,
) -> jax.Array:
    """Return int32[W] stop node per walker."""
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    w = starts.shape[0]

    weighted = g.alias_prob is not None
    cur = starts
    if no_zero_hop:
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (w,))
        u2 = None
        if weighted:
            key, sub2 = jax.random.split(key)
            u2 = jax.random.uniform(sub2, (w,))
        cur = _uniform_neighbor(g, cur, u, starts, u2)

    def cond(state):
        _, active, _, step = state
        return (step < max_steps) & jnp.any(active)

    def body(state):
        cur_, active, key_, step = state
        key_, k_u = jax.random.split(key_)
        # one uniform per step: u < alpha decides the stop; conditioned on
        # u >= alpha, (u - alpha)/(1 - alpha) is again U[0,1) and drives the
        # neighbor pick (inverse-CDF composition — halves PRNG cost vs two
        # independent draws, identical distribution).
        u = jax.random.uniform(k_u, (w,))
        stop_now = u < alpha
        u_move = (u - alpha) * (1.0 / (1.0 - alpha))
        u2 = None
        if weighted:
            key_, k_u2 = jax.random.split(key_)
            u2 = jax.random.uniform(k_u2, (w,))
        nxt = _uniform_neighbor(g, cur_, u_move, starts, u2)
        moved = jnp.where(active & ~stop_now, nxt, cur_)
        return moved, active & ~stop_now, key_, step + 1

    cur, _, _, _ = jax.lax.while_loop(
        cond, body, (cur, jnp.ones((w,), bool), key, jnp.int32(0))
    )
    return cur


@jax.jit
def accumulate_stops(
    n_pad_template: jax.Array,   # f32[..., n_pad] array to accumulate into
    stops: jax.Array,            # int32[W]
    weights: jax.Array,          # f32[W] per-walk reserve increment
) -> jax.Array:
    """reserve[stop_j] += weight_j for every walker j (scatter-add)."""
    return n_pad_template.at[..., stops].add(weights)


@partial(jax.jit, static_argnames=(
    "alpha", "no_zero_hop", "max_steps", "phase_steps", "compact_factor",
    "num_rows",
))
def weighted_walk_counts(
    g: Graph,
    starts: jax.Array,        # int32[W] start node per walker
    rows: jax.Array,          # int32[W] output row per walker (query index)
    weights: jax.Array,       # f32[W] deposit per walker
    key: jax.Array,
    alpha: float,
    num_rows: int,
    *,
    no_zero_hop: bool = False,
    max_steps: int | None = None,
    phase_steps: int = 16,
    compact_factor: int = 4,
) -> jax.Array:
    """Deposit-weighted walk stop counts with periodic walker compaction.

    Identical semantics to ``random_walks`` + scatter, but executed in
    phases: after every ``phase_steps`` steps the surviving-walker fraction
    has decayed to ~(1-alpha)^phase_steps, so the still-active walkers are
    compacted (stable argsort on the active mask) into a lane array
    ``compact_factor``x narrower, cutting the random-gather traffic that
    dominates walk cost. Stopped walkers deposit their weight at
    their stop node when their phase ends.

    The compacted width is a hard cap: with phase_steps=16 the expected
    survivor fraction is ~7.4% vs a 25% cap, so overflow probability is
    Chernoff-negligible; any overflowed walker (never observed in practice)
    deposits at its current node, biasing that walk by at most its remaining
    geometric tail.
    """
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    w = starts.shape[0]

    counts = jnp.zeros((num_rows, g.n_pad), jnp.float32)

    weighted = g.alias_prob is not None
    cur = starts
    if no_zero_hop:
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (w,))
        u2 = None
        if weighted:
            key, sub2 = jax.random.split(key)
            u2 = jax.random.uniform(sub2, (w,))
        cur = _uniform_neighbor(g, cur, u, starts, u2)

    def run_phase(cur, active, starts_, key_, steps):
        def cond(state):
            _, a, _, step = state
            return (step < steps) & jnp.any(a)

        def body(state):
            c, a, k_, step = state
            k_, k_u = jax.random.split(k_)
            u = jax.random.uniform(k_u, c.shape)
            stop_now = u < alpha
            u_move = (u - alpha) * (1.0 / (1.0 - alpha))
            u2 = None
            if weighted:
                k_, k_u2 = jax.random.split(k_)
                u2 = jax.random.uniform(k_u2, c.shape)
            nxt = _uniform_neighbor(g, c, u_move, starts_, u2)
            c = jnp.where(a & ~stop_now, nxt, c)
            return c, a & ~stop_now, k_, step + 1

        c, a, key_, _ = jax.lax.while_loop(
            cond, body, (cur, active, key_, jnp.int32(0))
        )
        return c, a, key_

    active = jnp.ones((w,), bool)
    rows_, weights_, starts_ = rows, weights, starts
    steps_done = 0
    width = w
    while steps_done < max_steps:
        steps = min(phase_steps, max_steps - steps_done)
        cur, active, key = run_phase(cur, active, starts_, key, steps)
        steps_done += steps
        next_width = max(LANES, width // compact_factor)
        if steps_done >= max_steps:
            # final: everyone deposits where they are (survivors past the cap
            # carry < (1-alpha)^max_steps mass)
            counts = counts.at[rows_, cur].add(weights_)
            break
        if next_width == width:
            continue  # already at minimum width; keep stepping
        # compact the active walkers; everyone else deposits now. A stopped
        # walker deposits its stop node; an overflow active walker (beyond
        # the cap — Chernoff-negligible) deposits its current node.
        order = jnp.argsort(~active, stable=True)[:next_width]
        kept = jnp.zeros((width,), bool).at[order].set(True)
        deposit_mask = ~(kept & active)
        counts = counts.at[rows_, cur].add(
            jnp.where(deposit_mask, weights_, 0.0)
        )
        still = jnp.take(active, order)
        cur = jnp.take(cur, order)
        rows_ = jnp.take(rows_, order)
        weights_ = jnp.where(still, jnp.take(weights_, order), 0.0)
        starts_ = jnp.take(starts_, order)
        active = still
        width = next_width
    return counts


@partial(jax.jit, static_argnames=("cap",))
def expand_walkers(omega_per_node: jax.Array, cap: int):
    """Assign ``cap`` walker slots to nodes: node i gets ``omega_per_node[i]``.

    The FORA walk phases launch ``omega_i = ceil(...)`` walks from every
    residual node v_i (Fora_Whole_Graph.java:119-140, Fora_Topk.java:155-168).
    With data-dependent per-node counts, a fixed pool of ``cap`` walkers is
    distributed by inverting the cumulative sum: walker j belongs to the node
    whose cumsum interval contains j. Returns ``(starts, valid)`` where
    ``starts`` is int32[cap] node ids and ``valid`` masks slots past the total.

    The cumsum is int32: callers must keep each call's walk total < 2^31
    (models/fora._walk_contrib_chunked and MonteCarlo.max_walk_batch chunk
    their phases to guarantee this).
    """
    csum = jnp.cumsum(omega_per_node.astype(jnp.int32))
    total = csum[-1]
    slots = jnp.arange(cap, dtype=jnp.int32)
    starts = jnp.searchsorted(csum, slots, side="right").astype(jnp.int32)
    valid = slots < total
    starts = jnp.minimum(starts, omega_per_node.shape[0] - 1)
    return starts, valid
