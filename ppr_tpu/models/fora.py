"""FORA — the hybrid push-then-walk PPR algorithms (whole-graph and top-k).

Reference:

* Whole-graph (Fora_Whole_Graph.java:82-146): adaptive rounds of *fresh*
  forward pushes with ``rmax`` halved each round while the accumulated push
  time stays below the predicted walk time ``400ns * rsum * omega``
  (:75-79, :93-103; the constant at :35); then, from every residual node
  v_i, ``omega_i = ceil(r_i' * omega)`` no-zero-hop random walks, each
  adding ``r_i'/omega_i`` to the stop node's reserve (:119-140, after first
  transferring ``alpha*r_i`` to v_i's reserve).
  Parameters: ``rmax0 = eps*sqrt(delta/(3 m ln(2/pfail)))/(1-alpha)``,
  ``omega = (eps+2)*ln(2/pfail)/eps^2/delta`` (:86-87); delta = pfail = 1/n
  (Algo_Conf.java:47-49).

* Top-k (Fora_Topk.java:102-184): eps' = eps/2 (:110); delta annealed from
  1/k down to min_delta = 1/n by /4 per round (:178); each round runs the
  *incremental* forward push at
  ``rmax = eps'*sqrt(delta/(3 m ln(2/pfail))) * 3*sqrt(m*rmax)`` (:124,
  :133 — the reference's schedule, kept as-is), then plain (zero-hop
  allowed) walks from all residual nodes with ``omega_i = ceil(r_i * W)``,
  ``W = omega * rsum * (1-alpha)``, each walk adding ``r_i/omega_i``
  (:148-168); terminate once the k-th reserve >= (1+eps')*delta (:173-176).
  Config: delta0 = 1/k, min_delta = 1/n, pfail = 1/n^2/ln(n/k)
  (Algo_Conf.java:71-77). Note: walk contributions of a round are *not*
  folded back into the persistent push state — each round's result is
  push-reserve + that round's walk estimate (Fora_Topk.java:142-168).

Design: pushes run as batched frontier-masked sweeps; walk phases expand
per-node walk counts into a flat walker pool via cumulative-sum inversion
(:func:`ppr_tpu.ops.walk.expand_walkers`) whose size is a power-of-two bucket
of the actual total (one scalar device->host sync per phase), so recompiles
stay bounded while shapes remain static under jit. The push/walk balance
keeps the reference's wall-clock cost model with per-device rates from
:mod:`ppr_tpu.utils.devices` (the reference hard-codes 400 ns/walk,
Fora_Whole_Graph.java:35).
"""

from __future__ import annotations

import math
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.push import (
    apply_dangling_source_shortcircuit,
    forward_push_init,
    forward_push_sweeps,
)
from ..ops.hub_split import push_out_hybrid_t
from ..ops.spmv import push_out_chunked_t, push_out_t
from ..ops.walk import expand_walkers, weighted_walk_counts
from ..utils.devices import device_rates, memory_budget
from .base import PPRAlgorithm, PreprocessingMixin


def _completion_iters(rsum: float, target: float, alpha: float) -> int:
    if rsum <= target or rsum <= 0:
        return 0
    return int(math.ceil(math.log(target / rsum) / math.log1p(-alpha)))


def _pow2_bucket(x: int) -> int:
    """WALK-POOL bucket: floor 1024 (walk pools are huge; a smaller floor
    just mints extra programs). NOT for batch widths — serving batch
    ladders use :func:`_pow2_width` (floor 8)."""
    return 1 << max(10, int(math.ceil(math.log2(max(x, 1)))))


def _pow2_width(b: int, lo: int = 8) -> int:
    """Serving batch-width bucket (floor 8, matching serving._pow2_bucket
    and _pad_sources' minimum safe width)."""
    w = lo
    while w < b:
        w <<= 1
    return w


#: walk-pool bucket hysteresis: per (n_pad, edges, weighted) graph shape,
#: never shrink below a previously used bucket. A preprocessing sweep's
#: batches have data-dependent walker totals that straddle pow2 boundaries;
#: without hysteresis each crossing mints a NEW XLA program — with it the
#: sweep converges to the largest bucket seen (<= 2x lane waste) and
#: compiles at most O(log) programs over its lifetime.
_WALK_CAP_HIGH_WATER: dict = {}


def _walk_cap(g, total: int) -> int:
    key = (g.n_pad, int(g.edge_src.shape[0]), g.weighted)
    cap = max(_pow2_bucket(total), _WALK_CAP_HIGH_WATER.get(key, 0))
    _WALK_CAP_HIGH_WATER[key] = cap
    return cap


#: program-shape tuples (n_pad, m_pad, weighted, dense, batch, alpha) whose
#: push program has been warmed — bounded by the distinct shapes a process
#: ever runs
_WARMED_PUSH_SHAPES: set = set()

#: walk-phase chunking budget: keep each chunk's walker total comfortably
#: inside int32 (expand_walkers cumsums int32) and inside one walker pool
_WALK_CHUNK_BUDGET = 1 << 28

#: Total annealed-sweep budget for a top-k query, shared by the batch path
#: (:func:`annealed_topk_propagate`) and the cohort ladder
#: (:meth:`ForaTopk.compute_topk_ids_cohorts`) so the two cannot silently
#: drift. Far above any observed train (~40 sweeps on the
#: headline graph); on exhaustion the cohort path logs the give-up.
MAX_TOPK_SWEEPS = 600


def _walk_contrib_chunked(g, om, w, next_key, alpha, no_zero_hop):
    """Residual-weighted walks with int32-overflow-safe accounting.

    ``om`` is int32[B, n_pad]; its *total* can exceed 2^31 on large graphs at
    small eps (>2^31 walks would silently wrap both ``jnp.sum`` and
    expand_walkers' int32 cumsum). Row totals are estimated in float64 on the
    host from per-row float32 partial sums; rows are processed in groups whose
    estimated total stays under ``_WALK_CHUNK_BUDGET`` (with margin), so every
    device-side int32 cumsum is exact. Returns the [B, n_pad] contribution."""
    b = om.shape[0]
    # float32 row sums: a magnitude estimate only (chunk-split decisions);
    # the exact int32 cumsum inside each chunk drives walker validity
    row_est = np.asarray(jnp.sum(om.astype(jnp.float32), axis=-1),
                         dtype=np.float64)
    total_est = float(row_est.sum())
    if total_est <= _WALK_CHUNK_BUDGET:
        total = int(jnp.sum(om))
        if total <= 0:
            return jnp.zeros_like(w)
        return _walk_contrib(g, om, w, next_key(), alpha,
                             _walk_cap(g, total), no_zero_hop)
    out = jnp.zeros_like(w)
    lo = 0
    margin = 1.01
    while lo < b:
        hi = lo + 1
        acc = row_est[lo] * margin
        while hi < b and acc + row_est[hi] * margin <= _WALK_CHUNK_BUDGET:
            acc += row_est[hi] * margin
            hi += 1
        # group height is pow2-bucketed and the offset is a traced scalar,
        # so the data-dependent group boundaries never mint new XLA
        # programs
        hb = max(8, 1 << int(math.ceil(math.log2(hi - lo))))
        passes = max(1, int(math.ceil(
            row_est[lo:hi].sum() * margin / _WALK_CHUNK_BUDGET
        )))
        for j in range(passes):
            # split om into `passes` integer parts summing exactly to om;
            # per-walk weight is unchanged, so the passes just partition the
            # same walk population
            total = int(_group_pass_total(
                om, jnp.int32(lo), jnp.int32(hi), hb, jnp.int32(passes),
                jnp.int32(j)
            ))
            if total > 0:
                out = out + _walk_contrib_rows(
                    g, om, w, next_key(), alpha, _walk_cap(g, total), hb,
                    no_zero_hop, jnp.int32(lo), jnp.int32(hi),
                    jnp.int32(passes), jnp.int32(j),
                )
        lo = hi
    return out


def _group_pass_rows(om, row_lo, row_hi, hb, passes, pass_j):
    """The (row group, pass) walk-count partition: `hb` rows gathered at
    traced offset ``row_lo`` (rows at/past the group end ``row_hi`` are
    zeroed — they belong to other groups), split into ``passes`` integer
    parts that sum exactly to om."""
    b = om.shape[0]
    rows = row_lo + jnp.arange(hb, dtype=jnp.int32)
    valid = rows < row_hi
    rows_c = jnp.minimum(rows, b - 1)
    om_c = jnp.take(om, rows_c, axis=0) * valid[:, None]
    om_j = om_c // passes + ((om_c % passes) > pass_j).astype(om_c.dtype)
    return om_j, rows, valid, rows_c


@partial(jax.jit, static_argnames=("hb",))
def _group_pass_total(om, row_lo, row_hi, hb, passes, pass_j):
    """Exact walker total of one (row group, pass) — int32-safe because the
    chunking loop keeps every group/pass under _WALK_CHUNK_BUDGET."""
    om_j, _, _, _ = _group_pass_rows(om, row_lo, row_hi, hb, passes, pass_j)
    return jnp.sum(om_j)


@partial(jax.jit, static_argnames=("alpha", "cap", "hb", "no_zero_hop"))
def _walk_contrib_rows(g, om, w, key, alpha, cap, hb, no_zero_hop,
                       row_lo, row_hi, passes, pass_j):
    """One group/pass of the chunked walk phase as a shape-stable program:
    only O(log B x log cap) distinct (hb, cap) shapes ever compile."""
    b = om.shape[0]
    om_j, rows, valid, rows_c = _group_pass_rows(om, row_lo, row_hi, hb,
                                                 passes, pass_j)
    w_c = jnp.take(w, rows_c, axis=0)
    contrib = _walk_contrib(g, om_j, w_c, key, alpha, cap, no_zero_hop)
    # scatter the group's rows back; padding rows target index b -> dropped
    out_rows = jnp.where(valid, rows, b)
    return jnp.zeros_like(w).at[out_rows].add(contrib, mode="drop")


def _pad_sources(sources, min_b: int = 8):
    """Pad a source batch to >= 8 rows (with node 0), so that every batch
    below 8 shares one compiled program. Callers slice results back to the
    true batch."""
    sources = np.asarray(sources)
    b = len(sources)
    if b >= min_b:
        return sources, b
    return np.concatenate(
        [sources, np.zeros(min_b - b, sources.dtype if sources.size else np.int32)]
    ), b


@partial(jax.jit, static_argnames=("alpha", "cap", "no_zero_hop"))
def _walk_contrib(
    g: Graph,
    omega_i: jax.Array,       # int32[B, n_pad] walks per (row, node)
    weight_i: jax.Array,      # f32[B, n_pad] reserve increment per walk
    key: jax.Array,
    alpha: float,
    cap: int,
    no_zero_hop: bool,
) -> jax.Array:
    """Run sum(omega_i) walks (capped) and scatter weighted stops -> [B, n_pad]."""
    b, n_pad = omega_i.shape
    flat = omega_i.reshape(-1)
    slots, valid = expand_walkers(flat, cap)          # slot -> flat (row, node)
    rows = slots // n_pad
    starts = (slots % n_pad).astype(jnp.int32)
    w = weight_i.reshape(-1)[slots] * valid.astype(jnp.float32)
    return weighted_walk_counts(
        g, starts, rows, w, key, alpha, num_rows=b, no_zero_hop=no_zero_hop
    )


@partial(jax.jit, static_argnames=("alpha", "max_iters", "num_chunks"))
def residual_propagate(
    g: Graph,
    p: jax.Array,            # f32[B, n_pad]
    r: jax.Array,            # f32[B, n_pad]
    src_onehot: jax.Array,   # f32[B, n_pad]
    target: jax.Array,       # f32 scalar: stop once every row's rsum <= target
    alpha: float,
    max_iters: int = 400,
    hs=None,                 # optional ops.hub_split.HubSplit (1.8x per sweep)
    num_chunks: int = 1,     # >1: chunked per-edge gather (huge graphs)
):
    """Deterministic residual completion: synchronous propagation iterations
    (p += alpha*r; r <- (1-alpha) P^T r, dangling mass back to the source —
    the Power_Method.java:55-100 step) until the residue mass is below
    ``target``. Mathematically this computes the same quantity FORA's random
    walks estimate — pi(residual) = sum_i r_i * pi(v_i, .) — exactly instead
    of by sampling, with truncation error per node bounded by the remaining
    rsum. Which completion is cheaper on a device is the cost model's call
    (:class:`_ForaCostModel`): batched SpMV streams memory, per-walker
    stepping is bound by dependent random gathers."""
    alpha = jnp.float32(alpha)
    # node-major state [n_pad, B]: per-edge gathers read contiguous [B] rows
    # and no transpose is materialized inside the loop (one in, one out)
    is_dangling = ((g.out_deg == 0) & (g.node_mask > 0))[:, None]
    p_t, r_t = p.T, r.T
    src_t = src_onehot.T

    def cond(state):
        _, r_, it = state
        return (it < max_iters) & (jnp.max(jnp.sum(r_, axis=0)) > target)

    def body(state):
        p_, r_, it = state
        p_ = p_ + alpha * r_
        rem = (1.0 - alpha) * r_
        # dangling rows need no zeroing before the push: every SpMV backend
        # scales sources by _safe_inv_deg (0 at d_out=0) or has no edges for
        # them, so their contribution is structurally zero — the masked
        # reduce below is the only dangling work per sweep (one fused pass)
        dang_mass = jnp.sum(
            jnp.where(is_dangling, rem, 0.0), axis=0, keepdims=True
        )
        if hs is not None:
            pushed = push_out_hybrid_t(g, hs, rem, num_chunks=num_chunks)
        elif num_chunks > 1:
            pushed = push_out_chunked_t(g, rem, num_chunks=num_chunks)
        else:
            pushed = push_out_t(g, rem)
        r_ = pushed + dang_mass * src_t
        return p_, r_, it + 1

    p_t, r_t, iters = jax.lax.while_loop(cond, body, (p_t, r_t, jnp.int32(0)))
    return p_t.T, r_t.T, iters


@partial(jax.jit, static_argnames=("alpha", "k", "max_iters", "num_chunks",
                                   "early_exit", "early_check_every"))
def annealed_topk_propagate(
    g: Graph,
    p: jax.Array,            # f32[B, n_pad]
    r: jax.Array,            # f32[B, n_pad]
    src_onehot: jax.Array,   # f32[B, n_pad]
    eps: jax.Array,          # f32 scalar (eps' = eps/2 already applied)
    delta0: float,
    min_delta: float,
    k: int,
    alpha: float,
    max_iters: int = MAX_TOPK_SWEEPS,
    hs=None,                 # optional ops.hub_split.HubSplit
    num_chunks: int = 1,     # >1: chunked per-edge gather (huge graphs)
    early_exit: bool = False,
    early_check_every: int = 8,
):
    """The whole FORA top-k delta-annealing loop fused into one while_loop.

    Per iteration: one propagation step. Whenever the residue settles below
    the current round's target ``eps*delta`` (the same decision points as the
    round-structured loop), the termination rule is evaluated — "k-th reserve
    >= (1+eps')*delta" expressed as the equivalent cheap count
    ``#{v: p_v >= (1+eps')*delta} >= k`` (Fora_Topk.java:173-176) — and
    delta anneals by /4 (:178) until min_delta. Runs entirely on device:
    no host synchronization, no per-round dispatch.

    ``early_exit=True`` (the serving latency fast path) adds a SOUND set-
    stability certificate checked every ``early_check_every`` sweeps: the
    reserve only grows (p += alpha*r, r >= 0) and the total future deposit
    into any single node is bounded by the row's remaining residue mass, so
    once ``kth(p) > (k+1)th(p) + rsum_row`` no outsider can enter the top-k
    — the id set equals the fully-annealed run's exactly (values are lower
    bounds within rsum). Boundary ties never certify (strict gap), falling
    back to the reference stopping rule.
    """
    alpha_f = jnp.float32(alpha)
    # node-major state [n_pad, B] — see residual_propagate
    is_dangling = ((g.out_deg == 0) & (g.node_mask > 0))[:, None]
    p_t, r_t = p.T, r.T
    src_t = src_onehot.T
    kk = min(k + 1, g.n_pad)

    def row_done(p_, delta):
        thresh = (1.0 + eps) * delta
        return jnp.sum((p_ >= thresh).astype(jnp.int32), axis=0) >= k

    def set_stable(p_, r_):
        """Per-row certificate: the current top-k id set is final."""
        if kk <= k:              # k >= n: every node is in the set
            return jnp.bool_(True)
        rsum_row = jnp.sum(r_, axis=0)                      # [B]
        vals, _ = jax.lax.top_k(p_.T, kk)                   # [B, k+1]
        return jnp.all(vals[:, k - 1] > vals[:, kk - 1] + rsum_row)

    def cond(state):
        _, _, delta, finished, it = state
        return (it < max_iters) & ~finished

    def body(state):
        p_, r_, delta, finished, it = state
        p_ = p_ + alpha_f * r_
        rem = (1.0 - alpha_f) * r_
        # dangling rows contribute nothing through any SpMV backend (see
        # residual_propagate.body) — one fused masked reduce is enough
        dang_mass = jnp.sum(
            jnp.where(is_dangling, rem, 0.0), axis=0, keepdims=True
        )
        if hs is not None:
            pushed = push_out_hybrid_t(g, hs, rem, num_chunks=num_chunks)
        elif num_chunks > 1:
            pushed = push_out_chunked_t(g, rem, num_chunks=num_chunks)
        else:
            pushed = push_out_t(g, rem)
        r_ = pushed + dang_mass * src_t

        settled = jnp.max(jnp.sum(r_, axis=0)) <= eps * delta
        # the termination count only matters on settle sweeps (the same
        # decision points as the reference's round loop) — lax.cond skips
        # the full [n_pad, B] row_done pass on every other sweep
        done = jax.lax.cond(
            settled,
            lambda: jnp.all(row_done(p_, delta)),
            lambda: jnp.bool_(False),
        )
        if early_exit:
            done = done | jax.lax.cond(
                (it + 1) % early_check_every == 0,
                lambda: set_stable(p_, r_),
                lambda: jnp.bool_(False),
            )
        at_floor = delta <= min_delta
        finished = done | (settled & at_floor)
        delta = jnp.where(
            settled & ~finished, jnp.maximum(min_delta, delta / 4.0), delta
        )
        return p_, r_, delta, finished, it + 1

    p_t, r_t, delta, _, iters = jax.lax.while_loop(
        cond, body,
        (p_t, r_t, jnp.float32(delta0), jnp.bool_(False), jnp.int32(0)),
    )
    return p_t.T, r_t.T, iters


@partial(jax.jit, static_argnames=("alpha", "k", "num_chunks",
                                   "early_exit", "early_check_every"))
def annealed_topk_propagate_perrow(
    g: Graph,
    p: jax.Array,            # f32[B, n_pad]
    r: jax.Array,            # f32[B, n_pad]
    src_onehot: jax.Array,   # f32[B, n_pad]
    eps: jax.Array,          # f32 scalar (eps' = eps/2 already applied)
    delta: jax.Array,        # f32[B]: per-row annealing state
    finished: jax.Array,     # bool[B]: rows already retired (resumable)
    live_floor: jax.Array,   # i32 scalar: stop once live rows <= floor
    min_delta: float,
    k: int,
    alpha: float,
    max_iters=MAX_TOPK_SWEEPS,  # i32 scalar (TRACED: the ladder passes the
                             # remaining total budget per stage — a static
                             # arg would mint a program per stage)
    hs=None,
    num_chunks: int = 1,
    early_exit: bool = False,
    early_check_every: int = 8,
):
    """Per-row variant of :func:`annealed_topk_propagate` for cohort
    serving (the latency-floor mechanism).

    Each row anneals on its OWN schedule — exactly the reference's
    single-query loop (Fora_Topk.java:123-179) applied row-wise: a row's
    delta divides by 4 when ITS residue settles below eps*delta_row, and
    the row retires when its own stopping rule fires. The batch-global
    variant instead holds every row until the LAST row finishes, which
    sets the serving latency floor at the slowest row's sweep train; here
    the loop exits as soon as the number of live (unfinished) rows drops
    to ``live_floor``, so the caller can retire finished rows' futures,
    compact the stragglers into a half-width program, and continue from
    the returned state (fully resumable: pass back p/r/delta/finished).

    Returns (p, r, delta, finished, iters).
    """
    alpha_f = jnp.float32(alpha)
    is_dangling = ((g.out_deg == 0) & (g.node_mask > 0))[:, None]
    p_t, r_t = p.T, r.T
    src_t = src_onehot.T
    kk = min(k + 1, g.n_pad)

    def row_done(p_, delta_):
        thresh = (1.0 + eps) * delta_                       # [B]
        return jnp.sum((p_ >= thresh[None, :]).astype(jnp.int32),
                       axis=0) >= k                         # [B]

    def set_stable(p_, r_):
        """Per-row certificate: row's top-k id set is final (see
        annealed_topk_propagate's docstring for the soundness argument)."""
        if kk <= k:
            return jnp.ones((p_.shape[1],), jnp.bool_)
        rsum_row = jnp.sum(r_, axis=0)                      # [B]
        vals, _ = jax.lax.top_k(p_.T, kk)                   # [B, k+1]
        return vals[:, k - 1] > vals[:, kk - 1] + rsum_row  # [B]

    def cond(state):
        _, _, _, finished_, it = state
        live = jnp.sum((~finished_).astype(jnp.int32))
        return (it < max_iters) & (live > live_floor)

    def body(state):
        p0, r0, delta_, finished_, it = state
        p_ = p0 + alpha_f * r0
        rem = (1.0 - alpha_f) * r0
        dang_mass = jnp.sum(
            jnp.where(is_dangling, rem, 0.0), axis=0, keepdims=True
        )
        if hs is not None:
            pushed = push_out_hybrid_t(g, hs, rem, num_chunks=num_chunks)
        elif num_chunks > 1:
            pushed = push_out_chunked_t(g, rem, num_chunks=num_chunks)
        else:
            pushed = push_out_t(g, rem)
        r_ = pushed + dang_mass * src_t
        # freeze retired rows: their result must equal the single-row
        # run's (stop exactly at the sweep whose rule fired), independent
        # of how long the stage keeps running for the straggler rows
        p_ = jnp.where(finished_[None, :], p0, p_)
        r_ = jnp.where(finished_[None, :], r0, r_)

        settled = (jnp.sum(r_, axis=0) <= eps * delta_) & ~finished_  # [B]
        # per-row termination at the row's own settle points; the full
        # [n_pad, B] row_done pass only runs when some row settled
        done = jax.lax.cond(
            jnp.any(settled),
            lambda: settled & row_done(p_, delta_),
            lambda: jnp.zeros_like(finished_),
        )
        if early_exit:
            done = done | jax.lax.cond(
                (it + 1) % early_check_every == 0,
                lambda: set_stable(p_, r_),
                lambda: jnp.zeros_like(finished_),
            )
        at_floor = delta_ <= min_delta
        finished_ = finished_ | done | (settled & at_floor)
        delta_ = jnp.where(
            settled & ~finished_,
            jnp.maximum(min_delta, delta_ / 4.0), delta_,
        )
        return p_, r_, delta_, finished_, it + 1

    p_t, r_t, delta, finished, iters = jax.lax.while_loop(
        cond, body, (p_t, r_t, delta, finished, jnp.int32(0)),
    )
    return p_t.T, r_t.T, delta, finished, iters


@jax.jit
def _cohort_compact(p, r, src_onehot, delta, sources_j, sel):
    """Gather the straggler rows into the half-width continuation (one
    fused program per (W, W/2) shape pair instead of five eager takes)."""
    return (jnp.take(p, sel, axis=0), jnp.take(r, sel, axis=0),
            jnp.take(src_onehot, sel, axis=0), jnp.take(delta, sel),
            jnp.take(sources_j, sel))


@partial(jax.jit, static_argnames=("kcap",))
def _device_topk_epilogue(g: Graph, sources: jax.Array, p: jax.Array,
                          src_onehot: jax.Array, kcap: int):
    """Dangling-source short-circuit + device top-(kcap) selection.

    One fused program so the host receives only ``[B, kcap]`` values/ids —
    the dense ``[B, n_pad]`` result never crosses the device->host link.
    kcap > k leaves room for the reference's tie expansion (ids with value
    == k-th are all returned)."""
    deg_src = jnp.take(g.out_deg, sources)[:, None]
    p = jnp.where(deg_src == 0, src_onehot, p)
    vals, ids = jax.lax.top_k(p, kcap)
    return vals, ids


@partial(jax.jit, static_argnames=("k",))
def _kth_over_support(p: jax.Array, k: int) -> jax.Array:
    """Per-row k-th largest positive value; 0.0 when support < k (the
    reference's kth_ppr-null-means-0.0, Fora_Topk.java:171-172 — which also
    covers k > n: an invalid k never terminates the annealing early)."""
    vals, _ = jax.lax.top_k(p, min(k, p.shape[-1]))
    kth = vals[..., -1]
    support = jnp.sum((p > 0).astype(jnp.int32), axis=-1)
    return jnp.where(support >= k, kth, 0.0)


@jax.jit
def _whole_graph_walk_setup(r: jax.Array, omega: jax.Array):
    """reserve += alpha*r; r' = (1-alpha)*r; omega_i = ceil(r'*omega);
    per-walk weight r'/omega_i (Fora_Whole_Graph.java:119-140)."""
    r1 = r  # caller passes r' already scaled
    om = jnp.where(r1 > 0, jnp.ceil(r1 * omega), 0.0).astype(jnp.int32)
    w = jnp.where(om > 0, r1 / jnp.maximum(om, 1).astype(jnp.float32), 0.0)
    return om, w


class _ForaCostModel:
    """Shared push/walk/SpMV balance model (both FORA variants).

    Rates and budgets come from the device table
    (:mod:`ppr_tpu.utils.devices`); install values measured on the live
    graph via :mod:`ppr_tpu.utils.calibrate`."""

    hub_split = None
    #: byte budget of the per-edge gather intermediate [m_pad, B]; above it
    #: the propagation loops process edges in sequential chunks. None: the
    #: device table's share of device memory
    spmv_intermediate_budget = None
    #: the same for the hub-split tail gather — see _num_chunks
    hybrid_tail_budget = None
    #: set by PreprocessingMixin.preprocessing around the sweep: the
    #: completion choice must then price the per-row compaction transfer
    _in_preprocessing = False

    def _num_chunks(self, batch: int) -> int:
        # hybrid path gathers only the tail — but at the 1M-node scale the
        # post-hub tail times a wide batch can still overflow device
        # memory, so size the chunk count from the ACTUAL gathered edge
        # count. The hybrid tail gets its own larger budget, so that the
        # headline and 1M-node configurations run their tails unchunked.
        rates = device_rates()
        if self.hub_split is not None:
            m_eff = int(self.hub_split.tail_src.shape[0])
            budget = self.hybrid_tail_budget or memory_budget(
                rates.hybrid_tail_budget_frac)
        else:
            m_eff = self.graph.m_pad
            budget = self.spmv_intermediate_budget or memory_budget(
                rates.spmv_budget_frac)
        bytes_ = m_eff * max(batch, 1) * 4
        return max(1, -(-bytes_ // budget))

    def enable_hub_split(self, num_hubs: int | str = "auto",
                         dtype=None) -> None:
        """Build and use the dense-hub hybrid SpMV in the propagation
        kernels (~1.8x per sweep on power-law graphs; see ops/hub_split.py).

        ``dtype=jnp.bfloat16`` halves the hub matrix's memory traffic and
        runs the matmul at the bf16 rate (f32 accumulation); ~2^-9 relative
        error on hub columns — far inside FORA's eps budget."""
        from ..ops.hub_split import build_hub_split

        kwargs = {} if dtype is None else {"dtype": dtype}
        self.hub_split = build_hub_split(self.graph, num_hubs, **kwargs)

    def calibrate(self, **kwargs):
        """Measure real per-walk / per-edge costs on this device+graph and
        install them (replaces the device table's rates)."""
        from ..utils import calibrate as _cal

        constants = _cal.measure(self.graph, alpha=self.alpha, **kwargs)
        _cal.apply(self, constants)
        return constants

    def _init_cost_constants(self) -> None:
        rates = device_rates()
        self.avg_rand_walk_time_ns = rates.walk_ns
        self.spmv_ns_per_edge = rates.spmv_ns_per_edge
        self.spmv_batch_amortized = rates.spmv_batch_amortized
        #: device->host rate pricing the preprocessing compaction transfer
        self.d2h_bytes_per_s = rates.d2h_bytes_per_s

    def _spmv_completion_ns(self, rsum: float, target: float,
                            batch: int) -> float:
        """Estimated per-query cost of deterministic completion."""
        iters = _completion_iters(rsum, target, self.alpha)
        per_batch = iters * self.spmv_ns_per_edge * max(self.graph.m, 1)
        return per_batch / max(batch, 1) if self.spmv_batch_amortized \
            else per_batch

    def _use_spmv(self, omega: float, rsum: float, target: float,
                  batch: int = 1) -> bool:
        if self.completion != "auto":
            return self.completion == "spmv"
        walk_cost = self.avg_rand_walk_time_ns * omega * rsum
        spmv_cost = self._spmv_completion_ns(rsum, target, batch)
        if self._in_preprocessing:
            # the all-pair sweep ships each row's positive entries through
            # the device->host link: exact spmv completion makes nearly
            # every reachable entry positive (nnz ~ n/row) while the walk
            # estimator's support is bounded by its walk count. On a slow
            # link this transfer, not compute, dominates the sweep, so the
            # auto choice must price it.
            per_entry_ns = 8 * 1e9 / float(self.d2h_bytes_per_s)
            spmv_cost += self.graph.n * per_entry_ns
            walk_cost += min(float(self.graph.n), omega * rsum) * per_entry_ns
        return spmv_cost < walk_cost


class ForaWholeGraph(PreprocessingMixin, _ForaCostModel, PPRAlgorithm):
    name = "FORA"
    prep_dirname = "FORA_ppr_results"

    def __init__(self, dataset, alpha: float, *, delta: float | None = None,
                 pfail: float | None = None, seed: int = 0,
                 max_push_rounds: int = 30, fresh_rounds: bool = False,
                 completion: str = "auto"):
        super().__init__(dataset, alpha, seed=seed)
        n = dataset.graph.n
        self.delta = delta if delta is not None else 1.0 / n
        self.pfail = pfail if pfail is not None else 1.0 / n
        self.max_push_rounds = max_push_rounds
        #: residual completion strategy: "walks" (the reference's randomized
        #: estimator, Fora_Whole_Graph.java:119-140), "spmv" (deterministic
        #: batched residue propagation — exact), or "auto" (FORA's own cost
        #: model with per-device rates)
        self.completion = completion
        self._init_cost_constants()
        #: True replicates the reference exactly (a *fresh* push from r = e_s
        #: every round, Fora_Whole_Graph.java:94-100); False continues each
        #: round from the previous fixpoint — reaching an equivalent fixpoint
        #: (push is confluent) with strictly less device work.
        self.fresh_rounds = fresh_rounds

    def compute_whole_graph_batch(self, sources: np.ndarray, param) -> np.ndarray:
        if len(sources) == 0:
            return np.zeros((0, self.graph.n_pad), np.float32)
        p = self.compute_whole_graph_device(sources, param)
        return np.asarray(p)[: len(sources)]

    def compute_whole_graph_device(self, sources: np.ndarray,
                                   param) -> "jax.Array":
        """Device-resident reserve [B_pad, n_pad]; rows past ``len(sources)``
        are padding (consumers that select on device — preprocessing
        compaction — skip the dense host copy)."""
        eps = float(param)
        g = self.graph
        sources, _ = _pad_sources(sources)
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        rmax = eps * math.sqrt(self.delta / 3.0 / m / ln_term) / (1.0 - self.alpha)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta

        sources_j = jnp.asarray(sources, jnp.int32)
        b = len(sources)

        # --- part 1: adaptive fresh pushes (Fora_Whole_Graph.java:93-103) ---
        rsum_local = 1.0
        push_ns = 0.0
        p, r, src_onehot = forward_push_init(g, sources_j)
        # untimed warmup so first-call jit compilation never pollutes the
        # push/completion cost balance — once per
        # program shape, not per call (steady-state calls skip the discarded
        # extra push entirely). The key mirrors what the XLA compile cache
        # keys on — array shapes/dtypes + static args — so two graphs with
        # identical shapes correctly share one warmup
        warm_key = (g.n_pad, int(g.edge_src.shape[0]), g.weighted,
                    g.has_dense, b, self.alpha)
        if warm_key not in _WARMED_PUSH_SHAPES:
            jax.block_until_ready(forward_push_sweeps(
                g, p, r, src_onehot, jnp.float32(rmax), self.alpha
            ))
            _WARMED_PUSH_SHAPES.add(warm_key)
        first = True
        rounds = 0
        completion_target = eps * self.delta
        while (
            push_ns < min(
                self.avg_rand_walk_time_ns * rsum_local * omega,
                self._spmv_completion_ns(rsum_local, completion_target, b),
            )
            and rounds < self.max_push_rounds
        ):
            t0 = time.perf_counter_ns()
            if first or not self.fresh_rounds:
                p0, r0 = p, r
            else:
                p0, r0, src_onehot = forward_push_init(g, sources_j)
            first = False
            p, r, _ = forward_push_sweeps(
                g, p0, r0, src_onehot, jnp.float32(rmax), self.alpha
            )
            jax.block_until_ready(r)
            push_ns += (time.perf_counter_ns() - t0) / b  # per-query cost
            rsum_row = np.asarray(r.sum(axis=-1))
            rsum_local = float(rsum_row.mean()) * (1.0 - self.alpha)
            rmax /= 2.0
            rounds += 1

        # --- part 2: residual completion ---
        # target residual mass for the deterministic completion: eps*delta
        # keeps the per-node truncation error within FORA's eps*pi bound for
        # every pi >= delta.
        target = eps * self.delta
        rsum_now = float(np.asarray(r.sum(axis=-1)).max())
        if self._use_spmv(omega, rsum_now, target, b):
            p, r, _ = residual_propagate(
                g, p, r, src_onehot, jnp.float32(target), self.alpha,
                hs=self.hub_split, num_chunks=self._num_chunks(b),
            )
        else:
            # the reference's randomized estimator: residual-weighted
            # no-zero-hop walks (Fora_Whole_Graph.java:119-140)
            r1 = (1.0 - self.alpha) * r
            p = p + self.alpha * r
            om, w = _whole_graph_walk_setup(r1, jnp.float32(omega))
            p = p + _walk_contrib_chunked(
                g, om, w, self.next_key, self.alpha, True
            )

        p, _ = apply_dangling_source_shortcircuit(
            g, sources_j, p, jnp.zeros_like(p), src_onehot
        )
        return p


class ForaTopk(_ForaCostModel, PPRAlgorithm):
    name = "FORA-Topk"

    def __init__(self, dataset, alpha: float, k: int, *, seed: int = 0,
                 completion: str = "auto", push: str = "auto",
                 early_exit: bool = False):
        super().__init__(dataset, alpha, seed=seed)
        n = dataset.graph.n
        # Algo_Conf.set_conf_fora_topk (Algo_Conf.java:71-77)
        self.k = int(k)
        self.min_delta = 1.0 / n
        self.delta0 = 1.0 / self.k
        self.pfail = 1.0 / n / n / math.log(max(n / self.k, math.e))
        self.completion = completion
        #: serving fast path: stop the annealed loop as soon as the top-k id
        #: SET is provably final (see annealed_topk_propagate's certificate)
        #: — ids match the full run exactly; values are lower bounds
        self.early_exit = early_exit
        #: push-phase strategy: "reference" (the incremental rmax-schedule
        #: pushes of Fora_Topk.java:123-145), "none" (skip pushes — with SpMV
        #: completion every sweep costs a full SpMV anyway, so annealed
        #: incremental propagation alone is strictly cheaper), or
        #: "auto" (skip pushes exactly when SpMV completion is selected).
        self.push = push
        self._init_cost_constants()

    def compute_topk_batch(self, sources: np.ndarray, k: int, param) -> np.ndarray:
        """Dense [B, n_pad] top-k scores (host copy — O(B*n) transfer).

        For serving, prefer :meth:`compute_topk_ids_batch`, which ships only
        ``[B, K]`` across the device->host link."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        sources, b = _pad_sources(sources)
        result, sources_j, src_onehot = self._compute_topk_device(
            sources, k, param
        )
        result, _ = apply_dangling_source_shortcircuit(
            g, sources_j, result, jnp.zeros_like(result), src_onehot
        )
        return np.asarray(result)[:b]

    def compute_topk_ids_batch(self, sources: np.ndarray, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: returns (values [B, K], ids [B, K]) numpy, selected
        on device — only O(B*K) crosses the device->host link.

        K = ``kcap`` (default min(max(4k, k+32), n_pad)) leaves room for the
        reference's tie semantics (every id with value == k-th is part of
        the answer, Forward_Push.java:413-429); consumers expand ties from
        the returned slack columns."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        sources, b = _pad_sources(sources)
        result, sources_j, src_onehot = self._compute_topk_device(
            sources, k, param
        )
        kcap = int(kcap) if kcap else min(max(4 * k, k + 32), g.n_pad)
        kcap = min(kcap, g.n_pad)
        vals, ids = _device_topk_epilogue(g, sources_j, result, src_onehot,
                                          kcap)
        return np.asarray(vals)[:b], np.asarray(ids)[:b]

    def compute_topk_ids_cohorts(self, sources: np.ndarray, k: int, param,
                                 *, kcap: int | None = None):
        """Streaming serving path (the latency-floor mechanism): yields
        ``(orig_indices, vals, ids)`` cohorts as rows RETIRE, instead of
        holding every row until the slowest finishes.

        Mechanism: the per-row annealed loop
        (:func:`annealed_topk_propagate_perrow`) runs at the pow2 width
        ``W`` until at most ``W/2`` rows are still live, the finished
        rows are emitted (their futures can resolve now), the stragglers
        are compacted into a ``W/2``-wide continuation of the SAME state
        (p/r/delta carry over), and so on down the ladder — O(log B)
        program shapes total, all of which a serving deployment compiles
        anyway. Each row's trajectory is identical to a single-row run
        (per-row annealing + freeze-at-finish), so the emitted ids/values
        match :meth:`compute_topk_ids_batch` row-for-row in per-row
        semantics; reference stopping rule per Fora_Topk.java:173-179.

        Falls back to one terminal cohort when the cost model picks the
        push+walks path (sampling has no per-row incremental state to
        carry across widths).
        """
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        sources = np.asarray(sources)
        b = len(sources)
        if b == 0:
            return
        eps = float(param) * 0.5      # eps' = eps/2 (Fora_Topk.java:110)
        ln_term = math.log(2.0 / self.pfail)
        omega0 = (eps + 2.0) * ln_term / eps / eps / self.delta0
        kcap_v = int(kcap) if kcap else min(max(4 * k, k + 32), g.n_pad)
        kcap_v = min(kcap_v, g.n_pad)
        skip_push = self.push == "none" or (
            self.push == "auto"
            and self._use_spmv(omega0, 1.0, eps * self.delta0, b)
        )
        if not skip_push:
            vals, ids = self.compute_topk_ids_batch(sources, k, param,
                                                    kcap=kcap_v)
            yield np.arange(b), vals, ids
            return

        budget = MAX_TOPK_SWEEPS      # TOTAL sweep budget across all
        iters_used = 0                # stages — same cap as the solo path
        W = _pow2_width(b)
        padded = np.zeros(W, np.int64)
        padded[:b] = sources
        sources_j = jnp.asarray(padded, jnp.int32)
        p, r, src_onehot = forward_push_init(g, sources_j)
        p = jnp.zeros_like(p)
        delta = jnp.full((W,), jnp.float32(self.delta0))
        fin0 = np.zeros(W, bool)
        fin0[b:] = True               # pad rows never emit
        finished_j = jnp.asarray(fin0)
        orig = np.full(W, -1, np.int64)
        orig[:b] = np.arange(b)

        while True:
            live_floor = W // 2 if W > 8 else 0
            p, r, delta, finished_j, iters = annealed_topk_propagate_perrow(
                g, p, r, src_onehot, jnp.float32(eps), delta, finished_j,
                jnp.int32(live_floor), self.min_delta, k, self.alpha,
                max_iters=budget - iters_used, hs=self.hub_split,
                num_chunks=self._num_chunks(W),
                early_exit=self.early_exit,
            )
            fin = np.asarray(finished_j).copy()
            iters_used += int(iters)
            gave_up = iters_used >= budget and not fin.all()
            if gave_up:
                # unconverged rows are emitted for parity with the batch
                # path's hard cap, but a streaming consumer deserves the
                # signal
                n_unconv = int((~fin & (orig >= 0)).sum())
                print(f"ppr_tpu.fora: cohort sweep budget {budget} "
                      f"exhausted with {n_unconv} unconverged row(s); "
                      f"emitting current estimates", file=sys.stderr,
                      flush=True)
            emit_mask = (fin if not gave_up else np.ones(W, bool)) \
                & (orig >= 0)
            if emit_mask.any():
                vals, ids = _device_topk_epilogue(
                    g, sources_j, p, src_onehot, kcap_v
                )
                idxs = orig[emit_mask]
                yield (idxs, np.asarray(vals)[emit_mask],
                       np.asarray(ids)[emit_mask])
            if fin.all() or gave_up:
                return
            # compact stragglers into the pow2 ceiling of the live count
            # (NOT just W/2: when many rows retire in one sweep, jumping
            # straight down skips no-op intermediate stages — each would
            # be a full program dispatch)
            live_idx = np.nonzero(~fin)[0]
            new_w = _pow2_width(len(live_idx))
            sel = np.concatenate([
                live_idx,
                np.full(new_w - len(live_idx), live_idx[0], live_idx.dtype),
            ])
            sel_j = jnp.asarray(sel, jnp.int32)
            p, r, src_onehot, delta, sources_j = _cohort_compact(
                p, r, src_onehot, delta, sources_j, sel_j
            )
            nf = np.zeros(new_w, bool)
            nf[len(live_idx):] = True  # compaction dups never emit
            finished_j = jnp.asarray(nf)
            new_orig = np.full(new_w, -1, np.int64)
            new_orig[: len(live_idx)] = orig[live_idx]
            orig = new_orig
            W = new_w

    def _compute_topk_device(self, sources: np.ndarray, k: int, param):
        """Shared device-side computation; returns (result, sources_j,
        src_onehot) with ``result`` still on device and WITHOUT the
        dangling-source short-circuit applied."""
        eps = float(param) * 0.5      # eps' = eps/2 (Fora_Topk.java:110)
        g = self.graph
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        sources_j = jnp.asarray(sources, jnp.int32)

        p, r, src_onehot = forward_push_init(g, sources_j)
        p = jnp.zeros_like(p)
        delta = self.delta0
        result = p

        omega0 = (eps + 2.0) * ln_term / eps / eps / delta
        skip_push = self.push == "none" or (
            self.push == "auto"
            and self._use_spmv(omega0, 1.0, eps * delta, len(sources))
        )
        if skip_push:
            # serving path: the whole annealed incremental
            # propagation loop fused into one device while_loop (exact within
            # the eps*delta truncation bound, no sampling variance, no host
            # round-trips). Same decision points and stopping rule as the
            # round-structured reference loop (Fora_Topk.java:123-179).
            p, r, _ = annealed_topk_propagate(
                g, p, r, src_onehot, jnp.float32(eps),
                delta, self.min_delta, k, self.alpha, hs=self.hub_split,
                num_chunks=self._num_chunks(len(sources)),
                early_exit=self.early_exit,
            )
            return p, sources_j, src_onehot

        while True:
            rmax = eps * math.sqrt(delta / 3.0 / m / ln_term)
            rmax *= math.sqrt(m * rmax) * 3.0     # reference schedule, Fora_Topk.java:133
            omega = (eps + 2.0) * ln_term / eps / eps / delta

            # incremental push continues from persistent (p, r) state
            p, r, _ = forward_push_sweeps(
                g, p, r, src_onehot, jnp.float32(rmax), self.alpha
            )

            rsum_rw = float(np.asarray(r.sum(axis=-1)).mean()) * (1.0 - self.alpha)
            target = eps * delta
            if self._use_spmv(omega, rsum_rw, target, len(sources)):
                # deterministic completion of this round's residue (on copies:
                # like the reference, round estimates are NOT folded back into
                # the persistent push state, Fora_Topk.java:142-168)
                round_p, _, _ = residual_propagate(
                    g, p, r, src_onehot, jnp.float32(target), self.alpha,
                    hs=self.hub_split,
                    num_chunks=self._num_chunks(len(sources)),
                )
            else:
                num_walk = omega * rsum_rw
                om = jnp.where(
                    r > 0, jnp.ceil(r * num_walk), 0.0
                ).astype(jnp.int32)
                w = jnp.where(
                    om > 0, r / jnp.maximum(om, 1).astype(jnp.float32), 0.0
                )
                round_p = p + _walk_contrib_chunked(
                    g, om, w, self.next_key, self.alpha, False
                )
            result = round_p

            # termination (Fora_Topk.java:173-178): kth reserve >= (1+eps')*delta
            kth = np.asarray(_kth_over_support(round_p, k))
            if np.all(kth >= (1.0 + eps) * delta) or delta <= self.min_delta:
                break
            delta = max(self.min_delta, delta / 4.0)

        return result, sources_j, src_onehot

    # cost-model methods (_spmv_completion_ns / _use_spmv) come from
    # _ForaCostModel


    def compute_whole_graph_batch(self, sources, param):  # top-k only algo
        return self.compute_topk_batch(sources, self.k, param)


