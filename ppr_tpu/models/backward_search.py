"""Backward Search (single-target reverse push) — building block of BASE.

Reference: Backward_Search.java:38-100 — reverse push from a target t over
incoming edges: settle ``pi(v,t) += alpha*r(v,t)``, propagate
``r(u,t) += (1-alpha)*r(v,t)/d_out(u)`` to each in-neighbor u, with the
strict gate ``r > rmax`` (:89-94) and the in-degree-0 short-circuit
``pi(t,t) = 1`` (:46-49). The reference class implements no capability
interface — it is only driven by Base_Whole_Graph — and the same holds here:
:class:`BackwardSearch` exposes the batched kernel used by
:mod:`ppr_tpu.models.base_allpair`.

Design: a ``[T, n_pad]`` residue matrix runs masked reverse sweeps for T
targets simultaneously (:func:`ppr_tpu.ops.push.backward_push_sweeps`) — the
reference loops over targets one at a time (Base_Whole_Graph.java:76-92).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.push import apply_zero_indeg_target_shortcircuit, backward_push_sweeps


@jax.jit
def backward_search_batch(
    g: Graph,
    targets: jax.Array,       # int32[T]
    rmax: jax.Array,          # f32 scalar
    alpha: float,
):
    """Returns (reserve, residue): f32[T, n_pad] each; reserve[t_row, v] ~ pi(v, t)."""
    tgt_onehot = jax.nn.one_hot(targets, g.n_pad, dtype=jnp.float32)
    p = jnp.zeros_like(tgt_onehot)
    p, r, _ = backward_push_sweeps(g, p, tgt_onehot, rmax, alpha)
    p, r = apply_zero_indeg_target_shortcircuit(g, targets, p, r, tgt_onehot)
    return p, r


class BackwardSearch:
    def __init__(self, graph: Graph, alpha: float, rmax: float):
        self.graph = graph
        self.alpha = float(alpha)
        self.rmax = float(rmax)
        self.duration_ns = 0  # accumulated, as Backward_Search.java:36,:98-99

    def whole_graph(self, targets: np.ndarray) -> np.ndarray:
        """pi(., t) for a batch of targets — rows indexed by target."""
        import time

        p = self.whole_graph_device(targets)  # accounts its own duration
        t0 = time.perf_counter_ns()
        out = np.asarray(p)
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def whole_graph_device(self, targets: np.ndarray) -> jax.Array:
        """Device-resident reserve [T, n_pad] — consumers that select on
        device (BASE threshold compaction) avoid the dense host copy."""
        import time

        t0 = time.perf_counter_ns()
        p, _ = backward_search_batch(
            self.graph,
            jnp.asarray(targets, jnp.int32),
            jnp.float32(self.rmax),
            self.alpha,
        )
        p.block_until_ready()
        self.duration_ns += time.perf_counter_ns() - t0
        return p

    def get_duration(self) -> int:
        return self.duration_ns
