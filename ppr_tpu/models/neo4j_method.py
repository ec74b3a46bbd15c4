"""Library-PageRank baseline ("Neo4j method").

Reference: Neo4j_Method.java:67-99 — calls the third-party
``PageRankAlgorithm.of(adjM, 1 - alpha, sourceStream, Pools.DEFAULT, 2, 1)``,
i.e. *personalized* PageRank with damping factor ``d = 1 - alpha`` whose only
accuracy knob is the iteration count, then normalizes scores to sum 1 and
drops zeros (``buildPPRMap``, :80-99). The library iteration ignores
dangling-node mass (it simply leaks and is repaired by the normalization).

Design: the same engine as the power-iteration kernel — a config of
:func:`ppr_tpu.ops.spmv.push_out`:

    x_{t+1} = (1-d) * e_s + d * P^T x_t,    x_0 = (1-d) * e_s

run a static ``iterations`` times, batched over sources, followed by
sum-normalization. Multi-threading via ``Pools.DEFAULT`` (concurrency 2 — the
reference's only parallelism, Neo4j_Method.java:75) is subsumed by the
batched device execution.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.spmv import push_out
from .base import PPRAlgorithm, PreprocessingMixin


@partial(jax.jit, static_argnames=("damping", "iterations"))
def personalized_pagerank_batch(
    g: Graph,
    sources: jax.Array,     # int32[B]
    damping: float,
    iterations: int,
) -> jax.Array:
    src_onehot = jax.nn.one_hot(sources, g.n_pad, dtype=jnp.float32)
    base = (1.0 - damping) * src_onehot

    def body(_, x):
        return base + damping * push_out(g, x)

    x = jax.lax.fori_loop(0, iterations, body, base)
    total = jnp.sum(x, axis=-1, keepdims=True)
    return jnp.where(total > 0, x / total, x)


class Neo4jMethod(PreprocessingMixin, PPRAlgorithm):
    name = "Neo4j-Method"
    prep_dirname = "Neo4j_Method_ppr_results"

    def compute_whole_graph_batch(self, sources: np.ndarray, param) -> np.ndarray:
        return np.asarray(self.compute_whole_graph_device(sources, param))

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        """Device-resident scores (preprocessing compaction consumers skip
        the dense host copy)."""
        damping = 1.0 - self.alpha  # Neo4j damping = 1 - alpha (Neo4j_Method.java:75)
        return personalized_pagerank_batch(
            self.graph, jnp.asarray(sources, jnp.int32), damping, int(param)
        )
