"""Monte-Carlo PPR (alpha-terminated random walks).

Reference: Monte_Carlo.java — ``computeWholeGraphPPR`` (:136-158) launches
``omega = 3*ln(2/pfail)/eps^2/delta`` walks from the source (:145) and
estimates ``pi(s,v)`` as the fraction of walks stopping at v (:156-157).
Top-k re-uses the whole-graph estimate thresholded with ties
(:303-319 via computeTopKPPR :283-287). Parameter: ``epsilon``.

Design: all ``B * omega`` walks run in lockstep through the vectorized
walk kernel (:mod:`ppr_tpu.ops.walk`); stop counts are one scatter-add into a
``[B, n_pad]`` matrix. omega is derived from static Python floats, so the
walker array shape is static under jit.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.walk import weighted_walk_counts
from .base import PPRAlgorithm, PreprocessingMixin


def mc_num_walks(eps: float, delta: float, pfail: float) -> int:
    """omega = 3*ln(2/pfail)/eps^2/delta (Monte_Carlo.java:145)."""
    return int(math.ceil(3.0 * math.log(2.0 / pfail) / eps / eps / delta))


@partial(jax.jit, static_argnames=("alpha", "w_pad"))
def mc_whole_graph_batch(
    g: Graph,
    sources: jax.Array,     # int32[B]
    key: jax.Array,
    alpha: float,
    omega: jax.Array,       # int32 scalar (dynamic: shared compiled program)
    w_pad: int,
) -> jax.Array:
    """B*omega walks; the walker pool is padded to ``w_pad`` (a power-of-two
    bucket chosen by the caller) with zero-weight walkers, and ``omega`` is a
    *traced* scalar — so every epsilon in a parameter sweep whose walker
    total lands in the same bucket shares one compiled program."""
    b = sources.shape[0]
    omega = jnp.int32(omega)
    slots = jnp.arange(w_pad, dtype=jnp.int32)
    rows = jnp.minimum(slots // omega, b - 1)
    starts = jnp.take(sources, rows)
    valid = slots < b * omega
    weights = jnp.where(valid, 1.0 / omega.astype(jnp.float32), 0.0)
    return weighted_walk_counts(
        g, starts, rows, weights, key, alpha, num_rows=b
    )


class MonteCarlo(PreprocessingMixin, PPRAlgorithm):
    name = "Monte-Carlo"
    prep_dirname = "MC_ppr_results"

    def __init__(self, dataset, alpha: float, *, delta: float | None = None,
                 pfail: float | None = None, seed: int = 0,
                 max_walk_batch: int = 4_000_000):
        super().__init__(dataset, alpha, seed=seed)
        n = dataset.graph.n
        # Algo_Conf.set_conf_mc (Algo_Conf.java:29-34): delta = pfail = 1/n
        self.delta = delta if delta is not None else 1.0 / n
        self.pfail = pfail if pfail is not None else 1.0 / n
        self.max_walk_batch = max_walk_batch

    def _source_chunk(self, param) -> int:
        """Sources per device call keeping the walker pool within budget."""
        omega = mc_num_walks(float(param), self.delta, self.pfail)
        return max(1, self.max_walk_batch // omega)

    def compute_whole_graph_batch(self, sources: np.ndarray, param) -> np.ndarray:
        # stream chunks through the host so device memory peaks at one
        # chunk's [chunk, n_pad] output (the chunk loop's whole purpose)
        sources = np.asarray(sources)
        per_chunk = self._source_chunk(param)
        outs = [
            np.asarray(
                self.compute_whole_graph_device(sources[lo:lo + per_chunk],
                                                param)
            )
            for lo in range(0, len(sources), per_chunk)
        ]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        """Device-resident scores for ONE chunk-sized batch (preprocessing
        clamps its batch to :meth:`_source_chunk`, so compaction consumers
        never force multiple chunk outputs to coexist in HBM)."""
        eps = float(param)
        omega = mc_num_walks(eps, self.delta, self.pfail)
        sources = np.asarray(sources)
        per_chunk = self._source_chunk(param)
        outs = []
        for lo in range(0, len(sources), per_chunk):
            chunk = jnp.asarray(sources[lo:lo + per_chunk], jnp.int32)
            total = int(chunk.shape[0]) * omega
            w_pad = 1 << max(10, math.ceil(math.log2(total)))
            outs.append(
                mc_whole_graph_batch(
                    self.graph, chunk, self.next_key(), self.alpha,
                    omega, w_pad,
                )
            )
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)

    def _prep_batch(self, param, batch_size: int = 128) -> int:
        # clamp so the device path is always single-chunk (memory budget);
        # the mixin's preprocessing / warm / resume checks all route here
        return min(batch_size, self._source_chunk(param))
