"""Power-method ground truth (the oracle for every accuracy metric).

Reference: Power_Method.java:44-100 — 100 synchronous residue-propagation
iterations: every node with residue transfers alpha*r to its reserve and
(1-alpha)*r/d_out to each out-neighbor; a dangling node returns its
(1-alpha)*r to the *source* (Power_Method.java:74-80). Top-k is the
whole-graph result thresholded at the k-th value with ties
(Power_Method.java:145-165).

Design: the per-iteration HashMap scatter becomes one
:func:`ppr_tpu.ops.spmv.push_out_t` application over a ``[n_pad, B]``
residue matrix — on small graphs a dense ``[n, n] x [n, B]`` matmul at
``Precision.HIGHEST`` — iterated a static 100 times under
``lax.fori_loop``, batched over all B query sources at once (the reference
recomputes the oracle per query sequentially, Gen_Util.java:154).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.csr import Graph
from ..ops.spmv import push_out_t
from .base import PPRAlgorithm


def power_method_batch(g, sources, alpha, iterations: int = 100):
    """Dense f32[B, n_pad] PPR for a batch of sources (see `_power_method_jit`).

    Pads the batch up to 8 rows, so that every batch below 8 shares one
    compiled program."""
    sources = jnp.asarray(sources, jnp.int32)
    b = sources.shape[0]
    if b == 0:
        return jnp.zeros((0, g.n_pad), jnp.float32)
    pad = max(0, 8 - b)
    if pad:
        sources = jnp.concatenate(
            [sources, jnp.zeros((pad,), jnp.int32)]
        )
    out = _power_method_jit(g, sources, alpha, iterations)
    return out[:b] if pad else out


@partial(jax.jit, static_argnames=("alpha", "iterations"))
def _power_method_jit(
    g: Graph,
    sources: jax.Array,       # int32[B]
    alpha: float,
    iterations: int = 100,
) -> jax.Array:
    """Dense f32[B, n_pad] PPR for each source via synchronous propagation.

    Runs node-major ([n_pad, B] state) like the serving loops: contiguous
    per-edge gathers, no per-iteration transposes (see ops/spmv.push_out_t).
    """
    src_onehot = jax.nn.one_hot(sources, g.n_pad, dtype=jnp.float32)
    is_dangling = ((g.out_deg == 0) & (g.node_mask > 0))[:, None]
    src_t = src_onehot.T

    def body(_, state):
        p, r = state
        p = p + alpha * r
        rem = (1.0 - alpha) * r
        rem_dang = jnp.where(is_dangling, rem, 0.0)
        dang_mass = jnp.sum(rem_dang, axis=0, keepdims=True)
        r = push_out_t(g, rem - rem_dang) + dang_mass * src_t
        return p, r

    p0 = jnp.zeros_like(src_t)
    p, _ = jax.lax.fori_loop(0, iterations, body, (p0, src_t))
    return p.T


class PowerMethod(PPRAlgorithm):
    name = "Exact"

    def __init__(self, dataset, alpha: float, *, iterations: int = 100,
                 seed: int = 0):
        super().__init__(dataset, alpha, seed=seed)
        self.iterations = iterations

    def compute_whole_graph_batch(self, sources: np.ndarray, param=None) -> np.ndarray:
        return np.asarray(power_method_batch(
            self.graph, jnp.asarray(sources, jnp.int32), self.alpha,
            self.iterations,
        ))
