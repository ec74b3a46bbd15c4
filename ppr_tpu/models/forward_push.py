"""Forward Push algorithm (local push from the source).

Reference: Forward_Push.java — whole-graph variant at :63-142 (queue-driven
residue/reserve updates gated by r(v)/d_out(v) >= rmax) and the resumable
top-k variant at :144-250 (reused by FORA top-k). Parameter: ``rmax``.

Design: the queue becomes the frontier-masked synchronous sweep kernel
(:func:`ppr_tpu.ops.push.forward_push_sweeps`), batched over sources. The
whole-graph fixpoint (no node above the gate; dangling residue returned to
the source) matches the reference's invariants; top-k is the whole-graph
result thresholded with ties, exactly as Forward_Push.computeTopKPPR
(:389-394) simply delegates to the whole-graph computation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.push import (
    apply_dangling_source_shortcircuit,
    forward_push_init,
    forward_push_sweeps,
)
from .base import PPRAlgorithm, PreprocessingMixin


class ForwardPush(PreprocessingMixin, PPRAlgorithm):
    name = "Forward-Push"
    prep_dirname = "FWP_ppr_results"

    _last_rsum_dev = None

    def compute_whole_graph_batch(self, sources: np.ndarray, param) -> np.ndarray:
        return np.asarray(self.compute_whole_graph_device(sources, param))

    def compute_whole_graph_device(self, sources: np.ndarray, param):
        """Device-resident reserve (preprocessing compaction consumers skip
        the dense host copy). Only the per-row residue SUM is retained for
        :meth:`residue_sum` — keeping the dense residue would pin a
        [B, n_pad] buffer in HBM across calls."""
        rmax = float(param)
        sources_j = jnp.asarray(sources, jnp.int32)
        p, r, src_onehot = forward_push_init(self.graph, sources_j)
        p, r, _ = forward_push_sweeps(
            self.graph, p, r, src_onehot, jnp.float32(rmax), self.alpha
        )
        p, r = apply_dangling_source_shortcircuit(
            self.graph, sources_j, p, r, src_onehot
        )
        self._last_rsum_dev = jnp.sum(r, axis=-1)
        return p

    def residue_sum(self) -> np.ndarray:
        """Per-row residue mass after the last push (the reference's
        ``getUpdatedRsum``, Forward_Push.java:252-254)."""
        return np.asarray(self._last_rsum_dev)
