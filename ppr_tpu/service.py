"""High-level PPR retrieval service — the user-facing serving API.

The reference is a batch benchmark driven from one main() (PPR.java:154);
this wraps the engine into the retrieval-service shape a production user
wants: load a graph once, then answer batched top-k / whole-graph PPR
queries, optionally against a precomputed all-pair store.

    svc = PPRService.from_dataset(load_got(), alpha=0.15)
    hits = svc.top_k([3, 14, 50], k=10)      # list of [(node, score, name)]
    dense = svc.whole_graph([3])             # np.ndarray [B, n]

Algorithm selection mirrors the engine defaults: the FORA top-k serving
path (annealed deterministic propagation on the device) for top-k, FORA
whole-graph for dense scores; ``algorithm=`` overrides with any AlgoType.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph.io import Dataset
from .models import AlgoConf, AlgoType
from .ops.topk import topk_ids_with_ties


@dataclasses.dataclass
class TopKHit:
    node: int
    score: float
    name: str


class PPRService:
    def __init__(self, dataset: Dataset, alpha: float = 0.15, *,
                 eps: float = 0.5, k: int = 10, seed: int = 0,
                 algorithm: AlgoType = AlgoType.FORA_TOPK,
                 hub_split: int | None = None, hub_dtype=None,
                 calibrate: bool = False, mesh=None,
                 precomputed: tuple | None = None,
                 early_exit: bool = False, mesh_engine: str = "edge",
                 cohort: bool = False, frontier_blocks: int | None = None):
        """``hub_split=H`` enables the dense-hub hybrid SpMV with H hubs in
        the FORA serving kernels (bf16 hub matrix unless ``hub_dtype``
        overrides; ``hub_split="auto"`` picks the count from the device
        table's rates). ``calibrate=True`` measures the real per-walk /
        per-edge costs on this device+graph at startup instead of the
        device table's rates. ``mesh`` (a
        ``jax.sharding.Mesh`` with 'data'/'graph' axes) runs the FORA
        top-k serving path on the mesh via
        :class:`~ppr_tpu.parallel.sharded_fora.ShardedForaTopk`.
        ``precomputed=(threshold, k)`` serves every query from an existing
        BASE all-pair store — pure precomputed reads, the reference's BASE
        query mode (Base_Whole_Graph.java:167-186) as a service.
        ``early_exit=True`` enables the top-k set-stability fast exit in
        the annealed serving loop (ids exact, values lower bounds — see
        annealed_topk_propagate). ``mesh_engine`` picks the mesh layout:
        "edge" (throughput; node state replicated) or "node" (O(n/S)
        memory per device via the ring-exchange engine). ``cohort=True``
        enables the streaming serving path (:meth:`top_k_stream`): rows
        retire as soon as THEIR annealed loop finishes instead of waiting
        for the slowest row in the dispatch (the latency-floor
        mechanism)."""
        self.dataset = dataset
        self.eps = eps
        self.k = k
        self._cohort = bool(cohort)
        conf = AlgoConf(alpha, seed=seed)
        if precomputed is not None:
            conflicts = [name for name, v in (
                ("mesh", mesh), ("hub_split", hub_split),
                ("calibrate", calibrate or None),
                ("cohort", cohort or None),
                ("frontier_blocks", frontier_blocks),
            ) if v is not None] + (
                ["algorithm"] if algorithm != AlgoType.FORA_TOPK else []
            )
            if conflicts:
                raise ValueError(
                    f"precomputed= serves pure BASE store reads; "
                    f"{', '.join(conflicts)} would be silently ignored — "
                    f"drop them or drop precomputed"
                )
            thr, pk = (precomputed if isinstance(precomputed, (tuple, list))
                       else (precomputed, -1))
            base = conf.new_algo_obj(AlgoType.BASE_WHOLE_GRAPH, dataset, k)
            base.attach_store(thr, pk, alpha=alpha)
            self._topk_algo = self._wg_algo = base
            return
        if frontier_blocks is not None and (
                mesh is None or mesh_engine != "node"):
            # loud, like the precomputed= conflicts: frontier compaction
            # only exists on the node-sharded ring
            raise ValueError(
                "frontier_blocks requires mesh= and mesh_engine='node' "
                "(the ring-exchange engine); drop it or switch engines"
            )
        if mesh is not None and algorithm == AlgoType.FORA_TOPK:
            if mesh_engine == "node":
                # O(n/S)-memory engine: node dimension PARTITIONED over the
                # 'graph' axis (graphs beyond one device's HBM)
                from .parallel.node_sharded_fora import NodeShardedForaTopk

                # frontier_blocks=C compacts the ring payload to the C
                # highest-mass degree-sorted column blocks per sweep
                # (parallel/node_sharded_fora.py; exact deferral)
                self._topk_algo = NodeShardedForaTopk(
                    dataset, alpha=alpha, k=k, mesh=mesh,
                    frontier_blocks=frontier_blocks,
                )
            elif mesh_engine == "edge":
                from .parallel.sharded_fora import ShardedForaTopk

                self._topk_algo = ShardedForaTopk(dataset, alpha=alpha, k=k,
                                                  mesh=mesh)
            else:
                raise ValueError(
                    f"mesh_engine must be 'edge' or 'node', got "
                    f"{mesh_engine!r}"
                )
        else:
            self._topk_algo = conf.new_algo_obj(algorithm, dataset, k)
        if early_exit:
            if not hasattr(self._topk_algo, "early_exit"):
                what = ("the mesh engines" if mesh is not None
                        else str(algorithm))
                raise ValueError(
                    f"early_exit is only supported by the single-device "
                    f"FORA top-k serving engine, not {what}"
                )
            self._topk_algo.early_exit = True
        if cohort and not hasattr(self._topk_algo, "compute_topk_ids_cohorts"):
            what = "the mesh engines" if mesh is not None else str(algorithm)
            raise ValueError(
                f"cohort streaming is only supported by the single-device "
                f"FORA top-k serving engine, not {what}"
            )
        self._wg_algo = conf.new_algo_obj(
            AlgoType.FORA_WHOLE_GRAPH
            if algorithm == AlgoType.FORA_TOPK else algorithm,
            dataset, k,
        )
        if hub_split and dataset.graph.weighted:
            # loud, like the precomputed= conflicts above: a user asking for
            # the measured-fastest config must not silently get the slow path
            # (the hybrid SpMV has no weighted variant, ops/hub_split.py)
            raise ValueError(
                "hub_split= is unsupported on weighted graphs (the dense-hub "
                "hybrid SpMV only covers uniform 1/d edge weights) — drop "
                "hub_split or load the graph unweighted"
            )
        if hub_split:
            import jax.numpy as jnp

            from .ops.hub_split import build_hub_split

            dtype = hub_dtype if hub_dtype is not None else jnp.bfloat16
            hs = None  # build once, share: the matrix can be gigabytes
            for algo in (self._topk_algo, self._wg_algo):
                if hasattr(algo, "enable_hub_split"):
                    if hs is None:
                        hs = build_hub_split(dataset.graph, hub_split,
                                             dtype=dtype)
                    algo.hub_split = hs
        if calibrate:
            constants = None
            for algo in (self._topk_algo, self._wg_algo):
                if hasattr(algo, "calibrate"):
                    if constants is None:
                        constants = algo.calibrate()
                    else:  # same backend+graph: reuse the measurement
                        from .utils import calibrate as _cal

                        _cal.apply(algo, constants)

    @classmethod
    def from_dataset(cls, dataset: Dataset, **kwargs) -> "PPRService":
        return cls(dataset, **kwargs)

    def top_k(self, sources, k: int | None = None,
              eps: float | None = None) -> list[list[TopKHit]]:
        """Batched top-k PPR; per source a descending list of hits (ties
        beyond k included, reference semantics)."""
        k = k or self.k
        sources = np.asarray(sources)
        eps = eps or self.eps
        algo = self._topk_algo
        if hasattr(algo, "compute_topk_ids_batch"):
            # serving path: device-side selection, O(B*K) host transfer
            vals, ids = algo.compute_topk_ids_batch(sources, k, eps)
            return self._hits_from_ids(vals, ids, k, sources, eps)
        scores = algo.compute_topk_batch(sources, k, eps)
        out = []
        for row in np.asarray(scores):
            ids = topk_ids_with_ties(row, k)
            out.append([
                TopKHit(int(v), float(row[v]), self.dataset.names[int(v)])
                for v in ids
            ])
        return out

    def _hits_from_ids(self, vals, ids, k: int, sources: np.ndarray,
                       eps: float) -> list[list[TopKHit]]:
        """Device-selected (vals, ids) windows -> per-row hit lists with
        reference tie semantics; rare rows whose tie set overflows the
        selection window fall back to the dense path."""
        algo = self._topk_algo
        out = []
        dense_rows = []
        for b, (vrow, irow) in enumerate(zip(vals, ids)):
            sup = vrow > 0.0
            v, i = vrow[sup], irow[sup]
            if v.size > k:
                keep = v >= v[k - 1]
                v, i = v[keep], i[keep]
            # tie set may extend past the selection window (every window
            # slot kept): fall back to the dense path for such rare rows
            if v.size == vrow.size and vrow.size and vrow[-1] > 0.0:
                dense_rows.append(b)
                out.append(None)
            else:
                out.append([
                    TopKHit(int(n), float(s), self.dataset.names[int(n)])
                    for s, n in zip(v, i)
                ])
        if dense_rows:
            scores = algo.compute_topk_batch(sources[dense_rows], k, eps)
            for b, row in zip(dense_rows, np.asarray(scores)):
                row_ids = topk_ids_with_ties(row, k)
                out[b] = [
                    TopKHit(int(v), float(row[v]), self.dataset.names[int(v)])
                    for v in row_ids
                ]
        return out

    @property
    def n_nodes(self) -> int:
        """Graph node count — lets the serving layer spread prewarm probe
        sources over real nodes instead of W copies of one source."""
        return int(self.dataset.graph.n)

    @property
    def supports_stream(self) -> bool:
        """True when :meth:`top_k_stream` is usable (cohort=True and the
        engine has the per-row cohort serving path)."""
        return self._cohort and hasattr(
            self._topk_algo, "compute_topk_ids_cohorts"
        )

    def top_k_stream(self, sources, k: int | None = None,
                     eps: float | None = None, *, emit) -> None:
        """Streaming top-k: calls ``emit(orig_indices, hits_rows)`` as
        row cohorts RETIRE — a fast row's answer arrives without waiting
        for the slowest row in the batch (per-row annealed completion,
        ForaTopk.compute_topk_ids_cohorts). Requires ``cohort=True``."""
        if not self.supports_stream:
            raise RuntimeError(
                "top_k_stream requires PPRService(cohort=True) with the "
                "single-device FORA top-k engine"
            )
        k = k or self.k
        eps_v = eps or self.eps
        sources = np.asarray(sources)
        for idxs, vals, ids in self._topk_algo.compute_topk_ids_cohorts(
                sources, k, eps_v):
            emit(idxs, self._hits_from_ids(vals, ids, k, sources[idxs],
                                           eps_v))

    def whole_graph(self, sources, eps: float | None = None) -> np.ndarray:
        """Dense PPR rows [B, n] (padding trimmed)."""
        sources = np.asarray(sources)
        scores = self._wg_algo.compute_whole_graph_batch(
            sources, eps or self.eps
        )
        return np.asarray(scores)[:, : self.dataset.n]
