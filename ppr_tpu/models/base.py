"""Algorithm base classes and capability interfaces.

Parity with the reference's three capability contracts:

* ``Whole_Graph_Util_Interface`` (Whole_Graph_Util_Interface.java:5-12):
  ``computeWholeGraphPPR`` / ``getWholeGraphPPR`` / ``printWholeGraphResult``
* ``Topk_Util_Interface`` (Topk_Util_Interface.java:5-15):
  ``computeTopKPPR`` / ``getTopKNodeIds`` / ``printTopKResult``
* ``Preprocessing_Interface`` (Preprocessing_Interface.java:3-16):
  ``preprocessing`` / ``readPreprocessedPPR`` / ``getPrepSize`` /
  ``deletePrepDir``

The engine's native query unit is a *batch* of sources — algorithms
implement ``compute_whole_graph_batch`` / ``compute_topk_batch`` returning
dense ``[B, n_pad]`` score matrices, and the single-query reference-style
methods are thin adapters over a batch of one. Results are dense arrays;
``get_whole_graph_ppr`` exposes the sparse dict view the reference returns
from its HashMaps (support = strictly positive entries).
"""

from __future__ import annotations

import numpy as np
import jax

from ..graph.io import Dataset
from ..ops.topk import topk_ids_with_ties


class PPRAlgorithm:
    """Shared state: dataset handle, alpha, deterministic RNG, last results."""

    name = "ppr"

    def __init__(self, dataset: Dataset, alpha: float, *, seed: int = 0):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self._key = jax.random.key(seed)
        self._last_scores: np.ndarray | None = None   # [n_pad]
        self._last_topk_scores: np.ndarray | None = None

    # --- RNG -------------------------------------------------------------
    def next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    # --- batched API (the device-native surface) -------------------------
    def compute_whole_graph_batch(self, sources: np.ndarray, param) -> np.ndarray:
        raise NotImplementedError

    def compute_topk_batch(self, sources: np.ndarray, k: int, param) -> np.ndarray:
        """Default: whole-graph scores; top-k is a selection over them
        (the reference pattern for MC / Forward Push / Power Method)."""
        return self.compute_whole_graph_batch(sources, param)

    # --- Whole_Graph_Util_Interface parity --------------------------------
    def compute_whole_graph_ppr(self, source: int, param) -> None:
        batch = self.compute_whole_graph_batch(np.asarray([source]), param)
        self._last_scores = np.asarray(batch[0])
        self._last_topk_scores = None

    def get_whole_graph_ppr(self) -> dict[int, float]:
        scores = self._require(self._last_scores)
        support = np.nonzero(scores > 0.0)[0]
        return {int(v): float(scores[v]) for v in support}

    def get_whole_graph_dense(self) -> np.ndarray:
        return self._require(self._last_scores)

    def print_whole_graph_result(self) -> None:
        scores = self._require(self._last_scores)
        order = topk_ids_with_ties(scores, scores.size)
        print(f"{self.name} PPR:")
        for v in order:
            print(f"@{self.dataset.names[int(v)]}\t{scores[int(v)]}")

    # --- Topk_Util_Interface parity ---------------------------------------
    def compute_topk_ppr(self, source: int, k: int, param) -> None:
        batch = self.compute_topk_batch(np.asarray([source]), k, param)
        self._last_topk_scores = np.asarray(batch[0])
        self._last_scores = self._last_topk_scores

    def get_topk_node_ids(self, k: int) -> np.ndarray:
        scores = self._require(
            self._last_topk_scores if self._last_topk_scores is not None
            else self._last_scores
        )
        return topk_ids_with_ties(scores, k)

    def print_topk_result(self, k: int) -> None:
        ids = self.get_topk_node_ids(k)[:k]
        scores = self._require(self._last_scores)
        print(f"\n{self.name}-Top{k} PPR:")
        for v in ids:
            print(f"@{self.dataset.names[int(v)]}\t{scores[int(v)]}")

    @staticmethod
    def _require(arr):
        if arr is None:
            raise RuntimeError("no PPR computed yet")
        return arr


class PreprocessingMixin:
    """Preprocessing_Interface parity backed by :class:`ppr_tpu.utils.store.PPRStore`.

    The reference preprocessing loop (e.g. Monte_Carlo.preprocessing,
    Monte_Carlo.java:181-232) runs the whole-graph algorithm on *every* node
    sequentially and writes one text file per source; here sources are
    processed in device batches and persisted as npz shards with a resume
    manifest (see utils/store.py).
    """

    prep_dirname: str = "PREP_ppr_results"
    _store = None

    def make_store(self, param):
        from ..utils.store import PPRStore
        import os

        root = os.path.join(self.prep_dirname, self.dataset.name, str(param))
        return PPRStore(root, n=self.graph.n_pad)

    def _prep_batch(self, param, batch_size: int = 128) -> int:
        """The source-batch height the sweep will actually use (algorithms
        with per-call walker budgets clamp it — e.g. MonteCarlo); the warm
        pass and the resume check must agree with it."""
        return batch_size

    def _prep_pending(self, param, batch_size: int = 128) -> bool:
        """True when preprocessing(param) would do device work: the store is
        finalized (reference semantics re-preprocess from scratch — reset()
        wipes it) or some batch shard is missing. The harness skips the
        compile warm-up for fully resumable stores."""
        store = self.make_store(param)
        if store._read_manifest().get("finalized"):
            return True
        bs = self._prep_batch(param, batch_size)
        return any(
            not store.has_batch(s) for s in range(0, self.graph.n, bs)
        )

    def preprocessing(self, threshold, param, *, batch_size: int = 128,
                      progress: bool = True) -> None:
        from ..utils.report import progress_printer

        batch_size = self._prep_batch(param, batch_size)
        store = self.make_store(param)
        store.reset()
        n = self.graph.n
        report = progress_printer(n, enabled=progress)
        # cost models must price the per-row compaction transfer while the
        # sweep runs (see _ForaCostModel._use_spmv)
        self._in_preprocessing = True
        try:
            self._preprocessing_sweep(store, param, batch_size, report)
        finally:
            self._in_preprocessing = False
        store.finalize(alpha=self.alpha)
        self._store = store

    def _preprocessing_sweep(self, store, param, batch_size, report):
        n = self.graph.n
        # algorithms exposing a device-resident whole-graph path get their
        # positive entries selected ON DEVICE (ops/compact.py) — the dense
        # [B, n_pad] host copy per batch is the all-pair sweep's bottleneck
        # on big graphs (the device->host link runs ~20-25 MB/s here)
        compute_dev = getattr(self, "compute_whole_graph_device", None)
        for start in range(0, n, batch_size):
            if store.has_batch(start):
                continue
            sources = np.arange(start, min(start + batch_size, n))
            if compute_dev is not None:
                from ..ops.compact import threshold_nonzeros

                p_dev = compute_dev(sources, param)
                # strict `> 0` keep — identical to write_batch's host path
                rows, cols, vals = threshold_nonzeros(
                    p_dev, self.graph.node_mask, 0.0,
                    rows=len(sources), exclusive=True,
                )
                counts = np.bincount(rows, minlength=len(sources))
                ptr = np.concatenate([[0], np.cumsum(counts)])
                store.write_batch_ordered(
                    start, sources,
                    [cols[ptr[i]:ptr[i + 1]].astype(np.int32)
                     for i in range(len(sources))],
                    [vals[ptr[i]:ptr[i + 1]] for i in range(len(sources))],
                )
            else:
                scores = self.compute_whole_graph_batch(sources, param)
                store.write_batch(start, sources, np.asarray(scores))
            report(min(start + batch_size, n) - 1)

    def warm_preprocessing(self, threshold, param, *,
                           batch_size: int = 128) -> None:
        """Compile-warm the preprocessing programs: run ONE source batch
        through the same compute + device-compaction path ``preprocessing``
        times, discarding the result. First-param prep rows used to be
        compile-dominated (e.g. got 1.5 BASE 10,803 ms vs ~34 ms warm); the
        harness calls this untimed first (mirroring its query warmup)."""
        n = self.graph.n
        sources = np.arange(min(self._prep_batch(param, batch_size), n))
        compute_dev = getattr(self, "compute_whole_graph_device", None)
        self._in_preprocessing = True   # warm the PREP-mode program choice
        try:
            if compute_dev is not None:
                from ..ops.compact import threshold_nonzeros

                p_dev = compute_dev(sources, param)
                threshold_nonzeros(p_dev, self.graph.node_mask, 0.0,
                                   rows=len(sources), exclusive=True)
            else:
                self.compute_whole_graph_batch(sources, param)
        finally:
            self._in_preprocessing = False

    def attach_store(self, param) -> None:
        """Attach a previously persisted store (a fresh process answering
        queries against an existing preprocessing run — the reference's
        readPreprocessedPPR-without-recompute usage)."""
        self._store = self.make_store(param)

    def read_preprocessed_ppr(self, source: int, param=None) -> None:
        if self._store is None:
            if param is None:
                raise RuntimeError(
                    "no store attached: run preprocessing() or "
                    "attach_store(param) first"
                )
            self.attach_store(param)
        self._last_scores = self._store.read_row(int(source))
        self._last_topk_scores = None

    def get_prep_size(self) -> int:
        return self._store.size_bytes() if self._store else 0

    def delete_prep_dir(self) -> None:
        if self._store:
            self._store.delete()
