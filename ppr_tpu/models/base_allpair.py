"""BASE — All-Pair-Backward-Search preprocessing + file-read query path.

Reference: Base_Whole_Graph.java — ``preprocessing`` (:58-165) runs
Backward_Search with ``rmax = threshold`` on *every* node as target
(:76-92), keeps only ``pi(v,t) >= threshold`` transposed into per-source
rows, and writes one file per source: the raw (target-ascending) list for
whole-graph mode (k < 0, :120-132) or the top-k-with-ties list sorted
descending for top-k mode (:133-162). Queries are pure file reads
(``computeWholeGraphPPR`` :167-186; ``getTopKNodeIds`` returns file order,
:207-210).

Design: targets are processed in device batches of T simultaneous
reverse pushes (``[T, n_pad]`` residue matrix — the reference does one
target at a time), transposed/thresholded on the host, and persisted in the
sharded npz store. The target sweep is resumable per batch (the
checkpoint/resume capability SURVEY.md §5 calls for).
"""

from __future__ import annotations

import numpy as np

from ..ops.topk import topk_ids_with_ties
from .backward_search import BackwardSearch
from .base import PPRAlgorithm
from ..utils.report import progress_printer


class BaseAllPair(PPRAlgorithm):
    name = "BASE"
    prep_dirname = "BASE_ppr_results"

    def __init__(self, dataset, alpha: float, *, seed: int = 0,
                 target_batch: int = 512):
        super().__init__(dataset, alpha, seed=seed)
        self.target_batch = target_batch
        self._store = None
        self._threshold = None
        self._k = None

    def _make_bws(self, threshold: float) -> BackwardSearch:
        """Backward-search kernel factory — the mesh variant overrides this
        (ppr_tpu.parallel.sharded_allpair.sharded_base_allpair)."""
        return BackwardSearch(self.graph, self.alpha, rmax=threshold)

    # --- Preprocessing_Interface ------------------------------------------
    def make_store(self, threshold, k):
        import os
        from ..utils.store import PPRStore

        root = os.path.join(
            self.prep_dirname, self.dataset.name, f"{threshold}_{k}"
        )
        return PPRStore(root, n=self.graph.n_pad)

    def warm_preprocessing(self, threshold: float, k: int = -1) -> None:
        """Compile-warm the all-pair sweep programs: one target batch
        through the reverse-push + device-compaction path, discarded (see
        PreprocessingMixin.warm_preprocessing)."""
        from ..ops.compact import threshold_nonzeros

        threshold = float(threshold)
        bws = self._make_bws(threshold)
        targets = np.arange(min(self.target_batch, self.graph.n))
        reserve = bws.whole_graph_device(targets)
        threshold_nonzeros(reserve, self.graph.node_mask, threshold,
                           rows=len(targets))

    def preprocessing(self, threshold: float, k: int = -1, *,
                      progress: bool = True) -> None:
        """Run the all-pair sweep and persist per-source rows."""
        threshold = float(threshold)
        k = int(k)
        n = self.graph.n
        bws = self._make_bws(threshold)
        report = progress_printer(n, enabled=progress)

        # accumulate pi(s, t) >= threshold as COO triplets; selection runs
        # on device (ops/compact.py) so only the kept entries cross the
        # slow device->host link — the dense [T, n_pad] copy is the
        # bottleneck of the all-pair sweep on big graphs
        from ..ops.compact import threshold_nonzeros

        node_mask = self.graph.node_mask
        v_parts, t_parts, val_parts = [], [], []
        for start in range(0, n, self.target_batch):
            targets = np.arange(start, min(start + self.target_batch, n))
            reserve = bws.whole_graph_device(targets)  # [T', n_pad] device
            keep_t, keep_v, vals = threshold_nonzeros(
                reserve, node_mask, threshold, rows=len(targets)
            )
            v_parts.append(keep_v)
            t_parts.append(targets[keep_t])
            val_parts.append(vals)
            report(min(start + self.target_batch, n) - 1)

        v_all = np.concatenate(v_parts) if v_parts else np.zeros(0, np.int64)
        t_all = np.concatenate(t_parts) if t_parts else np.zeros(0, np.int64)
        val_all = (
            np.concatenate(val_parts) if val_parts else np.zeros(0, np.float32)
        )
        # group by source v; stable sort keeps targets ascending within each
        # source (the reference's LinkedHashMap insertion order over the
        # ascending target loop, Base_Whole_Graph.java:76-92)
        order = np.argsort(v_all, kind="stable")
        v_all, t_all, val_all = v_all[order], t_all[order], val_all[order]
        row_ptr = np.searchsorted(v_all, np.arange(n + 1))

        store = self.make_store(threshold, k)
        store.reset()
        # rows are naturally target-ascending (batch loop order) — matching
        # the reference's LinkedHashMap insertion order (targets 0..n-1).
        shard = 0
        ids_list, vals_list, sources = [], [], []
        for s in range(n):
            lo, hi = row_ptr[s], row_ptr[s + 1]
            ids = t_all[lo:hi].astype(np.int32)
            vals = val_all[lo:hi].astype(np.float32)
            if k >= 0 and ids.size:
                dense = np.zeros(self.graph.n_pad, np.float32)
                dense[ids] = vals
                chosen = topk_ids_with_ties(dense, k)
                ids, vals = chosen.astype(np.int32), dense[chosen]
            sources.append(s)
            ids_list.append(ids)
            vals_list.append(vals)
            if len(sources) == 1024 or s == n - 1:
                store.write_batch_ordered(shard, np.asarray(sources), ids_list, vals_list)
                shard += 1024
                ids_list, vals_list, sources = [], [], []
        store.finalize(threshold=threshold, k=k, alpha=self.alpha)
        self._store, self._threshold, self._k = store, threshold, k

    def attach_store(self, threshold: float, k: int = -1, *,
                     alpha: float | None = None) -> None:
        """Attach a previously persisted all-pair store — a fresh process
        answering queries against an existing preprocessing run (the
        reference's read-the-files usage, Base_Whole_Graph.java:167-186).

        The store path encodes only (threshold, k); the manifest records
        the alpha it was computed under, and a mismatch with ``alpha`` (or
        this instance's alpha) raises rather than silently serving scores
        from a different damping factor."""
        import os

        store = self.make_store(float(threshold), int(k))
        if not os.path.exists(os.path.join(store.root, "manifest.json")):
            raise FileNotFoundError(
                f"no finalized BASE store at {store.root}; run "
                f"preprocessing({threshold}, {k}) first"
            )
        want_alpha = self.alpha if alpha is None else float(alpha)
        stored_alpha = store._read_manifest().get("alpha")
        if stored_alpha is not None and abs(stored_alpha - want_alpha) > 1e-12:
            raise ValueError(
                f"store at {store.root} was preprocessed with "
                f"alpha={stored_alpha}, not {want_alpha}"
            )
        self._store = store
        self._threshold, self._k = float(threshold), int(k)

    # --- query path (file reads, like the reference) ----------------------
    def compute_whole_graph_batch(self, sources: np.ndarray, param=None) -> np.ndarray:
        if self._store is None:
            raise RuntimeError("BASE requires preprocessing() before queries")
        out = np.zeros((len(sources), self.graph.n_pad), np.float32)
        self._last_order = []
        for i, s in enumerate(sources):
            ids, vals = self._store.read_row_ordered(int(s))
            out[i, ids] = vals
            self._last_order.append(ids)
        return out

    def compute_topk_batch(self, sources: np.ndarray, k: int, param=None) -> np.ndarray:
        return self.compute_whole_graph_batch(sources, param)

    def get_topk_node_ids(self, k: int) -> np.ndarray:
        """File order, as in Base_Whole_Graph.getTopKNodeIds (:207-210)."""
        if getattr(self, "_last_order", None):
            return np.asarray(self._last_order[-1], np.int64)
        return super().get_topk_node_ids(k)

    def compute_whole_graph_ppr(self, source: int, param=None) -> None:
        batch = self.compute_whole_graph_batch(np.asarray([source]), param)
        self._last_scores = batch[0]
        self._last_topk_scores = None

    def compute_topk_ppr(self, source: int, k: int, param=None) -> None:
        self.compute_whole_graph_ppr(source, param)

    def read_preprocessed_ppr(self, source: int) -> None:
        self.compute_whole_graph_ppr(source)

    def get_prep_size(self) -> int:
        return self._store.size_bytes() if self._store else 0

    def delete_prep_dir(self) -> None:
        if self._store:
            self._store.delete()
