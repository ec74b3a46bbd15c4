"""Dataset loading: Neo4j-import CSVs, generic edge lists, synthetic graphs.

Replaces the reference's entire L0 storage layer (the embedded Neo4j database
opened at PPR.java:52-60 plus the ``neo4j-admin import``'ed store in
``target/got.db``): the CSV pair that the reference imports into Neo4j
(README.md:17-20, ``dataset/got/GOT_Nodes.csv`` / ``GOT_Rels.csv``) is loaded
directly into the array Graph — there is no database in this engine.

The node-name lookup that the reference does through a Neo4j transaction
(Algo_Util.getNodeName, Algo_Util.java:21-30) becomes a plain host-side
``names`` list indexed by dense node id.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from .csr import Graph, build_graph

# Default location of the reference GOT dataset (read-only mount). The harness
# falls back to a seeded synthetic graph when it is absent.
REFERENCE_GOT_DIR = "/root/reference/dataset/got"


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A loaded graph plus host-side metadata."""

    graph: Graph
    names: list[str]            # dense node id -> display name (node_property)
    name: str                   # dataset name, used for result-file prefixes

    @property
    def n(self) -> int:
        return self.graph.n


def _strip_bom(s: str) -> str:
    return s.lstrip("﻿")


def load_neo4j_csv(
    nodes_csv: str,
    rels_csv: str,
    *,
    name: str | None = None,
    dense_threshold: int = 4096,
) -> Dataset:
    """Load a Neo4j-admin-import CSV pair (``:ID,...`` / ``:START_ID,:END_ID,...``).

    Mirrors the import format documented at reference README.md:17-20. Node
    ids may be arbitrary strings; they are densely remapped to 0..n-1 in file
    order (the analogue of HeavyGraph's mapped-id space).
    """
    ids: list[str] = []
    names: list[str] = []
    with open(nodes_csv, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = [_strip_bom(h).strip() for h in next(reader)]
        id_col = header.index(":ID")
        name_col = header.index("name") if "name" in header else id_col
        for row in reader:
            if not row:
                continue
            ids.append(row[id_col])
            names.append(row[name_col])
    id_map = {node_id: i for i, node_id in enumerate(ids)}

    src, dst = [], []
    with open(rels_csv, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = [_strip_bom(h).strip() for h in next(reader)]
        s_col = header.index(":START_ID")
        e_col = header.index(":END_ID")
        for row in reader:
            if not row:
                continue
            src.append(id_map[row[s_col]])
            dst.append(id_map[row[e_col]])

    graph = build_graph(
        np.asarray(src, np.int64),
        np.asarray(dst, np.int64),
        n=len(ids),
        dense_threshold=dense_threshold,
    )
    if name is None:
        name = os.path.splitext(os.path.basename(nodes_csv))[0]
    return Dataset(graph=graph, names=names, name=name)


def load_edge_list(
    path: str,
    *,
    name: str | None = None,
    comment: str = "#",
    dense_threshold: int = 4096,
    weighted: bool = False,
) -> Dataset:
    """Load a whitespace-separated ``src dst [weight]`` edge list (SNAP style).

    Ids are densely remapped in first-appearance order. Parsing goes through
    the native C++ reader when available (ppr_tpu/native), with a pure-python
    fallback. ``weighted=True`` reads a third column of positive edge weights
    (python path only)."""
    from ..native import parse_edge_list_native

    weights = None
    cap = max(os.path.getsize(path) // 3 + 16, 1024)
    parsed = None if weighted else parse_edge_list_native(path, cap)
    if parsed is not None:
        raw_src, raw_dst = parsed
    else:
        src_l, dst_l, w_l = [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(comment):
                    continue
                parts = line.split()
                src_l.append(int(parts[0]))
                dst_l.append(int(parts[1]))
                if weighted:
                    w_l.append(float(parts[2]) if len(parts) > 2 else 1.0)
        raw_src = np.asarray(src_l, np.int64)
        raw_dst = np.asarray(dst_l, np.int64)
        if weighted:
            weights = np.asarray(w_l, np.float64)

    # dense remap in first-appearance order (matches the reference's
    # mapped-id behaviour of assigning ids as nodes are first seen)
    stacked = np.empty(raw_src.size * 2, np.int64)
    stacked[0::2] = raw_src
    stacked[1::2] = raw_dst
    uniq, first_pos = np.unique(stacked, return_index=True)
    order = np.argsort(first_pos, kind="stable")
    uniq_in_order = uniq[order]
    lookup = np.empty(uniq.max() + 1 if uniq.size else 1, np.int64)
    lookup[uniq_in_order] = np.arange(uniq_in_order.size)
    src = lookup[raw_src]
    dst = lookup[raw_dst]
    n = uniq_in_order.size

    graph = build_graph(src, dst, n=n, weights=weights,
                        dense_threshold=dense_threshold)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    names = [str(int(orig)) for orig in uniq_in_order]
    return Dataset(graph=graph, names=names, name=name)


def load_got(got_dir: str = REFERENCE_GOT_DIR, **kwargs) -> Dataset:
    """Load the GOT benchmark dataset (107 nodes / 352 edges)."""
    return load_neo4j_csv(
        os.path.join(got_dir, "GOT_Nodes.csv"),
        os.path.join(got_dir, "GOT_Rels.csv"),
        name=kwargs.pop("name", "got"),
        **kwargs,
    )


def synthetic_powerlaw(
    n: int,
    avg_deg: int = 16,
    *,
    seed: int = 0,
    name: str | None = None,
    dense_threshold: int = 4096,
    dangling_frac: float = 0.01,
) -> Dataset:
    """Seeded scale-free-ish directed graph (preferential-attachment flavored).

    Used for the million-edge benchmark configs (BASELINE.json) and as the
    GOT fallback when the reference dataset mount is unavailable. A small
    fraction of nodes is forced dangling (out-degree 0) so the
    dangling-mass-to-source semantics stay exercised at scale.
    """
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # preferential attachment approximation: dst ~ (Zipf-weighted) node ids,
    # src uniform. Generating true PA sequentially is O(m) python; instead use
    # a static Zipf-like weight over a random permutation of node ids.
    ranks = rng.permutation(n).astype(np.float64)
    weights = 1.0 / (ranks + 10.0)
    weights /= weights.sum()
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.choice(n, size=m, p=weights).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    if dangling_frac > 0:
        n_dangle = max(1, int(n * dangling_frac))
        dangling = rng.choice(n, size=n_dangle, replace=False)
        mask = ~np.isin(src, dangling)
        src, dst = src[mask], dst[mask]

    graph = build_graph(src, dst, n=n, dense_threshold=dense_threshold)
    return Dataset(
        graph=graph,
        names=[str(i) for i in range(n)],
        name=name or f"synth_{n}_{seed}",
    )


def synthetic_weighted(n: int, avg_deg: int = 8, *, seed: int = 0,
                       name: str | None = None,
                       dense_threshold: int = 4096) -> Dataset:
    """Seeded weighted synthetic graph (log-normal edge weights)."""
    rng = np.random.default_rng(seed)
    base = synthetic_powerlaw(
        n, avg_deg, seed=seed, dense_threshold=0  # skip dense; rebuilt below
    )
    g = base.graph
    src = np.asarray(g.edge_src)[: g.m].astype(np.int64)
    dst = np.asarray(g.edge_dst)[: g.m].astype(np.int64)
    w = rng.lognormal(0.0, 1.0, size=g.m)
    graph = build_graph(src, dst, n=n, weights=w,
                        dense_threshold=dense_threshold)
    return Dataset(graph=graph, names=base.names,
                   name=name or f"wsynth_{n}_{seed}")


def load_default(prefer_got: bool = True, **kwargs) -> Dataset:
    """GOT if the reference mount exists, else a seeded 107-node synthetic."""
    if prefer_got and os.path.exists(os.path.join(REFERENCE_GOT_DIR, "GOT_Nodes.csv")):
        return load_got(**kwargs)
    return synthetic_powerlaw(107, avg_deg=3, seed=7, name="got_fallback", **kwargs)
