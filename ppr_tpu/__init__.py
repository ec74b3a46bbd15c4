"""Batched Personalized PageRank retrieval engine in JAX.

Capabilities-parity rebuild of joezie/Personalized-PageRank-Algorithms-on-Neo4j
(see SURVEY.md) as array programs: array graph store, frontier-masked push
sweeps, vectorized walkers, dense hub operators, mesh-sharded execution.
Importing the package does not touch the device; entry points enable the
compile cache (:mod:`ppr_tpu.utils.cache`).
"""

__version__ = "0.1.0"

from .graph.csr import Graph, build_graph  # noqa: F401
from .graph.io import (  # noqa: F401
    Dataset,
    load_edge_list,
    load_got,
    load_neo4j_csv,
    synthetic_powerlaw,
)
