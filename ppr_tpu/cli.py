"""CLI entry point — flag parity with the reference's commons-cli main.

Reference: PPR.java:154-200 — flags ``-alpha -eps -query -k -node -label
-rel -db -help`` with defaults alpha=0.15, eps=0.5, query=50, k=10,
node=name, label=Person, rel=Relation, db=target/got.db (PPR.java:168-184).
Here ``--db`` names a dataset directory holding the Neo4j-import CSV pair
(or a SNAP edge list / ``synth:<n>x<deg>`` spec) instead of an embedded
database, and the program runs the same batch benchmark
(``algo_perf_batch_test(query, k)``, PPR.java:192).

Usage::

    python -m ppr_tpu.cli --db /root/reference/dataset/got --query 50 --k 10
    python -m ppr_tpu.cli --db synth:10000x8 --query 20
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppr_tpu",
        description="Personalized PageRank benchmark harness",
    )
    p.add_argument("--alpha", type=float, default=0.15,
                   help="stop probability per walk step (default 0.15)")
    p.add_argument("--eps", type=float, default=0.5,
                   help="error-bound epsilon (default 0.5)")
    p.add_argument("--query", type=int, default=50,
                   help="number of benchmark queries (default 50)")
    p.add_argument("--k", type=int, default=10,
                   help="k for top-k queries (default 10)")
    p.add_argument("--node", default="name",
                   help="node display-name property (parity flag)")
    p.add_argument("--label", default="Person",
                   help="node label (parity flag)")
    p.add_argument("--rel", default="Relation",
                   help="relationship type (parity flag)")
    p.add_argument("--db", default="/root/reference/dataset/got",
                   help="dataset: dir with *_Nodes.csv/*_Rels.csv, an edge "
                        "list file, or synth:<n>x<deg>[@seed]")
    p.add_argument("--seed", type=int, default=0, help="query/RNG seed")
    p.add_argument("--sequential", action="store_true",
                   help="time queries one at a time (reference protocol) "
                        "instead of the batched device path")
    p.add_argument("--sweep", default=None,
                   help="sweep spec name (got/blogcatalog/flickr/grqc/amazon)")
    p.add_argument("--out-dir", default=".",
                   help="where <dataset>_AlgoPerfResults.txt is written")
    p.add_argument("--fora-completion", default="auto",
                   choices=["auto", "walks", "spmv"],
                   help="FORA residual completion strategy (auto = cost model)")
    p.add_argument("--algos", default=None,
                   help="comma subset of algorithm names (AlgoType values, "
                        "e.g. MC,NEO4J_METHOD) to run within each selected "
                        "test — resume a budget-cut sweep without repaying "
                        "its completed sections. 'MC:2' skips the first 2 "
                        "params of MC's arrays (already-recorded rows)")
    p.add_argument("--tests", default="1,2,3",
                   help="comma subset of the three protocol tests to run "
                        "(1=whole-graph, 2=top-k, 3=preprocessing)")
    p.add_argument("--budget-s", type=float, default=None,
                   help="per-(algorithm, test) time budget in seconds; "
                        "remaining sweep params are skipped with an "
                        "explicit note row once exceeded")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace of the batch test here")
    p.add_argument("--mesh", default=None, metavar="DxG",
                   help="run every algorithm (incl. preprocessing sweeps) on "
                        "a (data=D, graph=G) device mesh, e.g. --mesh 1x1 "
                        "(one device through the sharded engines) or "
                        "--mesh 4x2; D*G must not exceed jax.device_count()")
    return p


# Reference-scale seeded stand-ins for the four SNAP/social datasets of
# Gen_Util.java:334-449 (the originals are not redistributable / available
# here; node- and edge-counts approximate the published dataset sizes so
# the sweep operating points are comparable). Names match SWEEPS keys so
# `--db synth:flickr` runs the flickr parameter arrays into
# flickr_AlgoPerfResults.txt.
NAMED_SYNTH = {
    "blogcatalog": (10240, 32, 101),   # BlogCatalog: 10,312 n / 334k m
    "flickr": (81920, 16, 102),        # Flickr: 80,513 n (deg reduced 72->16)
    "grqc": (5120, 3, 103),            # ca-GrQc: 5,242 n / 14.5k m
    "amazon": (262144, 4, 104),        # amazon0302: 262,111 n / 1.23M m
}


def load_dataset(db: str, rel: str | None = None):
    """``rel`` filters a binary-store load to that relationship type (the
    reference's --rel flag, PPR.java:126); CSV/SNAP/synthetic sources are
    single-type by construction and ignore it."""
    from .graph import io

    if db.startswith("synth:"):
        spec = db[len("synth:"):]
        if spec in NAMED_SYNTH:
            n, deg, seed = NAMED_SYNTH[spec]
            return io.synthetic_powerlaw(n, deg, seed=seed, name=spec,
                                         dense_threshold=0)
        seed = 0
        if "@" in spec:
            spec, seed_s = spec.split("@")
            seed = int(seed_s)
        n, deg = (int(x) for x in spec.split("x"))
        return io.synthetic_powerlaw(n, deg, seed=seed)
    if os.path.isdir(db):
        from .graph.neostore import is_neo4j_store, load_neo4j_store

        if is_neo4j_store(db):
            # the reference's own entry path: an embedded-Neo4j store dir
            # (PPR.java:52-60 on target/got.db), read without a JVM
            return load_neo4j_store(db, rel_type=rel)
        for f in os.listdir(db):
            if f.endswith("_Nodes.csv"):
                prefix = f[: -len("_Nodes.csv")]
                return io.load_neo4j_csv(
                    os.path.join(db, f),
                    os.path.join(db, f"{prefix}_Rels.csv"),
                    name=prefix.lower(),
                )
        raise SystemExit(f"no *_Nodes.csv or neostore in {db}")
    if os.path.isfile(db):
        return io.load_edge_list(db)
    raise SystemExit(f"dataset not found: {db}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .harness import PerfHarness
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()

    dataset = load_dataset(args.db, rel=args.rel)
    print(f"Loaded dataset '{dataset.name}': {dataset.graph.n} nodes, "
          f"{dataset.graph.m} edges")
    mesh = None
    if args.mesh:
        from .parallel.sharded import make_mesh

        d, g_ax = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(d * g_ax, data=d, graph=g_ax)
        print(f"Mesh: data={d} x graph={g_ax} "
              f"({d * g_ax} device(s), sharded engines)")
    harness = PerfHarness(
        dataset, alpha=args.alpha, seed=args.seed,
        out_dir=args.out_dir, batched=not args.sequential,
        fora_completion=args.fora_completion, mesh=mesh,
    )

    # lifecycle hook parity (the reference registers a JVM shutdown hook that
    # closes the DB, PPR.java:35-50): on interruption, report where the
    # append-only results file and any resumable preprocessing stores stand.
    import atexit

    done = {"ok": False}

    def _shutdown_note():
        if not done["ok"]:
            print(f"Interrupted — partial results in {harness.writer.path}; "
                  "preprocessing stores resume from their last completed "
                  "shard on the next run.")

    atexit.register(_shutdown_note)

    from .utils.timer import trace

    try:
        with trace(args.trace_dir):
            harness.algo_perf_batch_test(
                args.query, args.k, sweep=args.sweep,
                tests=tuple(int(t) for t in args.tests.split(",")),
                budget_s=args.budget_s,
                algos=(set(args.algos.split(",")) if args.algos else None),
            )
    except Exception as e:  # PPR.java:196-199 prints and exits
        print(f"Algo performance batch test failed! ({e})")
        raise
    done["ok"] = True
    print(f"Results appended to {harness.writer.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
