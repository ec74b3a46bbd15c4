"""Probe the dense-hub count knee at the headline operating point.

A bigger hub matrix trades dense matmul time for sparse-tail edges. This
probes the hub count H in a small ladder on the headline graph and reports
queries/s at the bench batch.

Run on the device (one process per device): ``python scripts/hub_knee.py
--out hub_knee.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", default="synth:65536x16")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--hubs", default="4096,8192,16384,32768")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="hub_knee.json")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from ppr_tpu.cli import load_dataset
    from ppr_tpu.models.fora import ForaTopk

    ds = load_dataset(args.db)
    g = ds.graph
    rng = np.random.default_rng(0)
    sources = rng.integers(0, g.n, size=args.batch)
    rows = []
    for h in (int(x) for x in args.hubs.split(",")):
        fora = ForaTopk(ds, 0.15, args.k, push="none")
        fora.enable_hub_split(h, dtype=jnp.bfloat16)
        fora.compute_topk_ids_batch(sources, args.k, args.eps)  # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fora.compute_topk_ids_batch(sources, args.k, args.eps)
        dt = (time.perf_counter() - t0) / args.reps
        row = {"hubs": h, "s_per_batch": round(dt, 4),
               "qps": round(args.batch / dt, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del fora
    out = {"db": args.db, "batch": args.batch, "reps": args.reps,
           "rows": rows,
           "best": max(rows, key=lambda r: r["qps"])}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
