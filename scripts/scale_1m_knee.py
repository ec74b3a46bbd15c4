"""Hub count x batch sweep of FORA top-k at the 1M-node configuration.

Graph ``synth:1048576x8`` (n=1,048,576, m~8.4M). Sweeps the bf16 hub count
and the batch width through the serving path
(:meth:`ForaTopk.compute_topk_ids_batch`) and records queries/s per point;
each point is written to the output as soon as it is measured.

Run on the device (one process per device)::

    python scripts/scale_1m_knee.py --out scale_1m_knee.json
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
    ap.add_argument("--db", default="synth:1048576x8")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eps", type=float, default=0.5)
    # at n=1M a bf16 hub matrix costs ~2 GB per 1024 hubs
    # (n_pad * H * 2B) next to the [B, n] f32 state arrays
    ap.add_argument("--batches", default="256,512,1024")
    ap.add_argument("--hubs", default="1024,1920,2560,3072")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="scale_1m_knee.json")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ppr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp
    import numpy as np

    from ppr_tpu.cli import load_dataset
    from ppr_tpu.models.fora import ForaTopk

    out_path = Path(args.out)
    state = {"db": args.db, "k": args.k, "eps": args.eps,
             "reps": args.reps, "rows": []}

    ds = load_dataset(args.db)
    g = ds.graph
    print(f"graph n={g.n} m={g.m}", flush=True)
    rng = np.random.default_rng(0)

    def save():
        state["rows"].sort(key=lambda r: (r["batch"], r["hubs"]))
        best = max(state["rows"], key=lambda r: r["qps"], default=None)
        state["best"] = best
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(state, indent=1) + "\n")

    for b in (int(x) for x in args.batches.split(",")):
        sources = rng.integers(0, g.n, size=b)
        for h in (int(x) for x in args.hubs.split(",")):
            fora = ForaTopk(ds, 0.15, args.k, push="none")
            fora.enable_hub_split(h, dtype=jnp.bfloat16)
            t0 = time.perf_counter()
            fora.compute_topk_ids_batch(sources, args.k, args.eps)
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fora.compute_topk_ids_batch(sources, args.k, args.eps)
            dt = (time.perf_counter() - t0) / args.reps
            hs = fora.hub_split
            cover = (1.0 - hs.m_tail / max(g.m, 1)) if hs is not None else 0.0
            row = {"batch": b, "hubs": h, "hub_edge_cover": cover,
                   "cold_s": t_cold, "s_per_batch": dt, "qps": b / dt}
            state["rows"].append(row)
            save()
            print(json.dumps(row), flush=True)
            fora = None
    save()
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
