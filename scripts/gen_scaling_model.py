"""Four-card scaling prediction for the sharded engines.

Prices one propagation sweep on one card vs four NVLink cards
(:func:`ppr_tpu.parallel.comm_model.four_card_prediction`) with a device
table entry, adds the frontier-compacted ring at the MEASURED (capacity,
inflation) point of a ring-occupancy run (``scripts/ring_occupancy.py``),
and the measured collective-vs-compute breakdown on the virtual CPU mesh.
Runs on the CPU only.

Run: python scripts/gen_scaling_model.py \
         --occupancy ring_occupancy.json --out scaling_model.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from ppr_tpu.graph.io import synthetic_powerlaw  # noqa: E402
from ppr_tpu.parallel.comm_model import (  # noqa: E402
    four_card_prediction,
    measure_breakdown,
    predict_sweep,
)
from ppr_tpu.parallel.sharded import make_mesh  # noqa: E402
from ppr_tpu.utils.devices import TABLE  # noqa: E402


def pick_frontier(occ_path: str, graph_key: str, g, batch: int,
                  rates) -> dict:
    occ = json.load(open(occ_path))
    entry = occ["graphs"][graph_key]["empirical"]
    cands = []
    for f in entry["frontier"]:
        pred = predict_sweep(
            g, engine="node_sharded", s_graph=4, batch=batch,
            payload_bytes=2, capacity_frac=f["capacity_frac"],
            sweep_inflation=f["sweep_inflation"], rates=rates,
        )
        cands.append((pred.t_sweep_s, f))
    cands.sort(key=lambda x: x[0])
    return dict(cands[0][1], source=occ_path, measured_graph=graph_key)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", default="NVIDIA H100 80GB HBM3")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--occupancy", default=None,
                    help="scripts/ring_occupancy.py output (optional)")
    ap.add_argument("--out", default="scaling_model.json")
    args = ap.parse_args()

    rates = TABLE[args.device_kind]
    g = synthetic_powerlaw(65536, 8, seed=3, dense_threshold=0).graph
    frontier = (pick_frontier(args.occupancy, "synth:65536x8", g,
                              args.batch, rates)
                if args.occupancy else None)
    out = four_card_prediction(g, batch=args.batch, frontier=frontier,
                               rates=rates)
    out["measured_breakdown_cpu_mesh"] = measure_breakdown(
        make_mesh(), g, batch=64)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    for k in ("node_sharded", "node_sharded_bf16_ring",
              "node_sharded_frontier_bf16"):
        e = out[k]
        if e is not None:
            print(f"{k}: eff {e['efficiency']:.3f} "
                  f"ov {e['efficiency_overlap']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
