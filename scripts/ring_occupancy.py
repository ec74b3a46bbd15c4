"""Residue-frontier occupancy + mass-coverage measurement (the data behind
frontier-compacted ring pricing).

Two measurements per graph:

* **Part A (coverage curve)**: a single-device replica of the node-sharded
  annealed sweep loop records, per sweep, the block-granular residue-mass
  distribution — occupancy (fraction of column blocks with any mass) and
  coverage(C) (fraction of total residue mass in the top-C blocks). This
  is what bounds the frontier ring's deferral cost: each frontier sweep
  pushes >= coverage(C) of the remaining mass, so the sweep count inflates
  by at most ~1/coverage on the decaying tail.
* **Part B (empirical inflation)**: the actual
  :class:`ppr_tpu.parallel.node_sharded_fora.NodeShardedForaTopk` engine on
  the virtual 8-device CPU mesh, dense vs frontier at several capacities;
  the returned sweep count ratio IS the measured inflation, and the answer
  ids are cross-checked.

Output: ``ring_occupancy.json`` — consumed by
``parallel/comm_model.py``'s frontier pricing in the four-card prediction
(``scripts/gen_scaling_model.py --occupancy``).

Usage::

    python scripts/ring_occupancy.py --graphs got,synth:65536x16 \
        --out ring_occupancy.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NBLK = 512               # global block granularity (= 8 shards x 64 blocks)
FRACS = (1 / 16, 1 / 8, 1 / 4, 1 / 2)


def dense_coverage(ds, sources, param, k=10, alpha=0.15, max_iters=600):
    """Part A: per-sweep block mass stats from the dense annealed loop."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    g = ds.graph
    eps = float(param) * 0.5          # eps' = eps/2 (Fora_Topk.java:110)
    n = g.n
    delta, min_delta = 1.0 / k, 1.0 / n
    b = len(sources)
    src_j = jnp.asarray(sources, jnp.int32)
    onehot = jax.nn.one_hot(src_j, g.n_pad, dtype=jnp.float32)
    deg_src = np.asarray(g.out_deg)[sources]
    r = jnp.where(jnp.asarray(deg_src[:, None]) == 0, 0.0, onehot)
    p = jnp.zeros_like(r)
    inv_deg = jnp.where(
        g.out_deg > 0, 1.0 / jnp.maximum(g.out_deg.astype(jnp.float32), 1.0),
        0.0,
    )
    dangling = ((g.out_deg == 0) & (g.node_mask > 0)).astype(jnp.float32)
    e_src, e_dst = g.edge_src_bydst, g.edge_dst_bydst
    blk = -(-g.n_pad // NBLK)
    pad = NBLK * blk - g.n_pad

    @jax.jit
    def sweep(p, r):
        p2 = p + alpha * r
        rem = (1.0 - alpha) * r
        dang = jnp.sum(rem * dangling[None, :], axis=-1, keepdims=True)
        chunk = rem * inv_deg[None, :]
        contrib = jnp.take(chunk, e_src, axis=-1)
        pushed = jax.ops.segment_sum(
            jnp.moveaxis(contrib, -1, 0), e_dst, num_segments=g.n_pad,
            indices_are_sorted=True,
        )
        r2 = jnp.moveaxis(pushed, 0, -1) + dang * onehot
        return p2, r2

    @jax.jit
    def block_mass(r):
        r_pad = jnp.pad(r, ((0, 0), (0, pad)))
        return jnp.sum(r_pad.reshape(b, NBLK, blk), axis=(0, 2))

    rows = []
    for it in range(max_iters):
        mass = np.asarray(block_mass(r))
        total = float(mass.sum())
        srt = np.sort(mass)[::-1]
        cum = np.cumsum(srt)
        row = {
            "sweep": it,
            "total_mass": total,
            "occupancy": float((mass > 0).mean()),
        }
        for f in FRACS:
            c = max(1, int(round(NBLK * f)))
            row[f"coverage_{f:.4f}"] = (
                float(cum[c - 1] / total) if total > 0 else 1.0
            )
        rows.append(row)

        p, r = sweep(p, r)
        rsum = jnp.sum(r, axis=-1)
        settled = bool(jnp.max(rsum) <= eps * delta)
        cnt = jnp.sum((p >= (1.0 + eps) * delta).astype(jnp.int32), axis=-1)
        done = settled and bool(jnp.all(cnt >= k))
        if done or (settled and delta <= min_delta):
            break
        if settled:
            delta = max(min_delta, delta / 4.0)
    # mass-weighted mean coverage over the run: the convergence-relevant
    # aggregate (early sweeps carry the mass; the near-empty tail sweeps
    # barely matter for deferral)
    agg = {"sweeps": len(rows)}
    tot = sum(x["total_mass"] for x in rows) or 1.0
    for f in FRACS:
        key = f"coverage_{f:.4f}"
        agg[key + "_mass_weighted"] = sum(
            x[key] * x["total_mass"] for x in rows
        ) / tot
        agg[key + "_min"] = min(x[key] for x in rows)
    agg["occupancy_max"] = max(x["occupancy"] for x in rows)
    return rows, agg


def empirical_inflation(ds, sources, param, k=10, alpha=0.15,
                        orders=("degree", "id"), caps=(4, 8, 16, 32)):
    """Part B: measured sweep counts dense vs frontier on the CPU mesh."""
    import numpy as np
    import jax.numpy as jnp
    from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk
    from ppr_tpu.parallel.sharded import make_mesh

    from ppr_tpu.models.power_method import PowerMethod

    mesh = make_mesh(8, data=2, graph=4)
    out = {}
    truth = PowerMethod(ds, alpha).compute_whole_graph_batch(
        np.asarray(sources, np.int32)
    )

    def oracle_err(engine):
        p = engine.compute_topk_batch(np.asarray(sources, np.int32), k,
                                      param)
        npad = min(truth.shape[-1], p.shape[-1])
        return float(np.abs(p[:, :npad] - truth[:, :npad]).max())

    def run(engine):
        srcs, b = engine._pad_batch(np.asarray(sources, np.int32))
        kcap = min(max(4 * k, k + 32), ds.graph.n_pad)
        vals, ids, _, iters = engine._run(srcs, k, kcap,
                                          float(param) * 0.5)
        return np.asarray(vals)[:b], np.asarray(ids)[:b], int(iters)

    dense = NodeShardedForaTopk(ds, alpha, k, mesh=mesh)
    v_d, i_d, it_d = run(dense)
    out["dense_sweeps"] = it_d
    out["dense_oracle_err"] = oracle_err(dense)
    out["frontier"] = []
    NB = 64
    for order in orders:
        for c in caps:
            eng = NodeShardedForaTopk(ds, alpha, k, mesh=mesh,
                                      frontier_blocks=c, num_blocks=NB,
                                      block_order=order)
            v_f, i_f, it_f = run(eng)
            ok = True
            for row in range(len(sources)):
                sup = min(k, int((v_d[row] > 0).sum()),
                          int((v_f[row] > 0).sum()))
                if set(i_f[row][:sup].tolist()) \
                        != set(i_d[row][:sup].tolist()):
                    ok = False
            out["frontier"].append({
                "block_order": order,
                "capacity_blocks": c,
                "capacity_frac": c / NB,
                "sweeps": it_f,
                "sweep_inflation": it_f / max(it_d, 1),
                # strict borderline-id agreement with the dense run;
                # False means tail-rank drift between two valid stopping
                # states, NOT an error — the oracle errors below are the
                # arbiter (deferral terminates later, typically MORE
                # accurate)
                "ids_match_dense": ok,
                "oracle_err": oracle_err(eng),
            })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="got,synth:65536x16")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--param", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-inflation", action="store_true")
    ap.add_argument("--orders", default="degree,id")
    ap.add_argument("--caps", default="4,8,16,32")
    ap.add_argument("--out", default="ring_occupancy.json")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    import numpy as np

    from ppr_tpu.cli import load_dataset

    out = {"param": args.param, "k": args.k, "batch": args.batch,
           "nblk_global": NBLK, "graphs": {}}
    for spec in args.graphs.split(","):
        if spec == "got":
            ds = load_dataset("/root/reference/dataset/got")
        elif ":" in spec or "/" in spec:
            ds = load_dataset(spec)
        else:
            ds = load_dataset(f"synth:{spec}")   # named synth testsets
        rng = np.random.default_rng(args.seed)
        deg = np.asarray(ds.graph.out_deg[: ds.graph.n])
        cand = np.nonzero(deg > 0)[0]
        sources = rng.choice(cand, size=min(args.batch, len(cand)),
                             replace=False).astype(np.int32)
        print(f"== {spec}: n={ds.graph.n} m={ds.graph.m}", flush=True)
        rows, agg = dense_coverage(ds, sources, args.param, k=args.k)
        print(f"   dense sweeps={agg['sweeps']} "
              f"occ_max={agg['occupancy_max']:.3f} "
              f"cov(1/8)_mw={agg['coverage_0.1250_mass_weighted']:.3f}",
              flush=True)
        entry = {"n": ds.graph.n, "m": ds.graph.m,
                 "aggregate": agg, "per_sweep": rows}
        if not args.skip_inflation:
            infl = empirical_inflation(
                ds, sources, args.param, k=args.k,
                orders=tuple(args.orders.split(",")),
                caps=tuple(int(x) for x in args.caps.split(",")),
            )
            entry["empirical"] = infl
            print("   inflation: " + ", ".join(
                f"{x['block_order'][:3]}/C={x['capacity_blocks']}: "
                f"{x['sweep_inflation']:.2f}x"
                f"(err {x['oracle_err']:.1e})"
                for x in infl["frontier"]), flush=True)
        out["graphs"][spec] = entry
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
