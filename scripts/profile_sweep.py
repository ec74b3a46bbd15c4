"""Profile propagation-sweep variants on the device.

Times the serving path's hot kernel — one residual-propagation sweep over the
bench graph (n=65536, deg=16, ~1.04M edges) at B=256 — across SpMV variants:

* plain      : sorted-COO segment-sum (transposed layout)
* hub f32 H  : dense-hub hybrid, f32 hub matrix, H hubs
* hub bf16 H : same with bf16 hub matrix (half the bytes, bf16 matmul)

plus the full annealed top-k loop for chosen variants. Run it alone on the
device (one process per device):

    python scripts/profile_sweep.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def coverage_curve(g, hubs=(256, 512, 1024, 2048, 4096)):
    in_deg = np.asarray(g.in_deg)[: g.n]
    order = np.sort(in_deg)[::-1]
    cum = np.cumsum(order)
    total = max(int(cum[-1]), 1)
    return {int(h): float(cum[min(h, g.n) - 1] / total) for h in hubs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--hubs", default="512,2048,4096",
                    help="comma list of hub counts to profile")
    ap.add_argument("--skip-plain", action="store_true")
    ap.add_argument("--skip-f32", action="store_true")
    ap.add_argument("--skip-residual", action="store_true",
                    help="only time the annealed loop")
    args = ap.parse_args()
    if args.quick:
        args.n, args.deg, args.batch = 4096, 8, 32

    import jax
    import jax.numpy as jnp

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models.fora import annealed_topk_propagate, residual_propagate
    from ppr_tpu.ops.hub_split import build_hub_split
    from ppr_tpu.ops.push import forward_push_init
    from ppr_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    d = jax.devices()[0]
    dev = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    ds = synthetic_powerlaw(args.n, args.deg, seed=42, dense_threshold=0)
    g = ds.graph
    print(json.dumps({"device": dev, "n": g.n, "m": g.m,
                      "coverage": coverage_curve(g)}))

    rng = np.random.default_rng(0)
    sources = jnp.asarray(rng.integers(0, g.n, args.batch), jnp.int32)
    p0, r0, onehot = forward_push_init(g, sources)
    alpha, eps, k = 0.15, 0.25, 10  # eps' = 0.5/2 as the serving path uses
    target = jnp.float32(1e-6)

    variants = [] if args.skip_plain else [("plain", None)]
    hub_list = [int(h) for h in args.hubs.split(",") if h]
    for h in hub_list:
        for dt in ((jnp.bfloat16,) if args.skip_f32 else
                   (jnp.float32, jnp.bfloat16)):
            name = f"hub{h}_{'bf16' if dt == jnp.bfloat16 else 'f32'}"
            variants.append((name, build_hub_split(g, h, dtype=dt)))

    results = {}
    for name, hs in variants if not args.skip_residual else []:
        t_compile = time.perf_counter()
        p, r, iters = residual_propagate(g, p0, r0, onehot, target, alpha,
                                         hs=hs)
        jax.block_until_ready(r)
        compile_s = time.perf_counter() - t_compile
        t0 = time.perf_counter()
        p, r, iters = residual_propagate(g, p0, r0, onehot, target, alpha,
                                         hs=hs)
        jax.block_until_ready(r)
        wall = time.perf_counter() - t0
        it = int(iters)
        results[name] = {
            "iters": it, "total_ms": round(wall * 1e3, 2),
            "sweep_ms": round(wall / max(it, 1) * 1e3, 3),
            "first_call_s": round(compile_s, 1),
        }
        print(json.dumps({name: results[name]}), flush=True)

    # full annealed serving loop for the interesting variants
    for name, hs in [
        (n_, h_) for n_, h_ in variants if n_ == "plain" or "bf16" in n_
    ]:
        tag = f"annealed_{name}"
        t_compile = time.perf_counter()
        p, r, iters = annealed_topk_propagate(
            g, jnp.zeros_like(p0), r0, onehot, jnp.float32(eps),
            1.0 / k, 1.0 / g.n, k, alpha, hs=hs)
        jax.block_until_ready(p)
        compile_s = time.perf_counter() - t_compile
        t0 = time.perf_counter()
        p, r, iters = annealed_topk_propagate(
            g, jnp.zeros_like(p0), r0, onehot, jnp.float32(eps),
            1.0 / k, 1.0 / g.n, k, alpha, hs=hs)
        jax.block_until_ready(p)
        wall = time.perf_counter() - t0
        results[tag] = {
            "iters": int(iters), "total_ms": round(wall * 1e3, 2),
            "qps": round(args.batch / wall, 1),
            "first_call_s": round(compile_s, 1),
        }
        print(json.dumps({tag: results[tag]}), flush=True)

    print(json.dumps({"summary": results}))


if __name__ == "__main__":
    main()
