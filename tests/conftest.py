"""Test env: force CPU backend with a virtual 8-device mesh.

The tests run on the CPU; sharding paths are validated on a host-platform
device mesh. ``jax.config`` pins the platform before first backend use, so
the suite stays on the CPU even where an accelerator is present. Paths that
run only on the card are checked by ``chip_smoke.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def got():
    from ppr_tpu.graph.io import load_default

    return load_default()


@pytest.fixture(scope="session")
def tiny():
    """Hand-built 6-node graph with a dangling node and a self loop."""
    from ppr_tpu.graph.csr import build_graph

    #   0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 0, 4 (dangling), 5 -> 5 (self loop)
    src = np.array([0, 0, 1, 2, 3, 5])
    dst = np.array([1, 2, 2, 0, 0, 5])
    return build_graph(src, dst, n=6)


def exact_ppr_dangling_to_source(src_np, dst_np, n, source, alpha, iters=300):
    """Reference-semantics exact PPR by dense numpy iteration (float64).

    Mirrors Power_Method.java:55-100 including dangling-mass-to-source."""
    P = np.zeros((n, n))
    deg = np.bincount(src_np, minlength=n)
    for s, d in zip(src_np, dst_np):
        P[s, d] += 1.0 / deg[s]
    dangling = deg == 0
    p = np.zeros(n)
    r = np.zeros(n)
    r[source] = 1.0
    for _ in range(iters):
        p += alpha * r
        rem = (1 - alpha) * r
        dang_mass = rem[dangling].sum()
        r = rem @ P
        r[source] += dang_mass
    return p
