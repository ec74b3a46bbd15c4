"""Multi-host initialization helpers.

A multi-host mesh needs no algorithm changes: `jax.distributed.initialize`
makes every host see the global device set, and the (data, graph) mesh in
:mod:`ppr_tpu.parallel.sharded` spans hosts transparently. This module just
wraps the boilerplate (an explicit coordinator from env vars) and offers a
global mesh constructor.

The reference has no distributed story at all (single JVM, SURVEY.md §2);
this is net-new capability.
"""

from __future__ import annotations

import os

import jax

from .sharded import make_mesh


def initialize_from_env() -> bool:
    """Initialize ``jax.distributed`` from standard env vars when present.

    Uses ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``;
    nothing is auto-detected. Returns True when a multi-process runtime was
    initialized, False for single-process runs.
    """
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
        return True
    return False


def global_mesh(graph_axis: int | None = None):
    """(data, graph) mesh over every device of every host."""
    devices = jax.devices()
    return make_mesh(len(devices), graph=graph_axis, devices=devices)
