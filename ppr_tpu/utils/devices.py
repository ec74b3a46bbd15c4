"""Rates and memory budgets of the devices the engine runs on.

The FORA cost model (walk vs SpMV completion, the price of the
preprocessing transfer), the hub-count rule, the intermediate-memory
budgets and the sharded engines' communication model all need rates of the
device they run on. They read them from this one table, keyed by
``jax.Device.device_kind``.

A device kind the table does not hold is an error, never a default: measure
it with ``python -m ppr_tpu.utils.calibrate`` and add an entry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceRates:
    #: one random walk, amortized over a walker pool (ns)
    walk_ns: float
    #: one propagation sweep, per edge (ns): per sweep when
    #: ``spmv_batch_amortized`` (the rows of a batch share it), else per row
    spmv_ns_per_edge: float
    spmv_batch_amortized: bool
    #: device -> host copy rate (bytes/s)
    d2h_bytes_per_s: float
    #: device memory bandwidth (bytes/s)
    mem_bytes_per_s: float
    #: interconnect egress per device and direction (bytes/s)
    link_bytes_per_s: float
    #: budget of the per-edge gather intermediate [m_pad, B], as a fraction
    #: of the device's memory; above it the sweep processes edges in chunks
    spmv_budget_frac: float
    #: the same for the hub-split tail gather
    hybrid_tail_budget_frac: float
    #: memory size used where the device reports no ``bytes_limit``
    memory_bytes: int
    #: where the numbers come from
    source: str


TABLE: dict[str, DeviceRates] = {
    # XLA:CPU. Walk and sweep costs, the copy rate and the budgets are the
    # values the CPU path has always used. The memory rate is set so that
    # the hub rule keeps the in-degree threshold it has always had on the
    # CPU (12 ns/edge against 800 GB/s: 4 ns/edge against 2.4 TB/s); the
    # link rate only prices the virtual-mesh communication model.
    "cpu": DeviceRates(
        walk_ns=400.0,
        spmv_ns_per_edge=4.0,
        spmv_batch_amortized=False,
        d2h_bytes_per_s=4e9,
        mem_bytes_per_s=2.4e12,
        link_bytes_per_s=1e10,
        spmv_budget_frac=1 / 8,
        hybrid_tail_budget_frac=3 / 8,
        memory_bytes=16 << 30,
        source="CPU defaults (nominal, not measured)",
    ),
    # Walk, sweep and copy rates: calibrate.measure (walkers=65536, sweep
    # at B=32 and B=256) on synth:65536x16 (n=65536, m=1038050), one
    # NVIDIA H100 80GB HBM3 at a 700 W power limit. At served widths
    # (sweep at B=256 and 2048, 1M walkers) the same card shows a per-row
    # sweep cost and ~12x cheaper walks; the cost model has one rate of
    # each. Memory bandwidth and NVLink (450 GB/s each way) are the data
    # sheet's.
    "NVIDIA H100 80GB HBM3": DeviceRates(
        walk_ns=53.802334594725984,
        spmv_ns_per_edge=2.9682028804007485,
        spmv_batch_amortized=True,
        d2h_bytes_per_s=2290012281.07107,
        mem_bytes_per_s=3.35e12,
        link_bytes_per_s=4.5e11,
        spmv_budget_frac=1 / 8,
        hybrid_tail_budget_frac=3 / 8,
        memory_bytes=80 << 30,
        source="calibrate.measure on synth:65536x16, H100 80GB HBM3 at "
               "700 W; bandwidth and NVLink from the data sheet",
    ),
}


class UnknownDeviceError(LookupError):
    pass


def _device(device=None):
    import jax

    return device if device is not None else jax.devices()[0]


def device_rates(device=None) -> DeviceRates:
    """Table entry of ``device`` (default: the first JAX device)."""
    kind = _device(device).device_kind
    try:
        return TABLE[kind]
    except KeyError:
        raise UnknownDeviceError(
            f"no rates for device kind {kind!r} (known: {sorted(TABLE)}); "
            f"measure them with `python -m ppr_tpu.utils.calibrate` and add "
            f"an entry to ppr_tpu.utils.devices.TABLE"
        ) from None


def memory_budget(frac: float, device=None) -> int:
    """``frac`` of the device's memory: its reported ``bytes_limit`` (what
    this process may allocate), else the table's ``memory_bytes``."""
    device = _device(device)
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit") or device_rates(device).memory_bytes
    return int(frac * limit)
