"""The device table (ppr_tpu.utils.devices): known kinds return their
entry, an unknown kind is an error, never another kind's numbers."""

import dataclasses

import pytest

from ppr_tpu.utils import devices
from ppr_tpu.utils.devices import TABLE, UnknownDeviceError


@dataclasses.dataclass
class FakeDevice:
    device_kind: str
    platform: str = "gpu"
    stats: dict | None = None

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("kind", sorted(TABLE))
def test_known_kind_returns_its_entry(kind):
    rates = devices.device_rates(FakeDevice(kind))
    assert rates is TABLE[kind]
    assert rates.walk_ns > 0 and rates.spmv_ns_per_edge > 0
    assert 0 < rates.spmv_budget_frac < rates.hybrid_tail_budget_frac < 1
    assert rates.source


def test_first_device_is_cpu_here():
    assert devices.device_rates() is TABLE["cpu"]


def test_unknown_kind_raises(monkeypatch):
    import jax

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf

    with pytest.raises(UnknownDeviceError, match="calibrate"):
        devices.device_rates(FakeDevice("NVIDIA B200"))
    # every consumer goes through the table: a FORA engine on an unknown
    # device fails at construction instead of borrowing another entry
    ds = synthetic_powerlaw(256, 4, seed=1, dense_threshold=0)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [FakeDevice("NVIDIA B200")])
    with pytest.raises(UnknownDeviceError):
        AlgoConf(0.15).set_conf_fora_topk(ds, 10)


def test_memory_budget_prefers_reported_limit():
    h100 = "NVIDIA H100 80GB HBM3"
    dev = FakeDevice(h100, stats={"bytes_limit": 8 << 30})
    assert devices.memory_budget(0.25, dev) == 2 << 30
    # no reported limit: the entry's memory size
    dev = FakeDevice(h100, stats=None)
    assert devices.memory_budget(0.5, dev) == TABLE[h100].memory_bytes // 2


def test_cpu_budgets_keep_cpu_behaviour():
    """2 GB / 6 GB intermediate budgets on the CPU, as before the table."""
    cpu = TABLE["cpu"]
    dev = FakeDevice("cpu", platform="cpu")
    assert devices.memory_budget(cpu.spmv_budget_frac, dev) == 2 << 30
    assert devices.memory_budget(cpu.hybrid_tail_budget_frac, dev) == 6 << 30


def test_fora_and_hub_rule_read_the_table(monkeypatch):
    """The cost model's rates and the hub rule's inputs come from the
    first device's entry."""
    import numpy as np

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.models import AlgoConf
    from ppr_tpu.ops.hub_split import auto_num_hubs

    ds = synthetic_powerlaw(4096, 8, seed=2, dense_threshold=0)
    fora = AlgoConf(0.15).set_conf_fora_whole_graph(ds)
    cpu = TABLE["cpu"]
    assert fora.avg_rand_walk_time_ns == cpu.walk_ns
    assert fora.spmv_ns_per_edge == cpu.spmv_ns_per_edge
    assert fora.d2h_bytes_per_s == cpu.d2h_bytes_per_s
    # a faster sparse rate relative to memory admits fewer hubs
    slow = auto_num_hubs(ds.graph, np.float32, tail_ns_per_edge=50.0)
    fast = auto_num_hubs(ds.graph, np.float32, tail_ns_per_edge=0.01)
    assert fast <= slow
    assert auto_num_hubs(ds.graph) == auto_num_hubs(
        ds.graph, tail_ns_per_edge=cpu.spmv_ns_per_edge,
        mem_bytes_per_s=cpu.mem_bytes_per_s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_hub_rule_keeps_its_threshold(dtype, monkeypatch):
    """On the CPU the hub rule admits the hubs it always has (12 ns/edge
    against 800 GB/s), above the 128-hub floor that would hide a change;
    given both rates it does not consult the table at all."""
    import jax.numpy as jnp

    from ppr_tpu.graph.io import synthetic_powerlaw
    from ppr_tpu.ops import hub_split
    from ppr_tpu.ops.hub_split import auto_num_hubs

    dt = getattr(jnp, dtype)
    g = synthetic_powerlaw(4096, 8, seed=2, dense_threshold=0).graph
    h = auto_num_hubs(g, dt)
    assert h > 128
    monkeypatch.setattr(hub_split, "device_rates", lambda *a: 1 / 0)
    assert h == auto_num_hubs(g, dt, tail_ns_per_edge=12.0,
                              mem_bytes_per_s=800e9)
