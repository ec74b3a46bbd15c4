"""chip_smoke.py's contract pieces that hold on any machine: it refuses a
non-GPU device, its last line carries exactly the contract's keys, and its
float64 references are the reference semantics. The phases themselves run
only on the card (``python chip_smoke.py``)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

from conftest import exact_ppr_dangling_to_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load()


@dataclasses.dataclass
class FakeDevice:
    platform: str
    device_kind: str


def test_refuses_non_gpu():
    import jax

    with pytest.raises(SystemExit, match="needs a GPU"):
        smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        smoke.main([])                     # default mode, CPU devices
    smoke.require_gpu([FakeDevice("gpu", "NVIDIA H100 80GB HBM3")])


def test_result_line_has_exactly_the_contract_keys():
    devs = [FakeDevice("gpu", "NVIDIA H100 80GB HBM3")] * 4
    line = json.loads(json.dumps(smoke.result_line(devs)))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_check_records_and_fails():
    assert smoke.check("x", 1.0, 1.0, ">=") == {"value": 1.0,
                                                "bound": ">= 1.0"}
    with pytest.raises(AssertionError, match="x = 0.5"):
        smoke.check("x", 0.5, 0.9, ">")


@pytest.mark.parametrize("neo4j", [False, True])
def test_dense_reference_semantics(tiny, neo4j):
    src = np.asarray(tiny.edge_src)[: tiny.m]
    dst = np.asarray(tiny.edge_dst)[: tiny.m]
    sources = np.asarray([0, 3, 4, 5])
    got = smoke.dense_reference(tiny, sources, 0.15, 60, neo4j=neo4j)
    if neo4j:
        # x = (1-d) e_s + d x W, normalized: rows sum to one
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)
        from ppr_tpu.models.neo4j_method import personalized_pagerank_batch

        want = np.asarray(personalized_pagerank_batch(
            tiny, sources, 0.85, 60))[:, : tiny.n]
        np.testing.assert_allclose(got, want, atol=2e-6)
    else:
        for row, s in zip(got, sources):
            np.testing.assert_allclose(
                row, exact_ppr_dangling_to_source(src, dst, tiny.n, int(s),
                                                  0.15, iters=60),
                atol=1e-12)
