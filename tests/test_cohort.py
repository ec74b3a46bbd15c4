"""Per-row cohort serving path (the latency-floor mechanism).

The batch-global annealed loop (models/fora.annealed_topk_propagate) holds
every row in a dispatch until the SLOWEST row finishes, which sets the
serving latency floor at one full sweep train (Fora_Topk.java:173-176's
per-query stopping rule applied batch-globally).
The cohort path anneals PER ROW — each row follows exactly the schedule a
single-query run would (reference semantics row-wise) — and retires
finished rows down a pow2 width ladder so their futures resolve early.

These tests pin: per-row trajectory independence (a row's result must not
depend on its cohort co-tenants), disjoint-cover emission, service
streaming equivalence, and the scheduler's early future resolution.
"""

import threading
import time

import numpy as np
import pytest

from ppr_tpu.models import AlgoType
from ppr_tpu.models.fora import ForaTopk
from ppr_tpu.service import PPRService
from ppr_tpu.serving import PPRBatchServer


@pytest.fixture(scope="module")
def fora(got):
    return ForaTopk(got, 0.15, 10, push="none")


def _collect(algo, sources, k=10, eps=0.5):
    """Run the cohort generator; return (out_ids dict, emission order)."""
    out = {}
    order = []
    for idxs, vals, ids in algo.compute_topk_ids_cohorts(sources, k, eps):
        order.append(np.asarray(idxs))
        for i, v, nid in zip(idxs, vals, ids):
            assert int(i) not in out, "row emitted twice"
            out[int(i)] = (v, nid)
    return out, order


def test_cohort_emits_disjoint_cover(fora):
    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44, 5, 61, 70, 88])
    out, order = _collect(fora, sources)
    assert sorted(out) == list(range(len(sources)))


def test_cohort_row_independent_of_cotenants(fora):
    """A row's emitted ids/values must equal its own single-row cohort run
    (per-row annealing + freeze-at-finish => trajectory independence): the
    mixed batch ran through width compaction, the singles did not."""
    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44, 5, 61, 70, 88])
    out, _ = _collect(fora, sources)
    for i, s in enumerate(sources):
        solo, _ = _collect(fora, np.array([s]))
        v_b, id_b = out[i]
        v_s, id_s = solo[0]
        np.testing.assert_array_equal(id_b, id_s)
        np.testing.assert_allclose(v_b, v_s, rtol=1e-5, atol=1e-7)


def test_cohort_ids_match_oracle(fora, got):
    """The retired rows' top-k id sets carry reference accuracy: compare
    against the dense power-method oracle at the default operating point
    (alpha=0.15, eps=0.5 -> precision 1.0 on GOT, PERF.md)."""
    from ppr_tpu.models import PowerMethod
    from ppr_tpu.ops.topk import topk_ids_with_ties
    from ppr_tpu.utils.metrics import precision_at_k

    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44])
    out, _ = _collect(fora, sources)
    oracle = PowerMethod(got, 0.15).compute_whole_graph_batch(sources)
    for i in range(len(sources)):
        vals, ids = out[i]
        sup = vals > 0
        algo_ids = ids[sup][:10]
        gnd = topk_ids_with_ties(oracle[i], 10)
        assert precision_at_k(algo_ids, gnd) >= 0.9


def test_cohort_early_exit_ids_exact(got):
    """The per-row set-stability certificate keeps ids exact."""
    base = ForaTopk(got, 0.15, 10, push="none")
    fast = ForaTopk(got, 0.15, 10, push="none", early_exit=True)
    sources = np.array([3, 14, 50, 7, 9, 22, 31, 44])
    out_b, _ = _collect(base, sources)
    out_f, _ = _collect(fast, sources)
    for i in range(len(sources)):
        _, ids_b = out_b[i]
        _, ids_f = out_f[i]
        np.testing.assert_array_equal(ids_b[:10], ids_f[:10])


def test_cohort_width_ladder_floor_is_8(fora, monkeypatch):
    """The cohort ladder must bucket batch widths with the SERVING floor
    (8), not fora.py's walk-pool bucket (floor 1024): a 12-row dispatch
    runs at widths {16, 8}, never instantiating kilobatch state (r4 code
    review finding), and compaction jumps straight to the pow2 ceiling of
    the live count (no no-op intermediate stages)."""
    import ppr_tpu.models.fora as F

    widths = []
    orig = F.annealed_topk_propagate_perrow

    def spy(g, p, *a, **kw):
        widths.append(int(p.shape[0]))
        return orig(g, p, *a, **kw)

    monkeypatch.setattr(F, "annealed_topk_propagate_perrow", spy)
    out, _ = _collect(fora, np.arange(12) * 7 % 100)
    assert sorted(out) == list(range(12))
    assert widths and max(widths) == 16
    assert all(w in (16, 8) for w in widths)
    # strictly decreasing stages: no width repeats (each stage either
    # finishes the ladder or compacts to a smaller pow2)
    assert len(widths) == len(set(widths))


def test_pow2_width_vs_walk_bucket():
    from ppr_tpu.models.fora import _pow2_bucket, _pow2_width

    assert _pow2_width(1) == 8
    assert _pow2_width(9) == 16
    assert _pow2_width(300) == 512
    assert _pow2_bucket(1) == 1024          # walk pools: floor stays 1024


def test_service_stream_matches_top_k(got):
    svc = PPRService.from_dataset(got, k=10, cohort=True)
    assert svc.supports_stream
    sources = [3, 14, 50, 7, 9, 22, 31, 44]
    want = svc.top_k(sources)
    rows = [None] * len(sources)

    def emit(idxs, hits_rows):
        for i, row in zip(idxs, hits_rows):
            rows[int(i)] = row

    svc.top_k_stream(sources, emit=emit)
    assert all(r is not None for r in rows)
    for got_row, want_row in zip(rows, want):
        assert [h.node for h in got_row] == [h.node for h in want_row]


def test_service_cohort_validation(got):
    with pytest.raises(ValueError, match="cohort"):
        PPRService.from_dataset(got, cohort=True, algorithm=AlgoType.MC)
    svc = PPRService.from_dataset(got, k=10)   # cohort off by default
    assert not svc.supports_stream
    with pytest.raises(RuntimeError):
        svc.top_k_stream([3], emit=lambda *a: None)


class FakeStreamService:
    """Two-cohort stream: fast rows retire at t=+dt, slow rows at +10*dt."""

    supports_stream = True

    def __init__(self, dt=0.05):
        self.dt = dt

    def top_k(self, sources, k=None, eps=None):
        time.sleep(10 * self.dt)
        return [[(s, 1.0, str(s))] for s in sources]

    def top_k_stream(self, sources, k=None, eps=None, *, emit):
        b = len(sources)
        fast = list(range(0, b, 2))
        slow = list(range(1, b, 2))
        time.sleep(self.dt)
        emit(np.array(fast), [[(sources[i], 1.0, str(sources[i]))]
                              for i in fast])
        time.sleep(9 * self.dt)
        emit(np.array(slow), [[(sources[i], 1.0, str(sources[i]))]
                              for i in slow])


def test_server_resolves_fast_cohort_early():
    """The scheduler must resolve a fast row's future when ITS cohort
    retires — not when the dispatch's slowest row finishes."""
    svc = FakeStreamService(dt=0.05)
    with PPRBatchServer(svc, max_batch=16) as server:
        barrier = threading.Barrier(2)
        t_fast = {}

        def client(src, key):
            barrier.wait()
            fut = server.submit(src)
            t0 = time.perf_counter()
            fut.result(timeout=30)
            t_fast[key] = time.perf_counter() - t0

        th = [threading.Thread(target=client, args=(s, i))
              for i, s in enumerate([4, 5])]
        for t in th:
            t.start()
        for t in th:
            t.join()
    # row 0 (even position) rides the fast cohort (~dt); row 1 the slow
    # one (~10*dt). Both in one dispatch (coalesced via the barrier).
    assert server.stats.dispatches <= 2
    fast_t, slow_t = min(t_fast.values()), max(t_fast.values())
    assert fast_t < 0.6 * slow_t
    # and the per-request latency samples reflect cohort times, not the
    # batch max
    lat = sorted(server.stats.latencies_ms)
    assert lat[0] < 0.6 * lat[-1]
