"""Serve-time micro-batching (ppr_tpu/serving.py).

The reference has no serving layer (its only driver is the sequential
benchmark loop, Gen_Util.java:146-165); these tests pin the net-new
scheduler: request/response correctness vs the synchronous service,
coalescing under concurrency, pow2 bucketing, parameter grouping, and
error fan-out.
"""

import threading

import numpy as np
import pytest

from ppr_tpu.service import PPRService
from ppr_tpu.serving import PPRBatchServer, _pow2_bucket


@pytest.fixture(scope="module")
def svc(got):
    return PPRService.from_dataset(got, alpha=0.15, k=10, seed=5)


def test_pow2_bucket():
    assert _pow2_bucket(1) == 8
    assert _pow2_bucket(8) == 8
    assert _pow2_bucket(9) == 16
    assert _pow2_bucket(1024) == 1024


def test_batch_server_matches_sync(svc):
    sources = [3, 14, 50, 7, 3]
    want = svc.top_k(sources, k=10)
    with PPRBatchServer(svc, max_batch=64) as server:
        futs = [server.submit(s) for s in sources]
        got_rows = [f.result(timeout=120) for f in futs]
    for got_row, want_row in zip(got_rows, want):
        assert [h.node for h in got_row] == [h.node for h in want_row]
        np.testing.assert_allclose(
            [h.score for h in got_row], [h.score for h in want_row]
        )
    assert server.stats.requests == len(sources)
    assert server.stats.dispatched_rows == len(sources)


def test_batch_server_coalesces(svc):
    """Concurrent submissions end up in shared dispatches (fewer dispatches
    than requests), and pow2 bucketing pads the device batch."""
    n_req = 24
    with PPRBatchServer(svc, max_batch=64, max_delay_ms=30) as server:
        futs = []
        barrier = threading.Barrier(8)

        def client(base):
            barrier.wait()
            for s in range(base, base + 3):
                futs.append(server.submit(s % 20))

        threads = [threading.Thread(target=client, args=(i * 3,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows = [f.result(timeout=120) for f in futs]
    assert len(rows) == n_req
    assert all(len(r) >= 1 for r in rows)
    assert server.stats.requests == n_req
    assert server.stats.dispatches < n_req  # actually coalesced
    assert server.stats.mean_batch > 1.0


def test_batch_server_groups_params(svc):
    """Different (k, eps) never share a device batch, and each request gets
    the answer its own parameters produce (== the synchronous service's)."""
    want5 = svc.top_k([14], k=5)[0]
    want10 = svc.top_k([14], k=10)[0]
    with PPRBatchServer(svc, max_batch=64, max_delay_ms=30) as server:
        f1 = server.submit(14, k=5)
        f2 = server.submit(14, k=10)
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    assert [h.node for h in r1] == [h.node for h in want5]
    assert [h.node for h in r2] == [h.node for h in want10]
    assert server.stats.dispatches == 2  # params never share a batch


def test_batch_server_max_batch_splits(svc):
    """More queued than max_batch => multiple dispatches, all answered."""
    with PPRBatchServer(svc, max_batch=4, max_delay_ms=30) as server:
        futs = [server.submit(s % 20) for s in range(10)]
        rows = [f.result(timeout=120) for f in futs]
    assert len(rows) == 10
    assert server.stats.dispatches >= 3
    assert max(server.stats.batch_sizes) <= 4


def test_batch_server_error_fanout(svc):
    """A batch that raises fans the exception to every waiting future and
    the dispatcher survives to serve the next batch."""

    class Boom(RuntimeError):
        pass

    class FlakyService:
        def __init__(self, inner):
            self.inner = inner
            self.calls = 0

        def top_k(self, sources, k=None, eps=None):
            self.calls += 1
            if self.calls == 1:
                raise Boom("device fell over")
            return self.inner.top_k(sources, k=k, eps=eps)

    flaky = FlakyService(svc)
    with PPRBatchServer(flaky, max_batch=8) as server:
        fut = server.submit(3)
        with pytest.raises(Boom):
            fut.result(timeout=120)
        ok = server.submit(3).result(timeout=120)
    assert len(ok) >= 1
    assert server.stats.dispatches == 2


def test_batch_server_closed_rejects(svc):
    server = PPRBatchServer(svc, max_batch=8)
    server.close()
    with pytest.raises(RuntimeError):
        server.submit(1)


def test_serve_loop_jsonl(svc):
    """The stdio daemon loop: JSON-lines in, correlated responses out,
    stats command, malformed-request error line."""
    import io
    import json

    from ppr_tpu.serving import serve_loop

    reqs = [
        json.dumps({"source": 3, "id": "a"}),
        json.dumps({"source": 14, "id": "b", "k": 5}),
        "not json",
        json.dumps({"cmd": "stats", "id": "s"}),
    ]
    out = io.StringIO()
    stats = serve_loop(svc, iter(r + "\n" for r in reqs), out,
                       max_batch=8, max_delay_ms=10)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    by_id = {l["id"]: l for l in lines}
    assert stats.requests == 2
    want_a = svc.top_k([3], k=10)[0]
    assert by_id["a"]["hits"] == [[h.node, h.score, h.name] for h in want_a]
    want_b = svc.top_k([14], k=5)[0]
    assert by_id["b"]["hits"] == [[h.node, h.score, h.name] for h in want_b]
    assert "error" in by_id[2]          # malformed line -> ordinal id
    assert by_id["s"]["stats"]["requests"] >= 0


def test_latency_stats_recorded(svc):
    """Every completed request leaves a submit-to-result latency sample and
    the percentile summary is ordered (p50 <= p95 <= p99)."""
    sources = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    with PPRBatchServer(svc, max_batch=64) as server:
        futs = [server.submit(s) for s in sources]
        for f in futs:
            f.result(timeout=120)
        stats = server.stats
    assert len(stats.latencies_ms) == len(sources)
    assert all(x > 0 for x in stats.latencies_ms)
    pct = stats.latency_percentiles()
    assert pct["p50"] <= pct["p95"] <= pct["p99"]
    assert pct["p99"] <= max(stats.latencies_ms) + 1e-9


def test_latency_percentiles_empty():
    from ppr_tpu.serving import ServerStats

    assert ServerStats().latency_percentiles() == {
        "p50": None, "p95": None, "p99": None
    }


# ----------------------------------------------------------- SLO policy
class TimedFakeService:
    """Deterministic service-time model: t(width) = base + per_row * width.

    Affine in width: a fixed dispatch overhead plus a per-row cost past the
    knee; lets the SLO policy be pinned on CPU without a device.
    """

    def __init__(self, base_ms=1.0, per_row_ms=1.0):
        self.base_s = base_ms / 1e3
        self.per_row_s = per_row_ms / 1e3
        self.widths = []

    def top_k(self, sources, k=None, eps=None):
        import time as _t

        self.widths.append(len(sources))
        _t.sleep(self.base_s + self.per_row_s * len(sources))
        return [[(s, 1.0, str(s))] for s in sources]


def _flood(server, n, spacing_s=0.0):
    futs = [server.submit(i % 97) for i in range(n)]
    for f in futs:
        f.result(timeout=120)
    return futs


def test_slo_unattainable_grows_under_backlog():
    """SLO below the service-time intercept => no width can meet it; the
    policy must flip to best-effort (throughput) mode and GROW under
    backlog instead of pinning the cap at min_batch. (Pinning collapses
    capacity with a worse p50.)"""
    svc = TimedFakeService(base_ms=5.0, per_row_ms=5.0)  # t(8) = 45ms
    with PPRBatchServer(svc, max_batch=256, slo_ms=20.0, min_batch=8,
                        bucket=True) as server:
        _flood(server, 600)
        grew = any(c > 8 for _, c in server.stats.cap_moves)
    assert server.stats.slo_unattainable
    assert grew  # best-effort mode climbed the ladder under backlog
    assert max(svc.widths) > 8


def test_slo_unattainable_jumps_to_fastest_rung_when_idle():
    """Best-effort mode is latency-optimal when idle: after the idle
    hysteresis (2 consecutive no-backlog dispatches), the cap jumps DOWN
    to the sampled rung with the smallest warm service time. With service
    time increasing in width (fake: t = 5 + 5*w) that is min_batch; a
    one-rung-per-dispatch walk is NOT required (every sampled rung is
    already compiled, so the jump is free — and one-rung idle shrinking
    oscillates into queue spikes). A LONE idle gap must not move the cap
    down (an 8<->16 oscillation)."""
    svc = TimedFakeService(base_ms=5.0, per_row_ms=5.0)
    server = PPRBatchServer(svc, max_batch=256, slo_ms=20.0, min_batch=8,
                            bucket=True)
    try:
        # warm sample at the min rung, then hand the policy idle
        # dispatches at a burst-grown width.
        server._slo_update(8, 45.0, backlog=True)   # cold (skipped)
        server._slo_update(8, 45.0, backlog=True)   # warm -> unattainable
        server._slo_cap = 64                        # as if a burst grew it
        server._seen_width.update({16, 32, 64})
        server._slo_update(64, 325.0, backlog=False)  # idle #1: hysteresis
        assert server._slo_cap == 64                  # no lone-gap shrink
        server._slo_update(64, 325.0, backlog=False)  # idle #2
        assert server._slo_cap == 8                 # argmin t: straight home
    finally:
        server.close()
    assert server.stats.slo_unattainable


def test_slo_unattainable_idle_prefers_fast_wide_rung():
    """On hardware where t(width) is flat or inverted (here t(8)=1.79 s >
    t(256)=0.62 s), the latency-optimal idle width is the WIDE rung — the
    policy must not walk back to min_batch."""
    server = PPRBatchServer(TimedFakeService(base_ms=1.0, per_row_ms=0.0),
                            max_batch=256, slo_ms=200.0,
                            min_batch=8, bucket=True)
    try:
        server.slo_ms = 200.0
        for w, t in ((8, 1790.0), (64, 900.0), (256, 620.0)):
            server._slo_update(w, t, backlog=True)  # cold (skipped)
            server._slo_update(w, t, backlog=True)  # warm EWMA
        server._slo_cap = 64
        server._slo_update(64, 900.0, backlog=False)
        assert server._slo_cap == 256
    finally:
        server.close()
    assert server.stats.slo_unattainable


def test_slo_cap_grows_under_backlog_within_slo():
    """Fast service + standing backlog => the cap climbs the pow2 ladder,
    and dispatch widths actually follow it (throughput recovers)."""
    svc = TimedFakeService(base_ms=1.0, per_row_ms=0.01)  # t(256) ~= 3.6ms
    with PPRBatchServer(svc, max_batch=256, slo_ms=100.0, min_batch=8,
                        bucket=True) as server:
        _flood(server, 3000)
        cap = server._cap()
    assert cap == 256  # grew to the static max
    assert max(svc.widths) == 256
    # growth was rung-by-rung: no move jumps more than 2x
    caps = [8] + [c for _, c in server.stats.cap_moves]
    assert all(b in (a * 2, a // 2) for a, b in zip(caps, caps[1:]))


def test_slo_cold_sample_ignored():
    """A width's first-ever dispatch (compile-dominated) must not move the
    cap; the warm second sample governs."""
    from ppr_tpu.serving import PPRBatchServer as S

    svc = TimedFakeService(base_ms=1.0, per_row_ms=0.01)
    server = S.__new__(S)  # policy unit test: no threads
    server.slo_ms = 50.0
    server.max_batch = 256
    server.min_batch = 8
    server.bucket = True
    server.idle_hysteresis = 2
    server._slo_cap = 8
    server._svc_time_ms = {}
    server._svc_time_at = {}
    server._seen_width = set()
    server._idle_streak = 0
    server._backlog_streak = 0
    server.backlog_hysteresis = 3
    from ppr_tpu.serving import ServerStats

    server.stats = ServerStats()
    server._slo_update(8, 30_000.0, backlog=True)  # cold compile: 30s
    assert server._slo_cap == 8 and not server._svc_time_ms
    server._slo_update(8, 2.0, backlog=True)  # warm: 4*2ms <= 50ms -> grow
    assert server._slo_cap == 16
    server._slo_update(16, 40.0, backlog=True)  # cold at 16: ignored
    assert server._slo_cap == 16
    server._slo_update(16, 40.0, backlog=True)  # warm: 2*40 > 50 -> shrink
    assert server._slo_cap == 8


def test_slo_off_uses_static_cap():
    svc = TimedFakeService(base_ms=0.1, per_row_ms=0.01)
    with PPRBatchServer(svc, max_batch=16) as server:
        assert server._cap() == 16
        _flood(server, 40)
    assert max(svc.widths) <= 16
    assert server.stats.cap_moves == []


def test_prewarm_seeds_full_ladder():
    """prewarm=True compiles every pow2 rung up to max_batch and seeds a
    warm EWMA for each BEFORE serving — the structural fix for the
    capacity collapse where wide rungs' only dispatches were cold compiles
    whose samples the policy (correctly) skipped, leaving the idle argmin
    blind to the fast wide rungs."""
    svc = TimedFakeService(base_ms=1.0, per_row_ms=0.01)
    with PPRBatchServer(svc, max_batch=64, slo_ms=1000.0,
                        prewarm=True) as server:
        assert sorted(server._svc_time_ms) == [8, 16, 32, 64]
        assert server.stats.prewarmed_widths == [8, 16, 32, 64]
        # two dispatches per rung: one cold (compile), one warm (sample)
        assert svc.widths == [8, 8, 16, 16, 32, 32, 64, 64]
        assert all(t > 0 for t in server._svc_time_ms.values())


def test_prewarmed_unattainable_jumps_straight_to_fast_wide_rung():
    """With an inverted t(width) backend (wide = fast) and an unattainable
    SLO, a prewarmed server must converge its cap to the wide rung and STAY
    there — the capacity-collapse regression test (cap stuck oscillating
    8<->16 at a fraction of the static-cap throughput)."""

    class InvertedService(TimedFakeService):
        # t(w) = 60 - 0.2*w ms: t(8)=58.4, t(256)=8.8 (monotone inverted)
        def top_k(self, sources, k=None, eps=None):
            import time as _t

            self.widths.append(len(sources))
            _t.sleep((60.0 - 0.2 * len(sources)) / 1e3)
            return [[(s, 1.0, str(s))] for s in sources]

    svc = InvertedService()
    with PPRBatchServer(svc, max_batch=256, slo_ms=10.0, min_batch=8,
                        prewarm=True) as server:
        _flood(server, 40)          # light trickle: little to no backlog
        cap_after_trickle = server._cap()
        _flood(server, 600)         # heavier load
        final_cap = server._cap()
    assert server.stats.slo_unattainable       # 2*t(256) > 10ms: truly so
    assert cap_after_trickle == 256            # idle argmin jump went UP
    assert final_cap == 256
    # and it never walked back down once there
    caps = [c for _, c in server.stats.cap_moves]
    assert caps and caps[-1] == 256
    assert all(c >= caps[i] for i, c in enumerate(caps[1:]))


def test_unprewarmed_unattainable_explores_ladder():
    """Without prewarm, best-effort mode must still DISCOVER fast wide
    rungs by padding dispatches up the ladder while the warm trend is
    non-increasing (exploration), rather than waiting for backlog that
    light load never produces (otherwise wide rungs are never
    sampled)."""

    class FlatService(TimedFakeService):
        # flat t(w): wider is never worse -> exploration should reach 64
        def top_k(self, sources, k=None, eps=None):
            import time as _t

            self.widths.append(len(sources))
            _t.sleep(0.01)
            return [[(s, 1.0, str(s))] for s in sources]

    svc = FlatService()
    with PPRBatchServer(svc, max_batch=64, slo_ms=5.0, min_batch=8) as server:
        for _ in range(24):          # sequential singles: zero backlog
            server.submit(1).result(timeout=120)
    assert server.stats.slo_unattainable
    assert sorted(server._svc_time_ms) == [8, 16, 32, 64]  # fully explored
    assert max(svc.widths) == 64


def test_slo_unattainable_flag_clears_on_recovery():
    """stats.slo_unattainable tracks the CURRENT regime: a later warm
    sample proving the SLO attainable clears it (a latch would misreport
    recovered runs); slo_unattainable_ever keeps the record."""
    svc = TimedFakeService(base_ms=1.0, per_row_ms=0.01)
    server = PPRBatchServer(svc, max_batch=256, slo_ms=50.0, min_batch=8)
    try:
        server._slo_update(8, 100.0, backlog=True)   # cold (skipped)
        server._slo_update(8, 100.0, backlog=True)   # warm: unattainable
        assert server.stats.slo_unattainable
        # transient cleared (an outlier polluted the EWMA);
        # fresh fast samples pull the EWMA back under the SLO
        for _ in range(6):
            server._slo_update(8, 4.0, backlog=True)
        assert not server.stats.slo_unattainable     # cleared
        assert server.stats.slo_unattainable_ever    # history retained
    finally:
        server.close()


def test_stale_ewma_reprobed():
    """A wider rung whose EWMA has not been refreshed in `stale_after`
    dispatches gets re-dispatched (probe) so a transient outlier cannot
    disable widening forever."""
    svc = TimedFakeService(base_ms=1.0, per_row_ms=0.01)
    server = PPRBatchServer(svc, max_batch=64, stale_after=10)
    try:
        # warm rung 64 with an outlier sample (slower than rung 8)
        server._seen_width.add(64)
        server._note_service_time(64, 500.0)
        server._seen_width.add(8)
        server._note_service_time(8, 2.0)
        server.stats.dispatches = 100     # rung 64's sample is now stale
        w = server._choose_width(3)
        assert w == 64                    # probe re-dispatches the stale rung
        # a second probe within 64 dispatches is suppressed
        assert server._choose_width(3) == 8
    finally:
        server.close()


def _policy_server(slo_ms=800.0, max_batch=256, warm=None, cap=64):
    """Thread-less policy harness: a server shell with seeded warm EWMAs."""
    from ppr_tpu.serving import PPRBatchServer as S, ServerStats

    server = S.__new__(S)
    server.slo_ms = slo_ms
    server.max_batch = max_batch
    server.min_batch = 8
    server.bucket = True
    server.idle_hysteresis = 2
    server._slo_cap = cap
    server._svc_time_ms = dict(warm or {})
    server._svc_time_at = {w: 0 for w in (warm or {})}
    server._seen_width = set(warm or {})
    server._idle_streak = 0
    server._backlog_streak = 0
    server.backlog_hysteresis = 3
    server.stats = ServerStats()
    return server


def test_slo_breach_jumps_to_fastest_warm_rung_not_halving():
    """Shrink-spiral regression: when the current rung's EWMA inflates
    past the SLO under sustained load while other warm rungs still fit,
    the cap must jump to the fastest warm rung in ONE move — a halving
    walk goes 64->32->16 (the latency-pessimal direction on an
    inverted-t(width) backend) for hundreds of dispatches."""
    server = _policy_server(
        warm={8: 500.0, 64: 420.0, 256: 250.0}, cap=64)
    # sustained-load sample at the current rung inflates its EWMA past the
    # SLO: EWMA(64) = 0.5*420 + 0.5*500 = 460 -> 2*460 = 920 > 800
    server._slo_update(64, 500.0, backlog=True)
    assert server._slo_cap == 256          # one evidence-based move, UP
    assert server.stats.cap_moves == [(0, 256)]
    assert not server.stats.slo_unattainable  # t(256) still fits


def test_slo_breach_blind_shrink_refused_under_backlog():
    """With no warm sample below the current rung, the cold-start halving
    fallback must NOT fire while backlog exists (a shrink pushes
    throughput below the offered load by construction — the v3 spiral's
    mechanism). It may fire once the stream goes idle."""
    # 128's warm EWMA still fits (2*395 <= 800) so best-effort does not
    # engage, but it is not 10% faster than the inflating current rung,
    # so there is no evidence-based jump either — only the blind fallback
    # is in play, and the rung below (32) has never been sampled.
    server = _policy_server(warm={64: 400.0, 128: 395.0}, cap=64)
    server._slo_update(64, 440.0, backlog=True)   # EWMA 420: breach
    assert server._slo_cap == 64                  # held under backlog
    server._slo_update(64, 440.0, backlog=False)  # idle: explore down
    assert server._slo_cap == 32


def test_slo_breach_jump_beats_classic_shrink_when_evidence_exists():
    """On a classic (t rising with width) backend the breach jump goes
    DOWN — but straight to the best warm rung, using evidence rather than
    one blind halving per dispatch. v5: the downward jump is refused
    under backlog (rows/sec at 8 is below rung 64's — a throughput trap)
    and waits out idle_hysteresis when idle, exactly like the
    best-effort idle move."""
    server = _policy_server(
        warm={8: 100.0, 16: 150.0, 64: 350.0}, cap=64)
    server._slo_update(64, 550.0, backlog=True)   # EWMA 450: breach
    assert server._slo_cap == 64                  # backlog: hold, no trap
    server._slo_update(64, 550.0, backlog=False)  # idle #1: hysteresis
    assert server._slo_cap == 64
    server._slo_update(64, 550.0, backlog=False)  # idle #2
    assert server._slo_cap == 8                   # argmin, in one move


def test_explore_width_fills_ladder_gaps_from_below():
    """A burst-warmed high rung must not hide unwarmed rungs
    below it — exploration returns the first unwarmed rung >= the natural
    width, scanning the ladder from the bottom."""
    server = _policy_server(slo_ms=5.0, max_batch=64,
                            warm={8: 100.0, 64: 100.0}, cap=8)
    server.adaptive_width = True
    server.stats.slo_unattainable = True
    assert server._explore_width(8) == 16         # the gap, not None


def test_explore_width_rising_trend_uses_adjacent_rungs():
    """The rising-trend stop compares ADJACENT warmed rungs: t clearly
    rising at the warm frontier halts the climb; a noisy global min
    elsewhere must not."""
    server = _policy_server(slo_ms=5.0, max_batch=128,
                            warm={8: 100.0, 16: 90.0, 32: 200.0}, cap=8)
    server.stats.slo_unattainable = True
    assert server._explore_width(8) is None       # 200 > 1.2*90: rising


def test_prewarm_transient_failure_skips_rung():
    """A width that fails during the ladder probe fails server
    construction: a server that cannot run one of its own widths is not
    ready to serve, and a retry-and-skip would hide a device fault."""
    import pytest

    from ppr_tpu.serving import PPRBatchServer

    class FailsAt32(TimedFakeService):
        def top_k(self, sources, k=None, eps=None):
            if len(sources) == 32:
                raise RuntimeError("device failure at width 32")
            return super().top_k(sources, k, eps)

    svc = FailsAt32(base_ms=1.0, per_row_ms=0.01)
    with pytest.raises(RuntimeError, match="width 32"):
        PPRBatchServer(svc, max_batch=64, slo_ms=1000.0, prewarm=True)
    # the rungs below the failing one ran once cold, once warm; no retry
    assert svc.widths == [8, 8, 16, 16]


def test_sustained_backlog_jumps_to_max_throughput_rung():
    """Under SUSTAINED backlog latency is queue-dominated — the 2*t model
    undercounts — so after backlog_hysteresis backlogged dispatches the
    cap must jump to the max rows/sec rung regardless of per-dispatch
    SLO fit. The profile below: t(16)=289 ms looks SLO-optimal but drains
    55 rows/s against a higher offered load."""
    server = _policy_server(
        warm={16: 289.0, 64: 404.0, 256: 625.0}, cap=16)
    for _ in range(3):
        server._slo_update(16, 289.0, backlog=True)
    # 256/625 beats 64/404 beats 16/289 in rows per second
    assert server._slo_cap == 256
    # and the queue-clearing idle logic can later walk it back down;
    # sustained backlog itself never reduces the drain rate
    caps = [c for _, c in server.stats.cap_moves]
    assert caps == [256]


def test_transient_backlog_breach_holds_instead_of_latency_trap():
    """v5: a breach under TRANSIENT backlog must not jump to a
    faster-per-dispatch rung whose rows/sec is lower (the throughput
    trap that parked v4 on rung 16 and queued 14.8 s of p95)."""
    server = _policy_server(
        warm={16: 289.0, 64: 404.0, 256: 625.0}, cap=64)
    server._slo_update(64, 420.0, backlog=True)   # EWMA 412: breach
    assert server._slo_cap == 64                  # hold: 16 is a trap
    assert server.stats.cap_moves == []
