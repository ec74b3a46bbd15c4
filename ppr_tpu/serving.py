"""Serve-time micro-batching scheduler.

The engine's per-query cost divides by the batch size up to a device knee,
so a production deployment must *coalesce* concurrent queries into device
batches rather than dispatch them one by one — the reference has no serving
story at all (its only driver is the sequential benchmark loop,
Gen_Util.java:146-165).

:class:`PPRBatchServer` wraps a :class:`~ppr_tpu.service.PPRService` with a
single dispatcher thread (one device => one device stream):

* ``submit(source, ...)`` returns a ``concurrent.futures.Future`` at once;
* the dispatcher drains whatever has queued, groups requests by their
  ``(k, eps)`` parameters (different params are different compiled
  programs), and runs one batched ``top_k`` per group;
* batches are padded up to a power-of-two bucket before hitting the device
  so the engine compiles O(log max_batch) distinct shapes instead of one
  per arrival-count — each new shape is an XLA compile, so an unbucketed
  server would stall on nearly every distinct load level.

The scheduling policy is deliberately "drain, don't wait": while the
device is busy with batch t, every arrival queues and forms batch t+1.
Under load the batch size self-regulates toward throughput saturation
(arrival rate x device latency), and an idle server dispatches a lone
query immediately — no artificial latency floor. ``max_delay_ms`` adds an
optional accumulation window for latency-tolerant, bursty clients;
``max_batch`` caps a dispatch at the knee (excess stays queued).

``slo_ms`` replaces the static cap with a latency-targeted one: a
request's worst-case submit-to-result latency is about two dispatch
service times (wait for the in-flight batch, then ride the next), so the
scheduler walks the pow2 bucket ladder multiplicatively — halving the cap
when ``2 * t(width) > slo_ms``, doubling it (under backlog) only when the
measured service time proves the next rung still fits. Multiplicative
moves keep the number of distinct compiled widths O(log max_batch); a
continuous-valued cap would compile a program per value. The first
dispatch at a new width pays that compile; its service-time sample is
taken on a second, warm dispatch (the EWMA skips cold-compile outliers by
construction: compile times exceed the SLO and would otherwise wrongly
shrink the cap, so the update ignores a width's first-ever sample).

When even the fastest observed width breaches the SLO — the target sits
below the service-time *intercept*, which no batch width can shrink — the
policy flips to best-effort mode (``stats.slo_unattainable``): grow under
backlog, and when the queue clears jump to the sampled rung with the
smallest warm service time (the latency-optimal width — on a device whose
service time is flat or inverted in width, the *widest* rung: narrow
batches idle the device while paying the same annealed sweep train). The
naive alternatives all failed when measured: pinning the cap at
``min_batch`` collapsed capacity while raising p50; shrink-one-rung-on-idle
oscillated into queue spikes; and an argmin jump without warm samples of
the wide rungs still collapsed capacity, because the wide rungs' only
dispatches were cold compiles whose samples the EWMA skips — the argmin
never saw a wide rung. The fix is structural, not another jump rule:

* :meth:`PPRBatchServer.prewarm` compiles EVERY pow2 rung up to
  ``max_batch`` at startup and seeds each rung's EWMA from a second, warm
  dispatch — serving traffic then never pays a cold compile and the
  argmin ranks the full ladder from the first dispatch (``prewarm=True``
  or the daemon's ``--prewarm``);
* for servers that skip prewarm, best-effort idle dispatches *explore*:
  while the warm-EWMA trend is non-increasing in width, the cap climbs
  one unsampled rung instead of jumping, so an inverted-t(width) device
  gets its wide rungs sampled even when backlog never forms;
* downward idle jumps wait for ``idle_hysteresis`` consecutive
  no-backlog dispatches (a lone idle gap in a busy stream no longer
  resets the ladder climb);
* ``stats.slo_unattainable`` tracks the CURRENT regime (it clears when a
  warm rung proves the SLO attainable again); ``slo_unattainable_ever``
  records whether best-effort mode was ever entered.

On an SLO breach the cap JUMPS to the fastest warm rung in one
evidence-based move instead of blindly halving. Halving assumes the
classic t-rises-with-width batching model; where t(width) is inverted,
each halving moves latency the wrong way — under sustained mid-range load
the current rung's EWMA inflates past the SLO while stale prewarm seeds at
other rungs still fit, and a halving walk shrinks the cap for hundreds of
dispatches. Blind halving survives only as an idle-time exploration
fallback when the rung below has never been sampled (a cold-start classic
device still finds its way down); it is refused under backlog, where
shrinking pushes throughput below the offered load by construction. When
every warm rung breaches, the best-effort flip takes over in one move.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class ServerStats:
    requests: int = 0
    dispatches: int = 0
    dispatched_rows: int = 0
    padded_rows: int = 0
    batch_sizes: list = field(default_factory=list)
    latencies_ms: list = field(default_factory=list)
    #: (dispatch ordinal, new cap) every time the SLO policy moves the cap
    cap_moves: list = field(default_factory=list)
    #: True while the SLO policy's CURRENT warm samples show even the
    #: fastest width breaching the SLO (target below the service-time
    #: intercept) — best-effort mode. Clears if later samples prove the
    #: SLO attainable (a latch would misreport runs that recovered).
    slo_unattainable: bool = False
    #: latched: best-effort mode was entered at least once in this
    #: server's lifetime (the old latching semantics, kept for the record)
    slo_unattainable_ever: bool = False
    #: widths compiled + EWMA-seeded by :meth:`PPRBatchServer.prewarm`
    prewarmed_widths: list = field(default_factory=list)
    #: dispatches padded past their pow2 bucket because a wider rung's
    #: warm EWMA was >=10% faster (the inverted-t(width) case)
    widened_dispatches: int = 0
    #: cap on retained per-request samples; a long-running daemon would
    #: otherwise grow without bound (~49M floats/day at the measured qps)
    max_latency_samples: int = 1_000_000

    @property
    def mean_batch(self) -> float:
        return (self.dispatched_rows / self.dispatches) if self.dispatches else 0.0

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Submit-to-result latency percentiles over all completed requests.

        A retrieval engine's serving headline is latency as much as
        throughput (the reference never serves, so this is new surface);
        measured under load by scripts/serving_latency.py.
        """
        if not self.latencies_ms:
            return {f"p{q}": None for q in qs}
        xs = sorted(self.latencies_ms)
        out = {}
        for q in qs:
            # nearest-rank percentile: robust for the small-sample tails
            i = min(len(xs) - 1, max(0, int(round(q / 100.0 * len(xs))) - 1))
            out[f"p{q}"] = xs[i]
        return out


def _pow2_bucket(b: int, lo: int = 8) -> int:
    n = lo
    while n < b:
        n <<= 1
    return n


def _ladder(lo: int, hi: int):
    """All pow2 rungs in [lo, hi]."""
    w = lo
    while w <= hi:
        yield w
        w <<= 1


class PPRBatchServer:
    """Micro-batching front end for :class:`~ppr_tpu.service.PPRService`.

    >>> server = PPRBatchServer(svc, max_batch=1024)
    >>> fut = server.submit(41)           # returns immediately
    >>> hits = fut.result()               # list[TopKHit] for source 41
    """

    def __init__(self, service, *, max_batch: int = 1024,
                 max_delay_ms: float = 0.0, bucket: bool = True,
                 slo_ms: float | None = None, min_batch: int = 8,
                 adaptive_width: bool = True, prewarm: bool = False,
                 idle_hysteresis: int = 2, backlog_hysteresis: int = 3,
                 probe_source: int = 0, stale_after: int = 512):
        self._svc = service
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.bucket = bucket
        self.slo_ms = float(slo_ms) if slo_ms else None
        self.min_batch = int(min_batch)
        self.adaptive_width = bool(adaptive_width) and bucket
        #: consecutive no-backlog dispatches required before a *downward*
        #: idle cap move (a lone idle gap in a busy stream must not reset
        #: a ladder climb into an 8<->16 oscillation)
        self.idle_hysteresis = int(idle_hysteresis)
        #: consecutive backlogged dispatches before latency is treated as
        #: queue-dominated and the cap jumps to the max-rows/sec rung
        #: (v5 — see _slo_update)
        self.backlog_hysteresis = int(backlog_hysteresis)
        #: refresh horizon for per-width EWMAs (in dispatches): a rung not
        #: sampled for this long is re-probed rather than trusted forever
        self.stale_after = int(stale_after)
        # SLO policy state: current cap on the pow2 ladder, one warm
        # service-time EWMA per dispatched width (cold first samples at a
        # width are compile-dominated and are skipped — see module
        # docstring), the set of widths already seen once, the dispatch
        # ordinal of each rung's last sample, and the idle-streak counter.
        self._slo_cap = _pow2_bucket(self.min_batch)
        self._svc_time_ms: dict[int, float] = {}
        self._svc_time_at: dict[int, int] = {}
        self._seen_width: set[int] = set()
        self._idle_streak = 0
        self._backlog_streak = 0
        self._last_probe = -(1 << 30)
        self.stats = ServerStats()
        self._lock = threading.Condition()
        self._queue: list[
            tuple[int, int | None, float | None, Future, float]
        ] = []
        self._closed = False
        if prewarm:
            # before the dispatcher starts, so no service-call race
            self.prewarm(source=probe_source)
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="ppr-batch-dispatch", daemon=True
        )
        self._thread.start()

    def prewarm(self, source: int = 0, verbose: bool = True) -> None:
        """Compile every pow2 rung up to ``max_batch`` and seed its EWMA.

        Each rung is dispatched twice with a dummy batch: the first pays
        the XLA compile, the second's wall time seeds ``_svc_time_ms``
        with a genuinely warm sample. After this, no serving dispatch ever
        pays a cold compile, and the SLO policy's argmin ranks the FULL
        ladder from the first request — without it, wide rungs' only
        dispatches are cold compiles whose samples the EWMA (correctly)
        skips, leaving the argmin blind to them.

        Called from ``__init__`` when ``prewarm=True`` (before the
        dispatcher thread starts); safe to call explicitly before serving
        traffic. A rung that fails raises: a server that cannot run one of
        its own widths is not ready to serve.
        """
        if getattr(self._svc, "supports_stream", False):
            # warm the cohort path's per-row programs (different programs
            # from the batch-global kernel)
            def run(batch):
                self._svc.top_k_stream(batch, emit=lambda *a: None)
        else:
            def run(batch):
                self._svc.top_k(batch)

        # Spread probe sources over real nodes when the service exposes
        # its node count: W copies of one source would (a) measure only
        # that source's sweep train — the annealed batch runs until the
        # SLOWEST row settles, so a single easy source seeds an
        # unrepresentative EWMA — and (b) retire a cohort-streaming
        # dispatch in one stage, never exercising the ladder's
        # staggered-retirement path.
        n = int(getattr(self._svc, "n_nodes", 0) or 0)

        def probe_batch(width):
            if n > 1:
                return [(int(source) + i * 7919) % n for i in range(width)]
            return [int(source)] * width

        w = _pow2_bucket(self.min_batch)
        while w <= self.max_batch:
            batch = probe_batch(w)
            t0 = time.perf_counter()
            run(batch)              # cold: compile + run
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(batch)              # warm: true service time
            t_warm = (time.perf_counter() - t0) * 1e3
            self._seen_width.add(w)
            self._svc_time_ms[w] = t_warm
            self._svc_time_at[w] = 0
            self.stats.prewarmed_widths.append(w)
            if verbose:
                # stderr: stdout may be the daemon's JSON-lines channel
                print(f"prewarm width {w}: cold {t_cold:.1f}s, "
                      f"warm {t_warm:.0f}ms", file=sys.stderr, flush=True)
            w <<= 1

    # ------------------------------------------------------------------ API
    def submit(self, source: int, k: int | None = None,
               eps: float | None = None) -> Future:
        """Enqueue one top-k query; resolves to a list of TopKHit."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self.stats.requests += 1
            self._queue.append((int(source), k, eps, fut, time.perf_counter()))
            self._lock.notify()
        return fut

    def top_k(self, source: int, k: int | None = None,
              eps: float | None = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(source, k, eps).result()

    def close(self) -> None:
        """Drain the queue, then stop the dispatcher."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- dispatcher
    def _cap(self) -> int:
        """Current dispatch cap: the static knob, or the SLO policy's rung."""
        if self.slo_ms is None:
            return self.max_batch
        return min(self.max_batch, self._slo_cap)

    def _take_batch(self):
        """Block until work (or close); return one (k, eps) -> requests dict."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if not self._queue:
                return None
            cap = self._cap()
            if self.max_delay_s > 0 and len(self._queue) < cap:
                # optional accumulation window for bursty clients
                self._lock.wait(timeout=self.max_delay_s)
            groups: dict[tuple, list] = defaultdict(list)
            rest = []
            for item in self._queue:
                key = (item[1], item[2])
                if len(groups[key]) < cap:
                    groups[key].append(item)
                else:
                    rest.append(item)
            self._queue = rest
            return groups, len(rest)

    def _note_service_time(self, width: int, service_ms: float):
        """Fold a timed dispatch into the per-width warm EWMA.

        Returns the updated EWMA, or None for a width's first-ever sample:
        that one is compile-dominated, not service time. (Unbucketed servers recompile constantly anyway — there the
        skip would ignore nearly every sample, so don't.)
        """
        first = width not in self._seen_width
        self._seen_width.add(width)
        if first and self.bucket:
            return None
        prev = self._svc_time_ms.get(width, service_ms)
        t = 0.5 * prev + 0.5 * service_ms
        self._svc_time_ms[width] = t
        self._svc_time_at[width] = self.stats.dispatches
        return t

    def _choose_width(self, b: int) -> int:
        """Dispatch width for a ``b``-row batch: the pow2 bucket, widened
        to a strictly-faster sampled rung when the warm EWMAs prove one.

        Where service time is INVERTED in width (a narrow dispatch idles
        the device while paying the same annealed sweep train), padding a
        16-row batch up to a 256-wide program is a pure latency win. The 10%
        margin keeps noise from flapping the width; every candidate rung
        is already compiled (it has a warm sample by construction).
        """
        width = min(_pow2_bucket(b), max(self.max_batch, 8))
        if not self.adaptive_width:
            return width
        explore = self._explore_width(width)
        if explore is not None:
            return explore
        t_cur = self._svc_time_ms.get(width)
        if t_cur is None:
            return width
        hi = max(self.max_batch, 8)
        cands = [w for w, tw in self._svc_time_ms.items()
                 if width < w <= hi and tw < 0.9 * t_cur]
        if not cands:
            # Staleness probe: a rung whose EWMA hasn't been refreshed in
            # `stale_after` dispatches may be carrying a transient outlier
            # that silently
            # disabled widening forever. Re-dispatch at the stalest such
            # rung, at most once per 64 dispatches, so estimates decay
            # toward reality instead of freezing.
            now = self.stats.dispatches
            stale = [w for w, at in self._svc_time_at.items()
                     if width < w <= hi and now - at > self.stale_after]
            if stale and now - self._last_probe > 64:
                self._last_probe = now
                return min(stale, key=lambda w: self._svc_time_at[w])
            return width
        self.stats.widened_dispatches += 1
        return min(cands, key=self._svc_time_ms.get)

    def _explore_width(self, width: int) -> int | None:
        """Best-effort-mode ladder exploration: the next rung to pad a
        dispatch up to so it gains a warm sample.

        Under an unattainable SLO at light load, backlog never forms, so
        organic dispatches stay narrow and the fast wide rungs of an
        inverted-t(width) device are never even compiled (the argmin only
        ever sees the narrow rungs). While the warm trend is
        non-increasing in width (wider is not hurting), pad dispatches up
        the ladder one unwarmed rung at a time: the first dispatch at a
        rung pays its compile, the second leaves a warm EWMA, then the
        climb continues — 2*O(log max_batch) exploratory dispatches
        total, after which the argmin ranks the full ladder. A prewarmed
        server (``prewarm=True``) starts fully warm and never explores.
        """
        if self.slo_ms is None or not self.stats.slo_unattainable:
            return None
        warm = self._svc_time_ms
        if not warm:
            return None
        lo = _pow2_bucket(self.min_batch)
        hi = max(self.max_batch, lo)
        # Rising-trend stop on ADJACENT warmed rungs (comparing the top
        # rung against the global min lets one noisy top sample halt
        # exploration forever, and a burst-warmed high rung hides the
        # unwarmed gap below it).
        ws = [w for w in _ladder(lo, hi) if w in warm]
        if len(ws) >= 2 and warm[ws[-1]] > 1.2 * warm[ws[-2]]:
            return None            # t clearly rising at the warm frontier
        for nxt in _ladder(lo, hi):
            if nxt >= width and nxt not in warm:
                return nxt
        return None

    def _slo_update(self, width: int, service_ms: float, backlog: bool):
        """Move the cap after a timed dispatch (SLO mode only).

        Worst-case request latency ~= 2 * t(width): wait out the in-flight
        dispatch, then ride the next. On breach, jump to the fastest warm
        rung in one move (v4 — see module docstring; blind halving only as
        an idle cold-start fallback when the rung below is unsampled);
        grow one rung under backlog when the *predicted* time at the next
        rung still fits (service time is affine in width with a positive
        intercept, so t(2w) <= 2*t(w) — doubling is safe iff 4*t(w) <= slo,
        or iff the next rung's own warm EWMA already fits).
        """
        t = self._note_service_time(width, service_ms)
        self._idle_streak = 0 if backlog else self._idle_streak + 1
        self._backlog_streak = self._backlog_streak + 1 if backlog else 0
        if t is None:
            return
        cap = self._slo_cap
        lo = _pow2_bucket(self.min_batch)
        hi = self.max_batch
        warm = self._svc_time_ms
        t_best = min(warm.values())
        # Current-regime flag: set while the fastest warm rung breaches
        # the SLO, cleared the moment a warm rung proves it attainable.
        # The `_ever` latch keeps the historical record.
        unattainable = 2.0 * t_best > self.slo_ms
        self.stats.slo_unattainable = unattainable
        if unattainable:
            # The target sits below the service-time intercept, so NO
            # width can meet it (t is affine in width). Pinning the cap at
            # min_batch collapses capacity, and an argmin jump without
            # warm wide rungs collapses it too. Best-effort: maximize
            # throughput under backlog, sit on the warm-argmin rung when
            # idle (where t(width) is inverted, that is the widest rung),
            # and rely on prewarm/exploration (`_explore_width`) to make
            # the ladder actually warm.
            self.stats.slo_unattainable_ever = True
            if backlog and cap < hi:
                if all(w in warm for w in _ladder(lo, hi)):
                    # fully-warm ladder: jump straight to the best
                    # rows-per-second rung (every rung is compiled, the
                    # jump is free)
                    best = max(warm, key=lambda w: w / warm[w])
                    self._slo_cap = min(max(best, cap), hi)
                else:
                    self._slo_cap = cap * 2
            elif not backlog:
                # Latency-optimal rung: the warm argmin. Jumps UP are
                # immediate; jumps DOWN wait for `idle_hysteresis`
                # consecutive idle dispatches so a lone gap in a busy
                # stream cannot reset a ladder climb (an 8<->16
                # oscillation).
                best = min(warm, key=warm.get)
                new = min(max(best, lo), hi)
                if new > cap or self._idle_streak >= self.idle_hysteresis:
                    self._slo_cap = new
        elif backlog and self._backlog_streak >= self.backlog_hysteresis:
            # SUSTAINED backlog means request latency is queue-dominated
            # and the 2*t dispatch model undercounts it — any rung whose
            # rows/sec sits below the offered load only grows the queue,
            # however fast one dispatch looks (a breach jump that parks
            # the cap on a latency-optimal but low-throughput rung turns
            # into pure queueing). Serve the queue at the max-throughput
            # rung until it clears; the idle logic then restores the
            # latency-optimal rung. Never shrink here.
            best = max((w for w in warm if lo <= w <= hi),
                       key=lambda w: w / warm[w], default=None)
            cap_t = warm.get(cap)
            cap_rps = (cap / cap_t) if cap_t else 0.0
            if best is not None and best != cap \
                    and best / warm[best] > 1.1 * cap_rps:
                # argmax rows/sec over warm rungs by definition never
                # reduces the drain rate, whichever direction it lies;
                # the 10% margin keeps noisy near-equal rungs from
                # ping-ponging the cap (which would starve the grow
                # probe below)
                self._slo_cap = min(max(best, lo), hi)
            elif cap < hi:
                # no clearly-better warm rung: probe one rung wider (the
                # queue pays one cold compile, which the EWMA skips) —
                # without this the sustained branch would pin the cap
                # inside the warmed prefix of the ladder forever
                self._slo_cap = cap * 2
        elif 2.0 * t > self.slo_ms:
            # Breach rule: one evidence-based jump to the fastest warm
            # rung, never a blind halving walk. Margin (10%) keeps two
            # near-equal rungs from flapping. Since t breaches but t_best
            # fits (the unattainable branch above owns the all-breach
            # case), the jump target meets the SLO. Constraints: under
            # (transient) backlog only THROUGHPUT-SAFE jumps (rows/sec at
            # least the current rung's) are allowed, and downward jumps
            # when idle wait out `idle_hysteresis` like the best-effort
            # idle move — both guards exist because the latency-optimal
            # rung may be a throughput trap (see the branch above).
            cands = {w: tw for w, tw in warm.items()
                     if lo <= w <= hi and tw < 0.9 * t}
            if backlog:
                cur_rps = width / max(t, 1e-9)
                cands = {w: tw for w, tw in cands.items()
                         if w / tw >= cur_rps}
            if cands:
                best = min(cands, key=cands.get)
                new = min(max(best, lo), hi)
                if new >= cap or backlog \
                        or self._idle_streak >= self.idle_hysteresis:
                    self._slo_cap = new
            elif cap > lo and (cap // 2) not in warm and not backlog:
                # cold-start fallback only: the rung below was never
                # sampled, so explore downward (classic-backend prior) —
                # never under backlog (the v3 spiral's mechanism).
                self._slo_cap = max(lo, cap // 2)
            # else: hold — the current rung is the best evidence we have
        elif backlog and cap < hi:
            up = warm.get(cap * 2)
            fits = (2.0 * up <= self.slo_ms) if up is not None \
                else (4.0 * t <= self.slo_ms)
            if fits:
                self._slo_cap = cap * 2
        if self._slo_cap != cap:
            self.stats.cap_moves.append((self.stats.dispatches, self._slo_cap))

    def _dispatch_loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            groups, n_rest = taken
            for (k, eps), items in groups.items():
                sources = [s for s, _, _, _, _ in items]
                futs = [f for _, _, _, f, _ in items]
                submits = [t for _, _, _, _, t in items]
                b = len(sources)
                width = b
                if self.bucket:
                    width = self._choose_width(b)
                    self.stats.padded_rows += width - b
                    sources = sources + [sources[0]] * (width - b)
                self.stats.dispatches += 1
                self.stats.dispatched_rows += b
                self.stats.batch_sizes.append(b)
                lat = self.stats.latencies_ms
                stream = getattr(self._svc, "supports_stream", False)
                t0 = time.perf_counter()
                try:
                    if stream:
                        # cohort streaming: a row's future resolves the
                        # moment ITS cohort retires — fast rows stop
                        # paying for the slowest row's sweep train
                        resolved = [False] * b

                        def emit(idxs, hits_rows, _r=resolved, _f=futs,
                                 _s=submits):
                            now = time.perf_counter()
                            for i, row in zip(idxs, hits_rows):
                                i = int(i)
                                if i < len(_f) and not _r[i]:
                                    _r[i] = True
                                    lat.append((now - _s[i]) * 1e3)
                                    _f[i].set_result(row)

                        self._svc.top_k_stream(sources, k=k, eps=eps,
                                               emit=emit)
                        for i, done_i in enumerate(resolved):
                            if not done_i:
                                futs[i].set_exception(RuntimeError(
                                    "cohort stream ended without this row"
                                ))
                    else:
                        rows = self._svc.top_k(sources, k=k, eps=eps)
                except Exception as e:  # noqa: BLE001 - fan the error out
                    for f in futs:
                        if not f.done():
                            f.set_exception(e)
                    continue
                done = time.perf_counter()
                if self.slo_ms is not None:
                    with self._lock:
                        backlog = n_rest > 0 or bool(self._queue)
                    self._slo_update(width, (done - t0) * 1e3, backlog)
                else:
                    # keep the per-width EWMAs warm for _choose_width
                    self._note_service_time(width, (done - t0) * 1e3)
                if not stream:
                    lat.extend((done - t) * 1e3 for t in submits)
                    for f, row in zip(futs, rows):
                        f.set_result(row)
                if len(lat) > self.stats.max_latency_samples:
                    del lat[: len(lat) - self.stats.max_latency_samples]


# ---------------------------------------------------------------- daemon
def serve_loop(service, in_stream, out_stream, **server_kwargs) -> ServerStats:
    """JSON-lines request/response loop over arbitrary streams.

    One request per line: ``{"source": int, "k"?: int, "eps"?: float,
    "id"?: any}``; response lines carry the request's ``id`` (default: the
    0-based request ordinal) and ``hits`` as ``[node, score, name]``
    triples, or ``error``. ``{"cmd": "stats"}`` reports scheduler counters.
    Responses stream back in completion order (the ``id`` correlates);
    pipelined requests coalesce into device batches via
    :class:`PPRBatchServer`. EOF drains and exits.
    """
    write_lock = threading.Lock()

    def emit(obj):
        with write_lock:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

    def on_done(req_id):
        def cb(fut: Future):
            err = fut.exception()
            if err is not None:
                emit({"id": req_id, "error": f"{type(err).__name__}: {err}"})
            else:
                emit({"id": req_id, "hits": [
                    [h.node, h.score, h.name] for h in fut.result()
                ]})
        return cb

    with PPRBatchServer(service, **server_kwargs) as server:
        pending = []
        for i, line in enumerate(in_stream):
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if req.get("cmd") == "stats":
                    emit({"id": req.get("id", i), "stats": {
                        "requests": server.stats.requests,
                        "dispatches": server.stats.dispatches,
                        "mean_batch": server.stats.mean_batch,
                        "padded_rows": server.stats.padded_rows,
                        "latency_ms": server.stats.latency_percentiles(),
                        "dispatch_cap": server._cap(),
                        "cap_moves": server.stats.cap_moves[-16:],
                        "slo_unattainable": server.stats.slo_unattainable,
                        "prewarmed_widths": server.stats.prewarmed_widths,
                        "widened_dispatches":
                            server.stats.widened_dispatches,
                    }})
                    continue
                fut = server.submit(
                    int(req["source"]), req.get("k"), req.get("eps")
                )
            except Exception as e:  # noqa: BLE001 - malformed request
                emit({"id": i, "error": f"{type(e).__name__}: {e}"})
                continue
            fut.add_done_callback(on_done(req.get("id", i)))
            pending.append(fut)
        for fut in pending:  # drain before close
            try:
                fut.result()
            except Exception:  # noqa: BLE001 - already emitted as error line
                pass
    return server.stats


def main(argv=None) -> int:
    """``python -m ppr_tpu.serving --db <dataset>`` — stdio PPR daemon."""
    import argparse
    import sys

    from .cli import load_dataset
    from .service import PPRService
    from .utils.cache import enable_compilation_cache

    ap = argparse.ArgumentParser(
        prog="ppr_tpu.serving",
        description="PPR top-k retrieval daemon (JSON lines on stdio)",
    )
    ap.add_argument("--db", default="/root/reference/dataset/got")
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--hub-split", type=int, default=None,
                    help="dense-hub hybrid SpMV hub count")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--early-exit", action="store_true",
                    help="annealed-loop top-k set-stability fast exit "
                         "(ids exact; values lower bounds)")
    ap.add_argument("--cohort", action="store_true",
                    help="per-row cohort streaming: a request's future "
                         "resolves when ITS row retires instead of when "
                         "the slowest row in the dispatch finishes")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure backend cost constants at startup")
    ap.add_argument("--max-delay-ms", type=float, default=0.0)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="target worst-case request latency; replaces the "
                         "static --max-batch cap with an adaptive one "
                         "(grows under backlog while latency fits, shrinks "
                         "on breach)")
    ap.add_argument("--prewarm", action="store_true",
                    help="compile + warm-sample every pow2 dispatch width "
                         "up to --max-batch before serving: startup pays "
                         "all XLA compiles once and the SLO policy starts "
                         "with the full width ladder ranked")
    ap.add_argument("--mesh", default=None, metavar="DATAxGRAPH",
                    help="serve from the sharded engine on a DATAxGRAPH "
                         "device mesh (e.g. 4x2)")
    ap.add_argument("--mesh-engine", default="edge",
                    choices=["edge", "node"],
                    help="mesh layout: edge-sharded (throughput) or "
                         "node-sharded O(n/S) ring (memory scaling)")
    ap.add_argument("--frontier-blocks", type=int, default=None,
                    help="node-sharded ring only: circulate just the C "
                         "highest-mass degree-sorted column blocks per "
                         "sweep (frontier compaction; exact)")
    ap.add_argument("--precomputed", default=None, metavar="THRESHOLD[,K]",
                    help="serve from an existing BASE all-pair store "
                         "(pure precomputed reads, no device work)")
    args = ap.parse_args(argv)
    enable_compilation_cache()

    mesh = None
    if args.mesh:
        from .parallel.sharded import make_mesh

        d, g = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(d * g, data=d, graph=g)
    precomputed = None
    if args.precomputed:
        parts = args.precomputed.split(",")
        precomputed = (float(parts[0]),
                       int(parts[1]) if len(parts) > 1 else -1)
    ds = load_dataset(args.db)
    svc = PPRService.from_dataset(ds, alpha=args.alpha, eps=args.eps,
                                  k=args.k, hub_split=args.hub_split,
                                  mesh=mesh, precomputed=precomputed,
                                  early_exit=args.early_exit,
                                  calibrate=args.calibrate,
                                  cohort=args.cohort,
                                  mesh_engine=args.mesh_engine,
                                  frontier_blocks=args.frontier_blocks)
    print(json.dumps({"ready": True, "dataset": ds.name,
                      "n": ds.graph.n, "m": ds.graph.m}),
          file=sys.stderr, flush=True)
    stats = serve_loop(svc, sys.stdin, sys.stdout,
                       max_batch=args.max_batch,
                       max_delay_ms=args.max_delay_ms,
                       slo_ms=args.slo_ms, prewarm=args.prewarm)
    print(json.dumps({"served": stats.requests,
                      "dispatches": stats.dispatches,
                      "mean_batch": round(stats.mean_batch, 2)}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
