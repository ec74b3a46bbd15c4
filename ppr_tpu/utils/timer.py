"""Phase timing + device profiling.

The reference's only tracing is manual ``System.nanoTime()`` bracketing
(Gen_Util.java:148-151; per-phase push/walk timers in
Fora_Whole_Graph.java:89-106 and Fora_Topk.java:181-183; the static
accumulated duration in Backward_Search.java:36,98-99). :class:`PhaseTimer`
generalizes that pattern (named accumulating phases, device-synchronized),
and :func:`trace` wraps ``jax.profiler`` for device traces — the
observability layer the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Accumulating named phase timer; ``sync=True`` blocks on device work."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals_ns: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter_ns()
        yield
        if self.sync and block_on is not None:
            jax.block_until_ready(block_on)
        self.totals_ns[name] += time.perf_counter_ns() - t0
        self.counts[name] += 1

    def ms(self, name: str) -> float:
        return self.totals_ns[name] / 1e6

    def report(self) -> str:
        lines = [
            f"{name}: {self.ms(name):.3f} ms over {self.counts[name]} calls"
            for name in sorted(self.totals_ns)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``jax.profiler`` trace context; no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
