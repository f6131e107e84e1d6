"""Tracing and per-phase timing utilities.

The reference's observability is a perf scratchpad plus ad-hoc wall-clock
prints (SURVEY.md §5.1: noodle.cpp, gp_instance.cpp:140-174 timing report,
vip benchmark gradient_time). The equivalents here:

  * ``device_trace``: wraps ``jax.profiler.trace`` so a block's XLA execution
    can be inspected in TensorBoard/XProf (kernel timeline, memory traffic);
  * ``annotate``: named TraceAnnotation spans that show up inside the
    device trace;
  * ``PhaseTimer``: accumulates host wall time per named phase with an
    optional device sync (``block_until_ready``) so async dispatch doesn't
    misattribute time to the next phase.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile a block with the JAX/XLA profiler; view with TensorBoard."""
    with jax.profiler.trace(logdir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a device trace (jax.profiler.TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class PhaseTimer:
    """Accumulate wall time per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("populate"):
    ...     pass
    >>> _ = timer.total("populate")
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        """Time a block; if ``sync``, block on ``result`` (or a final
        ``jax.block_until_ready`` of it) before stopping the clock."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                jax.block_until_ready(result)
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its output, and record the elapsed time."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - start
        self.totals[name] = self.totals.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def mean(self, name: str) -> Optional[float]:
        if not self.counts.get(name):
            return None
        return self.totals[name] / self.counts[name]

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}: total {self.totals[name] * 1e3:.2f} ms over "
                f"{self.counts[name]} calls "
                f"({self.mean(name) * 1e3:.3f} ms/call)"
            )
        return "\n".join(lines)
