"""Observability: per-stage timers and throughput counters.

The reference's only instrumentation is ad-hoc ``time.time()`` deltas
printed per stage (`monica/genomes/fetcher.py:140,251,294`,
`test/test.py:23-46`).  Here stages report through one registry that
prints the same style of line but also keeps machine-readable totals
(reads/s, bases/s, Mcells/s), and can wrap a run in a jax profiler
trace for device timeline inspection.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field


@dataclass
class StageStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0  # stage-defined unit (reads, bases, cells, files)


@dataclass
class Metrics:
    stages: dict[str, StageStat] = field(default_factory=dict)
    verbose: bool = True
    # the streaming runtime updates stages from worker threads
    # (run_once's cross-sample pipeline); per-sample stage names are
    # unique, but shared counters like "bases" need the lock
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                st = self.stages.setdefault(name, StageStat())
                st.seconds += dt
                st.calls += 1
                st.items += items
            if self.verbose:
                rate = f", {items / dt:,.0f}/s" if items and dt > 0 else ""
                print(f"[monica_tpu] {name}: {dt:.3f}s{rate}")

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        with self._lock:
            st = self.stages.setdefault(name, StageStat())
            st.seconds += seconds
            st.calls += 1
            st.items += items

    def rate(self, name: str) -> float:
        st = self.stages.get(name)
        return st.items / st.seconds if st and st.seconds > 0 else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(st.seconds, 4),
                "calls": st.calls,
                "items": st.items,
                "per_s": round(st.items / st.seconds, 2) if st.seconds > 0 else None,
            }
            for name, st in self.stages.items()
        }

    def dump(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Wrap a block in a jax profiler trace (TensorBoard-compatible);
    no-op when logdir is None."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
