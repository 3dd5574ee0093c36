"""Tracing / profiling: per-phase cost table + jax.profiler device traces.

The reference has NO tracing or profiling subsystem — only commented-out
debug prints (reference pg.hpp:433,448-457, ad_intg.hpp:704-710).  The
replacement here (SURVEY.md §5) is two-layered:

1. A host-side **per-phase cost table**: ``phase("name")`` context
   managers accumulate wall time and call counts into a process-global
   registry; ``cost_table()`` / ``format_cost_table()`` snapshot it.
   Phases nest; the table reports both inclusive ("total") and
   exclusive ("self") time so a parent phase's own cost is visible next
   to its children.

2. **Device timeline traces** via ``trace(logdir)``, a wrapper
   around ``jax.profiler.trace`` (view in TensorBoard / Perfetto).
   Every ``phase`` also opens a ``jax.profiler.TraceAnnotation``, so
   host phases appear as named spans on the device timeline whenever a
   trace is active — with no trace active the annotation is a no-op.

Host wall time measures dispatch + host compute; JAX dispatch is async,
so a phase that only *launches* device work looks cheap.  Pass
``sync_result`` (any pytree of arrays) when exiting via
``phase(..., sync=...)``'s functional form, or simply structure phases
around natural host sync points (``float(...)``, ``np.asarray(...)``)
— which is what the solvers here do anyway.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class PhaseStat:
    """Accumulated cost of one named phase."""

    total_s: float = 0.0   # inclusive wall time
    child_s: float = 0.0   # wall time spent in nested phases
    count: int = 0

    @property
    def self_s(self) -> float:
        return max(0.0, self.total_s - self.child_s)


@dataclass
class _Registry:
    stats: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # per-thread stack of (name, child-time accumulator list)
    local: threading.local = field(default_factory=threading.local)


_REG = _Registry()


def reset() -> None:
    """Clear all accumulated phase statistics."""
    with _REG.lock:
        _REG.stats.clear()


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Accumulate wall time under ``name``; nestable; annotates traces.

    ``sync``: optional array/pytree that is ``jax.block_until_ready``-ed
    on exit so the phase charges the device work it launched.
    """
    import jax

    stack = getattr(_REG.local, "stack", None)
    if stack is None:
        stack = _REG.local.stack = []
    stack.append([name, 0.0])
    t0 = time.perf_counter()
    try:
        with jax.profiler.TraceAnnotation(name):
            yield
            if sync is not None:
                jax.block_until_ready(sync)
    finally:
        dt = time.perf_counter() - t0
        _, child = stack.pop()
        if stack:
            stack[-1][1] += dt
        with _REG.lock:
            st = _REG.stats.setdefault(name, PhaseStat())
            st.total_s += dt
            st.child_s += child
            st.count += 1


def cost_table() -> dict:
    """Snapshot ``{name: PhaseStat}`` of everything accumulated so far."""
    with _REG.lock:
        return {
            k: PhaseStat(v.total_s, v.child_s, v.count)
            for k, v in _REG.stats.items()
        }


def format_cost_table(stats: dict | None = None) -> str:
    """Render the cost table, widest total first."""
    stats = cost_table() if stats is None else stats
    if not stats:
        return "(no phases recorded)"
    rows = sorted(stats.items(), key=lambda kv: -kv[1].total_s)
    w = max(5, max(len(k) for k in stats))
    lines = [
        f"{'phase':<{w}}  {'total[s]':>10}  {'self[s]':>10}  "
        f"{'calls':>7}  {'per-call[s]':>11}"
    ]
    for name, st in rows:
        lines.append(
            f"{name:<{w}}  {st.total_s:>10.3f}  {st.self_s:>10.3f}  "
            f"{st.count:>7d}  {st.total_s / max(1, st.count):>11.4f}"
        )
    return "\n".join(lines)


def print_cost_table() -> None:
    print(format_cost_table(), flush=True)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Device timeline trace to ``logdir`` (TensorBoard `profile` plugin).

    ``logdir=None`` is a no-op, so callers can thread an optional CLI
    flag straight through:  ``with profiling.trace(args.profile): ...``.
    """
    if not logdir:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
