"""positscope metrics: a process-local registry of counters, gauges and
fixed-log2-bucket histograms behind a context-manager collector
(counterpart of ``repro.obs.metrics``, which imports no jax; the port keeps
its own copy so that its ``_STACK`` is the port's switch, apart from the
reference's).

Observability is OFF unless a ``scoped()`` collector is open, and every
recording entry point is a Python-level no-op in that state — ``if not
_STACK: return`` before any other work.  The instrumented library code
tests ``enabled()`` before it calls anything of ``obs.numerics``, so with
no collector open the hooked entry points run exactly the code they run
without the hooks.

Instruments:

* ``inc(name, v)``        — monotonic counters (events, bytes, sweeps)
* ``gauge(name, v)``      — last-value gauges (occupancy fractions, norms)
* ``observe(name, v)``    — histogram of floor(log2(|v|)) with a
                            dedicated zero bucket; fixed bucketing means
                            histograms merge exactly across scopes
* ``observe_hist(name, {bucket: count})`` — merge a precomputed integer
                            histogram (the numerics collectors hand their
                            bincounts over in one call)
* ``record(name, **row)`` — append a row to a named time series (per
                            block-step / per IR-sweep telemetry)

Collectors nest: every instrument records into ALL open scopes, so an
outer benchmark scope sees the totals of inner instrumented regions.
``Collector.to_json()`` serializes everything; ``save_chrome_trace()``
writes the span events (obs/trace.py) as Chrome ``trace_event`` JSON
loadable in Perfetto / chrome://tracing.
"""
from __future__ import annotations

import contextlib
import json
import math
import time

# The open-collector stack.  Module-level and deliberately not
# thread-local: the stack is the single enabled/disabled switch and the
# repo's drivers are single-threaded host loops.
_STACK: list["Collector"] = []

# Histogram bucket index reserved for exact zeros (log2 undefined).
ZERO_BUCKET = -(1 << 30)


def enabled() -> bool:
    """True iff at least one ``scoped()`` collector is open."""
    return bool(_STACK)


def log2_bucket(value) -> int:
    """floor(log2(|value|)), with 0 / NaN mapped to the zero bucket."""
    v = abs(float(value))
    if v == 0.0 or math.isnan(v) or math.isinf(v):
        return ZERO_BUCKET
    return int(math.floor(math.log2(v)))


class Collector:
    """One observation scope: plain-Python dicts, merged-on-record."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, dict[int, int]] = {}
        self.series: dict[str, list[dict]] = {}
        self.events: list[dict] = []          # chrome trace_event dicts
        self.t0 = time.perf_counter()         # trace timebase (µs origin)

    # -- export ------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: {str(b): c for b, c in sorted(v.items())}
                      for k, v in self.hists.items()},
            "series": {k: list(v) for k, v in self.series.items()},
            "spans": len(self.events),
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def bench_block(self) -> dict:
        """Compact block for BENCH_*.json rows: counters + gauges only
        (histograms/series are too bulky for per-row trajectory data)."""
        return {"counters": {k: round(v, 6) for k, v in
                             sorted(self.counters.items())},
                "gauges": {k: round(v, 6) for k, v in
                           sorted(self.gauges.items())}}

    def chrome_trace(self) -> dict:
        """Chrome trace_event JSON object (Perfetto's legacy JSON format):
        complete ("ph": "X") events with µs timestamps/durations."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


@contextlib.contextmanager
def scoped(collector: "Collector | None" = None):
    """Open a collector scope::

        with obs.scoped() as m:
            rgesv_ir(a_p, b_p)
        print(m.to_json())

    Everything instrumented underneath records into ``m`` (and into any
    enclosing scopes).  On exit the stack entry is removed; the collector
    object stays alive for export.  Pass an existing ``Collector`` to
    keep accumulating into it across several scopes (one trace timeline
    over many solves — its ``t0`` timebase is preserved)."""
    c = Collector() if collector is None else collector
    _STACK.append(c)
    try:
        yield c
    finally:
        _STACK.remove(c)


# --------------------------------------------------------------------------
# recording entry points — every one is a no-op when no scope is open
# --------------------------------------------------------------------------

def inc(name: str, value=1) -> None:
    if not _STACK:
        return
    v = float(value)
    for c in _STACK:
        c.counters[name] = c.counters.get(name, 0.0) + v


def gauge(name: str, value) -> None:
    if not _STACK:
        return
    v = float(value)
    for c in _STACK:
        c.gauges[name] = v


def observe(name: str, value) -> None:
    if not _STACK:
        return
    b = log2_bucket(value)
    for c in _STACK:
        h = c.hists.setdefault(name, {})
        h[b] = h.get(b, 0) + 1


def observe_hist(name: str, buckets: dict) -> None:
    """Merge ``{bucket_index: count}`` into histogram ``name`` (fixed
    bucketing makes the merge a plain integer add)."""
    if not _STACK:
        return
    items = [(int(b), int(v)) for b, v in buckets.items() if int(v)]
    for c in _STACK:
        h = c.hists.setdefault(name, {})
        for b, v in items:
            h[b] = h.get(b, 0) + v


def record(name: str, **row) -> None:
    """Append one row to series ``name``; values are coerced to plain
    Python scalars so the series is JSON-clean (this is the point where
    telemetry tensors leave device memory — only ever on the enabled
    path)."""
    if not _STACK:
        return
    clean = {}
    for k, v in row.items():
        if isinstance(v, (str, bool, int)):
            clean[k] = v
        else:
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                clean[k] = str(v)
    for c in _STACK:
        c.series.setdefault(name, []).append(clean)
