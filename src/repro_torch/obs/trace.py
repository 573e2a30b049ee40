"""positscope spans: nested wall-clock spans serialized as Chrome
``trace_event`` JSON (counterpart of ``repro.obs.trace``).

``span(name, **attrs)`` is a context manager that

* is a **no-op** when no ``obs.scoped()`` collector is open (one test of
  a module-level list, then it yields: nothing timed, nothing allocated);
* times the region with ``time.perf_counter`` on the host clock (work
  queued on a GPU inside the region is timed only as far as the host
  waits for it);
* forwards the region to ``torch.profiler.record_function``, so spans
  show up inside a PyTorch profiler trace when one is being captured;
* on exit appends ONE complete event (``"ph": "X"``, microsecond
  ``ts``/``dur`` relative to each collector's creation) to every open
  collector.  Complete events on the same pid/tid nest by ts/dur
  containment, which is how Perfetto renders a blocked factorization.

Attributes (``span("rgetrf", n=256, nb=64)``) land in the event's
``args`` with the nesting depth and the dotted path, as in the reference.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from repro_torch.obs import metrics as _metrics

# Host-side span stack (names only) — gives events their dotted path.
_SPAN_STACK: list[str] = []


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a region under ``name`` into every open collector."""
    if not _metrics._STACK:
        yield
        return
    _SPAN_STACK.append(name)
    path = ".".join(_SPAN_STACK)
    depth = len(_SPAN_STACK)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        t1 = time.perf_counter()
        _SPAN_STACK.pop()
        args = {k: _jsonable(v) for k, v in attrs.items()}
        args["path"] = path
        args["depth"] = depth
        for c in _metrics._STACK:
            c.events.append({
                "name": name, "cat": "positscope", "ph": "X",
                "ts": (t0 - c.t0) * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": os.getpid(), "tid": 0, "args": dict(args),
            })
