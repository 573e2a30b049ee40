"""Spans around the program's calls, and the reading of a device trace.

``Spans`` is a copy of ``chip_smoke.py``'s ``StageTimer``: it swaps the
module attributes that the program's drivers call for wrappers, and
restores them on exit.  In the span phase of a traced run each wrapper
synchronises the device on both sides of the call, so the host clock's
time lands on the span whose work it was.  In the profiled unit it
synchronises nothing and opens a ``record_function`` range named
``bench.<span>`` instead, which ``Trace`` reads.  Each wrapper also
keeps the GEMM shape (batch, M, K, N) of calls that take two matrices.

A target is ``"module:attribute"``.  A target the program no longer has
is skipped, and the metric that reads its span then reads nothing.
"""
from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict

import numpy as np
import torch


def gemm_shape(args, kwargs):
    """(batch, M, K, N) of ``f(A, B, ...)`` with ``trans_a``/``trans_b``
    keywords, or None when the first two arguments are not matrices."""
    if len(args) < 2 or not all(isinstance(t, torch.Tensor) and t.dim() >= 2
                                for t in args[:2]):
        return None
    a, b = args[:2]
    m, k = a.shape[-2:][::-1] if kwargs.get("trans_a") else a.shape[-2:]
    n = b.shape[-2] if kwargs.get("trans_b") else b.shape[-1]
    batch = a.shape[0] if a.dim() == 3 else 1
    return int(batch), int(m), int(k), int(n)


class Spans:
    """``sync``: the function that waits for the device (the span phase),
    or None for ranges without waiting (the profiled unit)."""

    def __init__(self, targets: dict[str, list[str]], sync):
        self.targets = targets
        self.sync = sync
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.shapes: dict[str, list] = defaultdict(list)
        self.saved: list = []

    def _wrap(self, span, fn):
        def wrapped(*args, **kwargs):
            shape = gemm_shape(args, kwargs)
            if shape is not None:
                self.shapes[span].append(shape)
            self.calls[span] += 1
            if self.sync is None:
                with torch.profiler.record_function(f"bench.{span}"):
                    return fn(*args, **kwargs)
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[span] += time.perf_counter() - t0
            return out
        return wrapped

    def __enter__(self):
        for span, names in self.targets.items():
            for target in names:
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr, None)
                if fn is None:
                    continue
                self.saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(span, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved.clear()
        return False


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends), sorted by start."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    first = np.flatnonzero(np.r_[True, s[1:] > run_end[:-1]])
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], run_end[last]


class Trace:
    """What one profiled unit's device trace says, in seconds.

    ``dev``: the device operations (name, start, end, correlation id) in
    the profiler's clock (ns); ``ranges``: the ``bench.*`` host ranges
    (span, start, end); ``t0``/``t1``: the ``bench.unit`` range, whose
    length is ``window_s``.  A device operation belongs to the range in
    which the host launched it (matched by correlation id)."""

    def __init__(self, prof, shapes: dict[str, list]):
        self.shapes = shapes
        dev, ranges, launches = [], [], {}
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith("bench."):
                    continue
                dev.append((name, e.start_ns(), e.end_ns(),
                            e.correlation_id()))
            elif name.startswith("bench."):
                ranges.append((name[len("bench."):], e.start_ns(),
                               e.end_ns()))
            elif "Launch" in name or name.startswith("cudaMem"):
                launches[e.correlation_id()] = e.start_ns()
        unit = [r for r in ranges if r[0] == "unit"]
        if not unit or not dev:
            raise RuntimeError("the profiler recorded no device activity")
        self.t0, self.t1 = unit[0][1], unit[0][2]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.dev = [d for d in dev if d[2] > self.t0 and d[1] < self.t1]
        starts = np.array([max(d[1], self.t0) for d in self.dev], np.int64)
        ends = np.array([min(d[2], self.t1) for d in self.dev], np.int64)
        self.busy_starts, self.busy_ends = _union(starts, ends)
        self.busy_s = float((self.busy_ends - self.busy_starts).sum()) * 1e-9
        self.ranges = sorted((r for r in ranges if r[0] != "unit"),
                             key=lambda r: r[1])
        self.launches = launches

    def range_device_s(self, span: str) -> float:
        """Device seconds of the operations launched inside span's ranges."""
        iv = [(s, e) for n, s, e in self.ranges if n == span]
        if not iv:
            return 0.0
        starts = [s for s, _ in iv]
        total = 0
        for _, s, e, cid in self.dev:
            t = self.launches.get(cid)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][1] >= t:
                total += e - s
        return total * 1e-9

    def kernel_s(self, names) -> float:
        """Device seconds of operations whose name contains one of
        ``names``."""
        return sum(e - s for n, s, e, _ in self.dev
                   if any(k in n for k in names)) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the span the host was in (``other`` outside any)."""
        by_op: dict[str, int] = defaultdict(int)
        for n, s, e, _ in self.dev:
            by_op[_short(n)] += e - s
        gaps: dict[str, int] = defaultdict(int)
        edges = np.concatenate(([self.t0], self.busy_ends))
        nxt = np.concatenate((self.busy_starts, [self.t1]))
        spans = [(s, e, n) for n, s, e in self.ranges]
        starts = [s for s, _, _ in spans]
        for g0, g1 in zip(edges.tolist(), nxt.tolist()):
            if g1 <= g0:
                continue
            i = bisect.bisect_right(starts, g0) - 1
            label = spans[i][2] if i >= 0 and spans[i][1] >= g0 else "other"
            gaps[label] += g1 - g0
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(gaps, top)}


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _top(d: dict, top: int) -> list:
    return [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:top]]
