"""The port's benchmark: one run of one cell on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run is one process:

1. set-up, timed as ``setup_s``: import the program (``src/repro_torch``),
   load its kernel library (built with nvcc into
   ``src/repro_torch/kernels/_build/`` on the first run in a checkout),
   make the cell's input words on the card from the seed, and warm up
   with one unit of the cell's own shapes;
2. the window: whole units back to back, one in flight, until one ends
   past ``--seconds``; every rate is all the window's work over its whole
   time.  With ``--trace 1`` the window's units run with a span around
   each of the program's layers (a sync on both sides), and one more unit
   runs under ``torch.profiler``;
3. the comparison with the plain reference (``reference/``), once the
   window has closed and the peak memory has been read;
4. the result: the numbers compared beside their limits as the last
   lines of standard error, and one JSON line as the last line of
   standard output.

The cell's configuration, traffic mix and limits are data files found by
name from ``BENCHMARK.json``; the unit of work is ``units/<unit>.py``,
named by the traffic mix; each metric, end-to-end or per-layer, is a
reader of its own in ``metrics/<name>.py``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_metric(name: str):
    """``metrics/<name>.py``, loaded by path.  A quantity split by kind
    of cell, ``<name>.<kind>`` (each with its own bound, or moving its
    own end-to-end metric), is read by ``metrics/<name>.py`` where it
    has no file of its own."""
    import workload as wl
    own = wl.BENCH / "metrics" / f"{name}.py"
    return wl.load_module("metrics", name if own.is_file()
                          else name.split(".")[0])


def cell_metrics(spec: dict, workload: dict, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind="end_to_end"``) or per-layer
    metrics: those that list it, or that list no cells and move a
    metric the cell reports."""
    name = workload["name"]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if name in m.get("workloads", [name])
            and m["moves"] in reported]


class Context:
    """What a metric's reader reads: the set-up time, the window's units,
    its length and the median unit's host-clock time, the unit object
    (``unit.flops``, and whatever a unit keeps for its own metrics); in a
    traced run also the spans, the program's counters and the profiled
    unit's trace."""

    def __init__(self, setup_s, unit, unit_times, window_s, spans=None,
                 launches=None, trace=None):
        self.setup_s, self.unit, self.window_s = setup_s, unit, window_s
        self.units = len(unit_times)
        self.unit_s = statistics.median(unit_times) if unit_times else None
        self.spans, self.trace = spans, trace
        self.launches = launches or {}
        self.flops = unit.flops

    def span_ms(self, span: str):
        if not self.units or not self.spans.calls.get(span):
            return None
        return 1e3 * self.spans.seconds[span] / self.units


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run(args, device: str = "cuda", cell: dict | None = None
        ) -> tuple[dict, list[str]]:
    """One run; returns (result, check lines).  A ``device`` other than
    ``cuda`` and a ``cell`` given as data (``workload.load_cell``'s
    form) are for the CPU tests."""
    t_setup = time.perf_counter()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import workload as wl

    cell = cell or wl.load_cell(args.workload)
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    chips = cell["workload"]["chips"]
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"needs {chips} CUDA device(s); found "
                             f"{torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(1)        # one host thread: steadier launches
    posit_gemm = importlib.import_module("repro_torch.kernels.posit_gemm")
    if device == "cuda":
        posit_gemm._build.lib()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    unit = wl.make_unit(cfg, traffic, args.seed, device)
    unit.warm(sync)
    setup_s = time.perf_counter() - t_setup

    kind = "per_layer" if args.trace else "end_to_end"
    metrics_of = cell_metrics(cell["spec"], cell["workload"], kind)
    readers = {m["name"]: load_metric(m["name"]) for m in metrics_of}
    targets: dict[str, list[str]] = {}
    for r in readers.values():
        for span, names in getattr(r, "SPANS", {}).items():
            targets.setdefault(span, [])
            targets[span] += [t for t in names if t not in targets[span]]

    spans_mod = importlib.import_module("spans")
    recorder = spans_mod.Spans(targets, sync=sync)
    before = posit_gemm.launch_counts()
    with recorder if args.trace else contextlib.nullcontext():
        ends = unit.window(args.seconds, sync)
    units, window_s = len(ends), ends[-1]
    after = posit_gemm.launch_counts()
    launches = {k: after[k] - before[k] for k in after}

    trace = None
    if args.trace and device == "cuda":
        trace = _profile_unit(torch, spans_mod, unit, targets)

    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu",
                "count": chips if device == "cuda" else 0,
                "memory_peak_bytes": torch.cuda.max_memory_allocated()
                if device == "cuda" else 0}
    if trace is not None:
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.window_s
    if device == "cuda":
        dev_info["power_limit"] = power_limit()

    t_check = time.perf_counter()
    numbers, failed, info = unit.check(limits)
    info["check_s"] = time.perf_counter() - t_check
    info["unit_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
    correct = all(numbers[k] <= limits[k] for k in numbers)

    metrics = {}
    ctx = Context(setup_s, unit, info["unit_s"], window_s, recorder,
                  launches, trace)
    for m in metrics_of:
        value = readers[m["name"]].read(ctx)
        if value is None and not args.trace:
            raise ValueError(f"the end-to-end metric {m['name']!r} read "
                             "nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ran = units + (trace is not None)
    result = {"correct": bool(correct),
              "attempted": ran * unit.answers, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["info"] = dict(info, units=units, window_s=window_s,
                          seed=args.seed)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r}) "
             f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
             for k, v in result["checks"].items()]
    return result, lines


def _profile_unit(torch, spans_mod, unit, targets):
    """One more unit under ``torch.profiler``, with a range around each
    span and around the unit; its device trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    ranges = spans_mod.Spans(targets, sync=None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with ranges, record_function("bench.unit"):
            unit.keep(unit.run())
            torch.cuda.synchronize()
    return spans_mod.Trace(prof, ranges.shapes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    result, lines = run(args)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
